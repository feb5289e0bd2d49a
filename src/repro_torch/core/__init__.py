"""The port's dither core: the hash and pulse math with the rounding
schemes, k-bit quantisers and the paper's quantised matmul variants."""
