"""The port's dither core: the hash and pulse math with the rounding
schemes, k-bit quantisers, the paper's quantised matmul variants, and its
pulse-stream representations, arithmetic and closed forms (§II–IV)."""
