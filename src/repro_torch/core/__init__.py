"""The dither hash and pulse math of the port."""
