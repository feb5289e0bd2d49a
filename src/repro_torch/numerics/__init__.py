"""Numerics of the port: the quantisation policy and the matmul entry
point of every model layer."""
