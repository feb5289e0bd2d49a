"""Numerics of the port: the matmul entry point."""
