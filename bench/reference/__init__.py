"""The plain reference of the benchmark: float32 forwards of the served
configurations in plain PyTorch, and a frozen copy of the roundings that
the lower-precision controls use.  It imports nothing of the port, so it
judges the port's outputs without sharing its code."""
