"""Dither kernels: the least time of the slice's dither products
(``roofline/dither_matmul.py``) over the device time of the kernels
mapped to that work, in %."""


def read(run):
    return run.roofline("dither_matmul")
