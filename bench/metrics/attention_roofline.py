"""Attention kernels: the least time to read each decode step's keys and
values at its position (``roofline/attention.py``) over the device time
of the kernels mapped to that work, in %."""


def read(run):
    return run.roofline("attention")
