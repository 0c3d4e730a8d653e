"""Percent of a traced sample window in which the device ran no operation."""
from portbench import readers


def read(view):
    return readers.device_idle(view, "sample")
