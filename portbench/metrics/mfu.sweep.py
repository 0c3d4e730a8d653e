"""Percent of the chip's peaks that the counted work of the sweep jobs would need
over their seconds (the jobs run untraced after the profiler stopped)."""
from portbench import readers


def read(view):
    return readers.mfu(view, "sweep")
