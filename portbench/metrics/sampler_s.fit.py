"""Host seconds of a traced fit's sampler part (sample, synchronize), per job."""
from portbench import readers


def read(view):
    return readers.span_mean(view, "fit", "sampler")
