"""Host seconds of a traced fit's solver part (fit on the sampled centers,
predict, synchronize), per job."""
from portbench import readers


def read(view):
    return readers.span_mean(view, "fit", "solver")
