"""Percent of the roofline in the BLESS ladder's Eq. 3 scoring calls."""
from portbench import readers


def read(view):
    return readers.roofline(view, "pb.rls_scores")
