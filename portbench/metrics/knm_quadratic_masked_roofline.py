"""Percent of the roofline in the row-masked CG applications of a k-fold sweep."""
from portbench import readers


def read(view):
    return readers.roofline(view, "pb.knm_quadratic_masked")
