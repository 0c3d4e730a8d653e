"""Percent of the roofline in the CG applications K_nM^T (K_nM v) of a fit."""
from portbench import readers


def read(view):
    return readers.roofline(view, "pb.knm_quadratic")
