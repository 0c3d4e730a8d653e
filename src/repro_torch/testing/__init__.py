"""Test and chaos harnesses that ship with the package (see ``faults``)."""
from . import faults

__all__ = ["faults"]
