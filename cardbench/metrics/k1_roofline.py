"""Percent of the memory roofline that K1 (``row_shift_window_slab``) calls
reach over the traced window."""
from cardbench.readers import roofline


def read(run):
    return roofline(run, 'k1')
