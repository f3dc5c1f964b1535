"""Percent of the memory roofline that K3 (``banded_line_resample``) calls
reach over the traced window."""
from cardbench.readers import roofline


def read(run):
    return roofline(run, 'k3')
