"""Percent of the traced window in which the device ran nothing, from a
complete trace."""
from cardbench.readers import device_idle


def read(run):
    return device_idle(run)
