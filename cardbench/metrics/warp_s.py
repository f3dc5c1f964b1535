"""Seconds a step in the geometric warp, host planning in: the harness's
span around planning and the warp call, closed by a synchronize."""
from cardbench.readers import span_mean


def read(run):
    return span_mean(run, 'warp')
