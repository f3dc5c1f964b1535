"""What the per-layer metric readers share.  A reader that finds nothing
to read returns None, and the harness leaves its metric out."""
from typing import Optional

from .roofline import share_percent


def span_mean(run, name: str) -> Optional[float]:
    """Mean seconds of the spans named ``name`` that ran inside the part
    of the window without the profiler; None where none did."""
    begin, end = run.span_half()
    times = [stop - start for n, start, stop, _ in run.spans
             if n == name and start >= begin and stop <= end]
    return sum(times) / len(times) if times else None


def complete_trace(run) -> Optional[dict]:
    """The window's trace reading where the trace is complete, else
    None."""
    reading = run.trace_reading
    if reading is None or reading['missing']:
        return None
    return reading


def roofline(run, kernel: str) -> Optional[float]:
    """Percent of the published memory rate that the calls of ``kernel``
    reached: their bytes' least time over the device time of every
    operation they enqueued."""
    reading = complete_trace(run)
    if reading is None:
        return None
    seconds = reading['kernel_us'].get(kernel, 0.0) * 1e-6
    nbytes = reading['kernel_bytes'].get(kernel, 0.0)
    if seconds <= 0 or nbytes <= 0:
        return None
    return share_percent(nbytes, seconds)


def device_idle(run) -> Optional[float]:
    """Percent of the window (two CUDA events) in which no operation ran
    on the device."""
    reading = complete_trace(run)
    if reading is None:
        return None
    return 100.0 * (1.0 - reading['busy_us'] / reading['window_us'])
