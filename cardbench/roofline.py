"""The yardstick of a kernel's roofline share: the bytes its public
function's call needs, from the call's arguments, over the card's
published memory rate.

``window_read_floats``, ``window_work`` and ``banded_work`` are copies of
the functions of the same names in ``chip_smoke.py`` at commit 413b729
(each input byte read once, each output byte written once), changed only
to return the byte count as a device tensor, so that a traced run sums it
after the window instead of waiting for the device at every call.

``KernelCalls`` wraps a public kernel function of the port wherever a
module of the port holds it, and brackets each call with spin kernels, so
that the trace reader can give the call every device operation it
enqueued, whatever implements the function.
"""
import sys
from typing import Callable, Dict, List, NamedTuple, Tuple

# NVIDIA's data sheet of the H100 SXM: device memory bytes per second.
PEAK_BYTES_PER_S = 3.35e12
# The kernels' contract (K1 and K3, the TPU kernels' own): rows are rolled
# inside a window of 2048 lanes; K3 places each source row at lane 512.
WINDOW = 2048
ROW_OFFSET = 512


def window_read_floats(starts, width: int, out_width: int):
    """Source floats per channel that K1 must read: each row's window of
    2048 lanes, starting at lane starts mod 2048, overlaps the row in one
    interval [lo, hi)."""
    import torch

    a = starts.to(torch.int64) & (WINDOW - 1)
    inside = a < width
    lo = torch.where(inside, a, 0)
    hi = torch.where(inside, (a + out_width).clamp(max=width),
                     (a + out_width - WINDOW).clamp(0, width))
    return (hi - lo).clamp(min=0).sum()


def window_work(x, starts, out_width: int, border_value: float = 0.0):
    """Bytes of one K1 call (``row_shift_window_slab``): the source floats
    the windows overlap, the starts and the output, each once."""
    channels = x.shape[2] if x.dim() == 4 else 1
    rows = starts.numel()
    floats = (channels * window_read_floats(starts, x.shape[-1], out_width)
              + rows + rows * channels * out_width)
    return 4.0 * floats


def banded_work(x, base, pos, taps: int, border_value: float = 0.0):
    """Bytes of one K3 call (``banded_line_resample``): the source floats
    that carry weight in some output (the two taps floor(u), floor(u) + 1
    inside [0, taps) and inside the row), base, pos and the output, each
    once."""
    import torch

    n, lines, channels, width = x.shape
    jp = pos.shape[-1]
    j = torch.arange(jp, device=x.device)
    b = base.repeat_interleave(8, dim=1)[:, :lines].repeat_interleave(
        128, dim=2).to(torch.int64)
    u = pos - (b.to(torch.float32) + (j % 128).to(torch.float32))
    t0f = torch.floor(u)
    t0 = t0f.to(torch.int64)
    needed = torch.zeros((n * lines, width + 1), dtype=torch.uint8,
                         device=x.device)
    for t, tap in ((t0, t0f), (t0 + 1, t0f + 1.0)):
        live = (t >= 0) & (t < taps) & ((u - tap).abs() < 1.0)
        col = (torch.remainder(b + j % 128 + t + ROW_OFFSET, WINDOW)
               - ROW_OFFSET)
        ok = live & (col >= 0) & (col < width)
        idx = torch.where(ok, col, width).reshape(n * lines, jp)
        needed.scatter_(1, idx, 1)
    reads = needed[:, :width].sum()
    floats = (channels * reads + base.numel() + pos.numel()
              + n * lines * channels * jp)
    return 4.0 * floats


# Kernel name in metric names -> (the port's public function, its bytes).
KERNELS: Dict[str, Tuple[str, Callable]] = {
    'k1': ('row_shift_window_slab', window_work),
    'k3': ('banded_line_resample', banded_work),
}


class Call(NamedTuple):
    kernel: str      # 'k1', 'k3'
    nbytes: object   # 0-dim device tensor


def spin():
    """One marker kernel of next to no length."""
    import torch

    torch.cuda._sleep(1)


class KernelCalls:
    """While installed, every call of the wrapped kernel functions runs
    between two marker kernels, and a third follows the launches that
    count its bytes: the trace reader pairs each triple with ``calls``."""

    def __init__(self, kernels):
        self.kernels = list(kernels)
        self.calls: List[Call] = []
        self._undo = []

    def install(self):
        from vkit_tpu_torch.ops import kernels as K

        for kernel in self.kernels:
            name, work = KERNELS[kernel]
            original = getattr(K, name)

            def wrapped(*args, _fn=original, _kernel=kernel, _work=work,
                        **kwargs):
                spin()
                out = _fn(*args, **kwargs)
                spin()
                self.calls.append(Call(_kernel, _work(*args, **kwargs)))
                spin()
                return out

            for module in list(sys.modules.values()):
                if not getattr(module, '__name__', '').startswith(
                        'vkit_tpu_torch'):
                    continue
                for attr, value in list(vars(module).items()):
                    if value is original:
                        setattr(module, attr, wrapped)
                        self._undo.append((module, attr, original))
        return self

    def uninstall(self):
        for module, attr, original in reversed(self._undo):
            setattr(module, attr, original)
        self._undo.clear()

    def totals(self) -> Dict[str, float]:
        """Bytes of all calls, by kernel (waits for the device)."""
        out: Dict[str, float] = {}
        for call in self.calls:
            out[call.kernel] = out.get(call.kernel, 0.0) + float(call.nbytes)
        return out


def share_percent(nbytes: float, device_seconds: float) -> float:
    """The bytes' least time at the published rate over the device time,
    in percent."""
    return 100.0 * (nbytes / PEAK_BYTES_PER_S) / device_seconds
