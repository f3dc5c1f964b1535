"""The device trace of a run's window and what is read from it.

``read_trace`` follows ``read_trace`` of ``chip_smoke.py`` at commit
413b729: the device's busy time is the union of its kernel, copy and set
intervals, and a trace is complete only when every runtime call that put
work on the device has a device record of its correlation id and the busy
time fits inside the window that two CUDA events measured.  That check has
a known hole: a trace that lost whole launches' records, calls and device
records alike, still passes it (PERF.md, section 7).

Beyond the copy: marker kernels (``torch.cuda._sleep``) open the session
and bracket each wrapped kernel call (``roofline.KernelCalls``); they and
the launches that count a call's bytes are left out of the busy time.
"""
import bisect
import json
import re
from pathlib import Path
from typing import Dict, List, Optional

from .stats import busy_and_gaps

# Chrome-trace categories of work on the device.
DEVICE_CATEGORIES = frozenset({'kernel', 'gpu_memcpy', 'gpu_memset'})
# CUDA API calls that put work on the device: in a complete trace each has
# a device record of its correlation id.
DEVICE_WORK_CALL = re.compile(
    r'^cu(da)?(LaunchKernel|LaunchCooperativeKernel|Memcpy|Memset)')
# Marker kernels that open every traced session: the profiler on the card
# has been seen to lose a session's first 18 device records.
WARMUP_SPINS = 64
SPIN = 'spin_kernel'


def short_kernel_name(name: str) -> str:
    """A device operation's name without its template arguments: the
    kernel, and the functor it runs where the kernel is a generic one."""
    words = re.findall(r'[A-Za-z_]\w*', name.replace('void ', '', 1))
    kernels = [w for w in words if 'kernel' in w or w.endswith('_impl')]
    if not kernels:
        return name[:60]
    inner = next((w for w in kernels[1:] if w != kernels[0]
                  and not w.startswith('gpu_kernel')), None)
    return kernels[0] + (f'[{inner}]' if inner else '')


def _correlation(event) -> Optional[int]:
    return event.get('args', {}).get('correlation')


def read_trace(path, calls, window_us: float) -> Dict:
    """Read the Chrome trace at ``path``.

    ``calls``: the wrapped kernel calls in order (``KernelCalls.calls``),
    each bracketed by three marker kernels.  Returns busy_us, the idle
    gaps (begin_us, end_us) on the trace's clock, device time by operation
    name, device seconds and bytes by kernel, the trace's clock at the
    last opening marker's launch (``anchor_us``), and ``missing``: what
    makes the trace incomplete (empty when it is complete)."""
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get('traceEvents', [])
    events = [e for e in events if e.get('ph') == 'X' and 'ts' in e]
    launches = sorted(
        (e for e in events if e.get('cat') in ('cuda_runtime', 'cuda_driver')
         and DEVICE_WORK_CALL.match(e.get('name', ''))),
        key=lambda e: _correlation(e) or 0)
    on_device = [e for e in events if e.get('cat') in DEVICE_CATEGORIES]
    del events
    missing: Dict[str, object] = {}
    recorded = {_correlation(e) for e in on_device}
    for e in launches[WARMUP_SPINS:]:
        if _correlation(e) not in recorded:
            missing[e['name']] = missing.get(e['name'], 0) + 1
    spins = sorted((e for e in on_device if SPIN in e.get('name', '')),
                   key=_correlation)
    spin_ids = [_correlation(e) for e in spins]
    if len(spin_ids) != WARMUP_SPINS + 3 * len(calls):
        missing['marker kernels (expected, seen)'] = (
            WARMUP_SPINS + 3 * len(calls), len(spin_ids))
    anchor_us = (float(launches[WARMUP_SPINS - 1]['ts'])
                 if len(launches) >= WARMUP_SPINS else None)
    first = spin_ids[WARMUP_SPINS - 1] if len(spin_ids) >= WARMUP_SPINS \
        else None
    # Correlation ranges: (begin, end) of each call, (end, after) of the
    # launches that count its bytes.
    triples = [spin_ids[WARMUP_SPINS + 3 * i:WARMUP_SPINS + 3 * i + 3]
               for i in range(len(calls))]
    counting = sorted((t[1], t[2]) for t in triples if len(t) == 3)
    counting_lo = [lo for lo, _ in counting]

    def in_counting(cid):
        i = bisect.bisect_left(counting_lo, cid) - 1
        return i >= 0 and counting[i][0] < cid < counting[i][1]

    work = sorted((e for e in on_device
                   if first is not None and _correlation(e) > first
                   and SPIN not in e.get('name', '')
                   and not in_counting(_correlation(e))),
                  key=_correlation)
    work_ids = [_correlation(e) for e in work]
    intervals = [(float(e['ts']), float(e['ts']) + float(e.get('dur', 0)))
                 for e in work]
    busy_us, gaps = busy_and_gaps(intervals)
    if busy_us > window_us:
        missing["busy beyond the events' window"] = (busy_us, window_us)
    if not work:
        missing['any device operation'] = 0
    per_op: Dict[str, float] = {}
    for e in work:
        name = short_kernel_name(e['name'])
        per_op[name] = per_op.get(name, 0.0) + float(e.get('dur', 0))
    kernel_us: Dict[str, float] = {}
    for call, t in zip(calls, triples):
        if len(t) != 3:
            continue
        lo = bisect.bisect_right(work_ids, t[0])
        hi = bisect.bisect_left(work_ids, t[1])
        us = sum(float(e.get('dur', 0)) for e in work[lo:hi])
        kernel_us[call.kernel] = kernel_us.get(call.kernel, 0.0) + us
    return {
        'busy_us': busy_us,
        'gaps': gaps,
        'ops_us': per_op,
        'kernel_us': kernel_us,
        'anchor_us': anchor_us,
        'missing': missing,
        'trace_bytes': Path(path).stat().st_size,
    }


def name_gaps(gaps, spans, anchor_us: float, anchor_host: float,
              top: int = 10) -> List[List]:
    """The ``top`` longest idle gaps, each named by the innermost host span
    that covers its middle (spans: (name, begin, end) in host seconds;
    ``anchor_us`` on the trace's clock is ``anchor_host`` on the host's)."""
    named = []
    for begin, end in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        middle = anchor_host + ((begin + end) / 2 - anchor_us) * 1e-6
        inside = [s for s in spans if s[1] <= middle <= s[2]]
        name = max(inside, key=lambda s: s[1])[0] if inside \
            else 'outside every span'
        named.append([name, (end - begin) * 1e-6])
    return named
