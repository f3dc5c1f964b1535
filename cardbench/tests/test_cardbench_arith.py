"""The benchmark's own arithmetic, on the CPU: the whole-batch window, the
tail of every gap, merged device intervals and trace completeness, the
roofline bytes of K1 and K3, the top-level-name check."""
import json

import pytest
import torch

from cardbench import roofline, stats
from cardbench.harness import forbidden_modules
from cardbench.roofline import Call
from cardbench.trace import WARMUP_SPINS, read_trace


def test_window_holds_whole_batches_until_the_seconds():
    window = stats.RateWindow(10.0)
    window.begin(100.0)
    for at in (104.0, 108.0):
        window.done(8, at)
        assert not window.full()
    window.done(8, 112.5)
    assert window.full()
    assert window.rate() == pytest.approx(24 / 12.5)
    assert window.gaps() == pytest.approx([4.0, 4.0, 4.5])


def test_window_without_a_completion_has_no_rate():
    window = stats.RateWindow(1.0)
    window.begin(0.0)
    with pytest.raises(ValueError):
        window.rate()


@pytest.mark.parametrize('q,want', [(95, 95.05), (50, 50.5), (100, 100.0),
                                    (0, 1.0)])
def test_percentile_over_every_gap(q, want):
    values = list(range(100, 0, -1))
    assert stats.percentile(values, q) == pytest.approx(want)


def test_percentile_of_one_value():
    assert stats.percentile([3.0], 95) == 3.0


def test_merged_intervals_count_overlaps_once():
    busy, gaps = stats.busy_and_gaps([(0, 2), (1, 3), (5, 6), (5.5, 5.7),
                                      (8, 9)])
    assert busy == pytest.approx(3 + 1 + 1)
    assert gaps == [(3, 5), (6, 8)]


def _trace(tmp_path, calls, drop=None, extra_busy=0.0):
    """A Chrome trace of WARMUP_SPINS markers, then per call three markers
    around one kernel and one counting kernel."""
    events, cid, ts = [], 0, 0.0

    def launch(name, dur):
        nonlocal cid, ts
        cid += 1
        ts += 10.0
        events.append({'ph': 'X', 'cat': 'cuda_runtime',
                       'name': 'cudaLaunchKernel', 'ts': ts, 'dur': 1,
                       'args': {'correlation': cid}})
        if cid != drop:
            events.append({'ph': 'X', 'cat': 'kernel', 'name': name,
                           'ts': ts + 1, 'dur': dur,
                           'args': {'correlation': cid}})

    for _ in range(WARMUP_SPINS):
        launch('void spin_kernel(long)', 0.5)
    for _ in range(calls):
        launch('void spin_kernel(long)', 0.5)
        launch('void row_shift_window_slab_kernel<7>(float*)',
               4.0 + extra_busy)
        launch('void spin_kernel(long)', 0.5)
        launch('void reduce_kernel<float>(float*)', 2.0)
        launch('void spin_kernel(long)', 0.5)
    path = tmp_path / 'trace.json'
    path.write_text(json.dumps({'traceEvents': events}))
    return path


def test_trace_gives_a_call_its_kernels_and_leaves_out_markers(tmp_path):
    calls = [Call('k1', torch.tensor(100.0)), Call('k1', torch.tensor(50.0))]
    reading = read_trace(_trace(tmp_path, 2), calls, window_us=1e4)
    assert reading['missing'] == {}
    assert reading['kernel_us'] == {'k1': pytest.approx(8.0)}
    # Busy: only the two kernels (markers and byte counting left out).
    assert reading['busy_us'] == pytest.approx(8.0)
    assert list(reading['ops_us']) == ['row_shift_window_slab_kernel']


def test_trace_that_lost_a_record_is_incomplete(tmp_path):
    calls = [Call('k1', torch.tensor(1.0))]
    reading = read_trace(_trace(tmp_path, 1, drop=WARMUP_SPINS + 2), calls,
                         window_us=1e4)
    assert 'cudaLaunchKernel' in reading['missing']


def test_trace_busier_than_its_window_is_incomplete(tmp_path):
    calls = [Call('k1', torch.tensor(1.0))]
    reading = read_trace(_trace(tmp_path, 1, extra_busy=50.0), calls,
                         window_us=10.0)
    assert "busy beyond the events' window" in reading['missing']


def test_k1_bytes_of_the_captured_page_warp():
    """(8, 640, 7, 640) -> 1024, every window over the whole row: the
    238.6 MB of PERF.md's kernel table (chip_smoke.py's window_work)."""
    x = torch.zeros((8, 640, 7, 640))
    starts = torch.zeros((8, 640), dtype=torch.int32)
    nbytes = float(roofline.window_work(x, starts, 1024))
    assert nbytes == 4.0 * (7 * 640 * 8 * 640 + 8 * 640 + 8 * 640 * 7 * 1024)
    assert round(nbytes / 1e6, 1) == 238.6


def test_k1_bytes_count_only_the_overlapped_source():
    x = torch.zeros((1, 2, 1, 100))
    starts = torch.tensor([[-50, 2048 - 30]], dtype=torch.int32)
    # Row 0 reads lanes [0, 30) of its window of 80; row 1 wraps: [0, 50).
    nbytes = float(roofline.window_work(x, starts, 80))
    assert nbytes == 4.0 * ((30 + 50) + 2 + 2 * 80)


def test_k3_bytes_of_the_captured_page_warp():
    """(8, 640, 7, 640) -> 640, taps 64, every source float weighted:
    the 196.6 MB of PERF.md's kernel table (chip_smoke.py's
    banded_work)."""
    n, lines, c, w = 8, 640, 7, 640
    x = torch.zeros((n, lines, c, w))
    # Each 128-lane block's base at its first lane: every output reads
    # tap 0 and 1 of its own column.
    base = (128 * torch.arange(w // 128, dtype=torch.int32)).expand(
        n, lines // 8, w // 128).contiguous()
    pos = torch.arange(w, dtype=torch.float32).expand(n, lines, w) \
        .contiguous()
    nbytes = float(roofline.banded_work(x, base, pos, 64))
    assert nbytes == 4.0 * (c * lines * n * w + base.numel() + pos.numel()
                            + n * lines * c * w)
    assert round(nbytes / 1e6, 1) == 196.6


def test_roofline_share_is_the_least_time_over_the_device_time():
    assert roofline.share_percent(3.35e9, 2e-3) == pytest.approx(50.0)


@pytest.mark.parametrize('names,found', [
    (['vkit_tpu_torch', 'vkit_tpu_torch.ops.kernels', 'numpy'], []),
    (['vkit_tpu'], ['vkit_tpu']),
    (['vkit_tpu.ops'], ['vkit_tpu.ops']),
    (['jax.numpy', 'torch'], ['jax.numpy']),
    (['jaxlib', 'flax.linen', 'optax', 'jaxtyping'],
     ['flax.linen', 'jaxlib', 'optax']),
])
def test_top_level_names_are_compared_whole(names, found):
    assert forbidden_modules(names) == found
