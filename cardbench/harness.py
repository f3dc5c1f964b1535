"""One run of one cell: set-up, a measured window, the check against the
plain reference, one JSON line.

The cell's configuration, traffic and metrics are found by name:
``BENCHMARK.json`` names the cell's configuration and traffic;
``configs/<config>.json`` holds the configuration, ``traffic/<traffic>.json``
the traffic's parameters and the generator that reads them
(``generators/<generator>.py``), and ``metrics/<metric>.py`` the reader
of each per-layer metric (for a metric named ``<quantity>.<kind>``
without a file of its own, ``metrics/<quantity>.py``).
"""
import argparse
import contextlib
import importlib.util
import json
import os
import shutil
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = frozenset({'jax', 'jaxlib', 'flax', 'optax', 'vkit_tpu'})
CACHE = HERE / '.cache'
CACHE_DIRS = {'TORCH_EXTENSIONS_DIR': 'torch_extensions',
              'TRITON_CACHE_DIR': 'triton'}
HOST_THREAD_VARS = ('OMP_NUM_THREADS', 'OPENBLAS_NUM_THREADS',
                    'MKL_NUM_THREADS')


def forbidden_modules(names) -> List[str]:
    """The entries of ``names`` whose top-level name (before the first dot)
    is one of FORBIDDEN, compared whole."""
    return sorted(n for n in names if n.split('.', 1)[0] in FORBIDDEN)


def load_module(path: Path, name: str):
    """A module from a file of this folder, by path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def host_copy(tensor):
    """A copy on the host (``.cpu()`` of a host tensor is the tensor
    itself, which the program may still change in place)."""
    return tensor.to('cpu', copy=True)


def free_device():
    """Drop what the program left for the collector and return the cached
    blocks, before the reference runs."""
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reader_path(metric: str) -> Path:
    """The reader of a per-layer metric: ``metrics/<metric>.py``, else that
    of the quantity before the first dot."""
    own = HERE / 'metrics' / f'{metric}.py'
    return own if own.exists() else \
        HERE / 'metrics' / f'{metric.split(".", 1)[0]}.py'


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell of BENCHMARK.json with its configuration and traffic."""

    def __init__(self, bench: dict, name: str):
        entries = {w['name']: w for w in bench['workloads']}
        if name not in entries:
            raise SystemExit(f'no workload {name!r} in BENCHMARK.json')
        self.entry = entries[name]
        self.name = name
        self.chips = int(self.entry['chips'])
        config = {c['name']: c for c in bench['configs']}[
            self.entry['config']]
        self.config = load_json(ROOT / config['file'])
        self.traffic = load_json(HERE / 'traffic'
                                 / f'{self.entry["traffic"]}.json')
        self.end_to_end = [m for m in bench['end_to_end']
                           if name in m.get('workloads', [name])]
        self.per_layer = [m for m in bench['per_layer']
                          if name in m.get('workloads', [name])]


class Run:
    """What a generator hands back and forth with the harness: the seed, the
    window, host spans, checks."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 started: float, device: str = 'cuda'):
        self.cell = cell
        self.config = cell.config
        self.params = cell.traffic.get('params', {})
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.started = started
        self.device = device
        self.spans: List[tuple] = []      # (name, begin, end, thread id)
        self.checks: Dict[str, dict] = {}
        self.control: Optional[dict] = None
        self.end_to_end: Dict[str, float] = {}
        self.units = 0                    # batches or steps in the window
        self.attempted = 0
        self.failed = 0
        self.setup_s: Optional[float] = None
        self.memory_peak = 0
        self.window_peak = 0
        self.trace_reading: Optional[dict] = None
        self.kernel_calls = None
        self._stack = contextlib.ExitStack()
        self._main = threading.get_ident()

    # -- spans -----------------------------------------------------------
    @contextlib.contextmanager
    def measure(self, name: str, sync: bool = False):
        """A host span; with ``sync`` closed by a device synchronize."""
        begin = time.perf_counter()
        try:
            yield
            if sync:
                self.synchronize()
        finally:
            self.spans.append((name, begin, time.perf_counter(),
                               threading.get_ident()))

    def check(self, name: str, value):
        """A compared number against its limit in the traffic file (at
        most the limit is right; a count's limit 0 asks for none); a None
        value fails."""
        limit = self.cell.traffic['limits'][name]
        ok = value is not None and value <= limit
        self.checks[name] = {'value': value, 'limit': limit, 'ok': ok}

    def synchronize(self):
        if self.device == 'cuda':
            import torch
            torch.cuda.synchronize()

    # -- the window ------------------------------------------------------
    # With --trace 1 the window has two halves: the first reads host spans
    # with the profiler off (it slows every launch from the host), the
    # second, from the first unit boundary past half of --seconds, runs
    # under the profiler and gives the device's readings.
    def open_window(self, kernels=()):
        """End of set-up: the peak memory restarts and the window opens;
        ``kernels`` are the ones whose calls a traced run attributes."""
        import torch

        self.synchronize()
        if self.device == 'cuda':
            self.memory_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        self.setup_s = time.time() - self.started
        self._kernels = tuple(kernels)
        self._profile_begin = None
        self.profiled_units = 0
        self._window_begin = time.perf_counter()
        return self._window_begin

    def keep_going(self, window) -> bool:
        """True while the window wants another unit: until it holds
        --seconds of whole units and, traced, one unit under the profiler.
        Call once after each unit."""
        if self._profile_begin is not None:
            self.profiled_units += 1
        elif (self.trace and self.device == 'cuda'
              and window.elapsed >= self.seconds / 2):
            self._start_profiler()
        return not window.full() or (self.trace and self.device == 'cuda'
                                     and self.profiled_units < 1)

    def _start_profiler(self):
        import torch
        from vkit_tpu_torch.utility.profiling import device_trace

        from .roofline import KernelCalls, spin
        from .trace import WARMUP_SPINS

        base = Path(os.environ.get('TMPDIR', '/tmp'))
        self._trace_dir = base / f'cardbench_trace_{os.getpid()}'
        self._stack.enter_context(
            device_trace(str(self._trace_dir), host=False))
        for _ in range(WARMUP_SPINS - 1):
            spin()
        self.synchronize()
        self._anchor_host = time.perf_counter()
        spin()
        self.kernel_calls = KernelCalls(self._kernels).install()
        self._stack.callback(self.kernel_calls.uninstall)
        self._events = [torch.cuda.Event(enable_timing=True)
                        for _ in range(2)]
        self._events[0].record()
        self._profile_begin = time.perf_counter()

    def close_window(self):
        import torch

        if self._profile_begin is not None:
            self._events[1].record()
        self.synchronize()
        if self.device == 'cuda':
            self.window_peak = torch.cuda.max_memory_allocated()
            self.memory_peak = max(self.memory_peak, self.window_peak)
        if self._profile_begin is None:
            self._stack.close()
            return
        from .trace import read_trace

        self.kernel_calls.uninstall()
        window_us = self._events[0].elapsed_time(self._events[1]) * 1e3
        try:
            self._stack.close()          # writes the trace
            files = sorted(self._trace_dir.glob('*.json'))
            if len(files) != 1:
                raise RuntimeError(f'the profiler wrote {len(files)} traces')
            self.trace_reading = read_trace(
                files[0], self.kernel_calls.calls, window_us)
        finally:
            shutil.rmtree(self._trace_dir, ignore_errors=True)
        self.trace_reading['window_us'] = window_us
        self.trace_reading['kernel_bytes'] = self.kernel_calls.totals()

    def span_half(self):
        """(begin, end) on the host's clock of the part of the window
        whose spans ran without the profiler."""
        end = self._profile_begin
        return self._window_begin, (end if end is not None else float('inf'))

    def main_spans(self):
        return [(n, b, e) for n, b, e, t in self.spans if t == self._main]


def _per_layer(run: Run) -> Dict[str, dict]:
    out = {}
    for metric in run.cell.per_layer:
        name = metric['name']
        reader = load_module(reader_path(name), f'cardbench_metric_{name}')
        value = reader.read(run)
        if value is not None:
            out[name] = {'value': value, 'unit': metric['unit']}
    return out


def _breakdown(run: Run) -> Optional[dict]:
    from .trace import name_gaps

    reading = run.trace_reading
    if reading is None or reading['anchor_us'] is None:
        return None
    ops = sorted(reading['ops_us'].items(), key=lambda kv: -kv[1])[:10]
    return {
        'device_ops': [[name, us * 1e-6] for name, us in ops],
        'idle_gaps': name_gaps(reading['gaps'], run.main_spans(),
                               reading['anchor_us'], run._anchor_host),
    }


def correct(run: Run) -> bool:
    """Every compared number within its limit, and no failed request."""
    return (run.failed == 0 and bool(run.checks)
            and all(c['ok'] for c in run.checks.values()))


def result_line(run: Run) -> dict:
    """The run's JSON result: end-to-end metrics with --trace 0, per-layer
    ones with --trace 1; the compared numbers last."""
    import torch

    if run.trace:
        metrics = _per_layer(run)
    else:
        # A metric named <quantity>.<cell kind> takes the generator's
        # <quantity>.
        values = dict(run.end_to_end, setup_s=run.setup_s)
        metrics = {m['name']: {'value': values[m['name'].split('.')[0]],
                               'unit': m['unit']}
                   for m in run.cell.end_to_end}
    device = {
        'platform': 'gpu',
        'kind': torch.cuda.get_device_name(0),
        'count': run.cell.chips,
        'memory_peak_bytes': run.memory_peak,
    }
    line = {
        'correct': correct(run),
        'attempted': run.attempted,
        'failed': run.failed,
        'metrics': metrics,
        'device': device,
    }
    if run.trace:
        reading = run.trace_reading
        device['busy_s'] = reading['busy_us'] * 1e-6
        device['window_s'] = reading['window_us'] * 1e-6
        breakdown = _breakdown(run)
        if breakdown is not None:
            line['breakdown'] = breakdown
    line['checks'] = {name: {'value': c['value'], 'limit': c['limit']}
                      for name, c in run.checks.items()}
    return line


def parse(argv):
    parser = argparse.ArgumentParser(prog='cardbench/run.py')
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def prepare_environment():
    """Fixed cache directories inside the checkout, set before torch
    loads; no library of the port may load JAX; one host thread."""
    for var, sub in CACHE_DIRS.items():
        path = CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'
    # One host thread, as in a worker of PyTorch's DataLoader
    # (torch/utils/data/_utils/worker.py sets it): the host planning of an
    # input pipeline runs so, and with the default of 8 threads (an 8-core
    # H100 host) the camera cell ran slower and no steadier.
    for var in HOST_THREAD_VARS:
        os.environ[var] = '1'
    import torch

    torch.set_num_threads(1)


def main(argv, started: float) -> int:
    args = parse(argv)
    bench_file = ROOT / 'BENCHMARK.json'
    if not bench_file.exists():
        print(f'{bench_file} is missing', file=sys.stderr)
        return 2
    cell = Cell(load_json(bench_file), args.workload)
    prepare_environment()
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f'{cell.name} needs {cell.chips} CUDA device(s); '
              f'available: {torch.cuda.is_available()}, '
              f'count {torch.cuda.device_count()}', file=sys.stderr)
        return 2
    try:
        import vkit_tpu_torch  # noqa: F401
    except ImportError as error:
        print(f'the program under test does not import: {error}',
              file=sys.stderr)
        return 2
    run = Run(cell, args.seed, args.seconds, bool(args.trace), started)
    name = cell.traffic['generator']
    generator = load_module(HERE / 'generators' / f'{name}.py',
                            f'cardbench_generator_{name}')
    generator.run(run)
    found = forbidden_modules(sys.modules)
    if found:
        print(f'forbidden modules loaded: {found}', file=sys.stderr)
        return 3
    line = result_line(run)
    for name, c in line['checks'].items():
        print(f'check {name} {c["value"]} limit {c["limit"]}',
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
