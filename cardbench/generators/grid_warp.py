"""Traffic generator: a labelled batch distorted by one geometric policy, step
after step, in a closed loop with one step in flight (bench.py's loop).

The steps come from a pool of POOL_STEPS steps of per-sample configs,
drawn once by the policy's frozen sampler (``policies/<policy>.py``) from
POOL_SEED: every seed runs the same work, in its own order.  A step plans
each sample's warp on the host from its config, warps image and label
planes in one ``batched_plan_warp`` call (the two halves of
``batched_grid_warp``, which returns no plans for the labels), and maps
the 64 box polygons and 64 points through each plan.  The host waits for
a step's output only after it has enqueued the next step; the time at
which that wait returns is when the output became ready for a consumer.

The inputs are made on the device from the seed: uint8 RGB noise, a mask
plane of ones and a uniform score map.  The check: one step of the
window and 8 of its samples, drawn from the seed, keep their configs,
outputs and mapped points; after the window the reference works out each
sample's geometry from its config and, from that, the warp and the
points.
"""
import time

import numpy as np

from cardbench.harness import HERE, free_device, host_copy as host, \
    load_module

POOL_STEPS = 64
POOL_SEED = 20261018
# Steps before the window: every shape the window uses is built by then.
WARMUP_STEPS = 3
CHECK_AMONG = 8
# Samples of the checked step whose output the reference re-derives.
CHECK_SAMPLES = 8
# Channels of the warped stack that hold 0-1 label planes.
PLANES = (3, 4)


def label_sample(side: int):
    """64 box polygons and 64 points on an 8 x 8 grid of the page (a copy
    of ``_label_sample`` in chip_smoke.py at commit 413b729)."""
    cell = side // 8
    polygons, points = [], []
    for row in range(8):
        for col in range(8):
            up, left = row * cell + 4, col * cell + 4
            polygons.append(np.asarray([
                (left, up), (left + cell - 8, up),
                (left + cell - 8, up + cell // 2), (left, up + cell // 2),
            ], dtype=np.float64))
            points.append((left, up))
    return np.concatenate(polygons + [np.asarray(points, np.float64)])


def make_stack(config: dict, seed: int, device):
    """(N, S, S, 5) float32 on the device: RGB noise, ones, a score map."""
    import torch

    n, s = config['batch'], config['side']
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    stack = torch.empty((n, s, s, 5), dtype=torch.float32, device=device)
    stack[..., :3] = torch.randint(0, 256, (n, s, s, 3), generator=gen,
                                   device=device, dtype=torch.uint8)
    stack[..., 3] = 1.0
    stack[..., 4] = torch.rand((n, s, s), generator=gen, device=device)
    return stack


def policy(name: str):
    from vkit_tpu_torch.mechanism import distortion

    return getattr(distortion, name)


def policy_file(name: str):
    """The policy's frozen sampler and plain geometry."""
    return load_module(HERE / 'policies' / f'{name}.py',
                       f'cardbench_policy_{name}')


class Step:
    """One step of the loop, its spans and the captured step."""

    def __init__(self, run, stack, seed: int):
        self.run = run
        self.stack = stack
        self.rng = np.random.default_rng([seed, 1])
        self.check_rng = np.random.default_rng([seed, 5])
        self.points = label_sample(run.config['side'])
        self.distortion = policy(run.params['policy'])
        self.policy = policy_file(run.params['policy'])
        self.captured = None
        gen = np.random.default_rng(POOL_SEED)
        shape = tuple(stack.shape[1:3])
        self.pool = [
            [self.policy.sample(run.config['level'], shape, gen)
             for _ in range(stack.shape[0])]
            for _ in range(POOL_STEPS)]
        self.order = self.rng.permutation(POOL_STEPS)
        self.taken = 0

    def configs(self):
        """The next step's per-sample configs."""
        step = self.order[self.taken % POOL_STEPS]
        self.taken += 1
        return self.pool[step]

    def __call__(self, capture: bool = False):
        import torch

        from vkit_tpu_torch.mechanism.batched import batched_plan_warp

        run = self.run
        shape = tuple(self.stack.shape[1:3])
        configs = self.configs()
        with run.measure('warp', sync=run.trace):
            plans = [self.distortion.plan(cfg, shape, self.rng)
                     for cfg in configs]
            out = batched_plan_warp(plans, self.stack)[0]
        with run.measure('labels'):
            mapped = [plan.map_points(self.points) for plan in plans]
        if capture:
            keep = np.sort(self.check_rng.choice(
                len(plans), min(CHECK_SAMPLES, len(plans)), replace=False))
            index = torch.as_tensor(keep, device=out.device)
            self.captured = (keep, [configs[i] for i in keep],
                             host(out.index_select(0, index)),
                             [mapped[i] for i in keep])
        return out


def window(run, step, check_index: int):
    """Warm-up steps, then the measured window; returns the batch size."""
    import torch

    from cardbench.stats import RateWindow, percentile

    batch = int(step.stack.shape[0])
    for _ in range(WARMUP_STEPS):
        step()
    run.synchronize()
    rate = RateWindow(run.seconds)
    rate.begin(run.open_window(kernels=('k3', 'k1')))
    index = 0
    pending = None

    def ready(event):
        if event is not None:
            event.synchronize()
        rate.done(batch, time.perf_counter())

    more = True
    while more or index <= check_index:
        out = step(capture=index == check_index)
        event = None
        if run.device == 'cuda':
            event = torch.cuda.Event()
            event.record()
        if pending is not None:
            ready(pending[0])
            more = run.keep_going(rate)
        pending = (event, out)
        index += 1
    ready(pending[0])
    del pending, out
    run.close_window()
    run.units = index
    run.attempted = index * batch
    run.end_to_end['images_per_s'] = rate.rate()
    run.end_to_end['gap_p95_ms'] = percentile(rate.gaps(), 95) * 1e3
    run.end_to_end['peak_mem_gib'] = run.window_peak / 2**30
    return batch


def readings(step, device, control: bool = False) -> dict:
    """The compared numbers of the captured step (with ``control``, of the
    reference computed in bfloat16 in the program's place)."""
    import torch

    from cardbench import reference as R

    keep, configs, out, mapped = step.captured
    src = host(step.stack)[keep]
    shape = tuple(src.shape[1:3])
    geoms = [step.policy.geometry(c, shape) for c in configs]
    gaps = R.warp_gaps(geoms, src, out, device, planes=PLANES,
                       control=control)
    worst = 0.0
    for geom, got in zip(geoms, mapped):
        want = R.geometry_points(geom, step.points, device)
        if control:
            got = R.geometry_points(geom, step.points, device,
                                    torch.bfloat16)
        worst = max(worst, float(np.abs(np.asarray(got) - want).max()))
    return {'warp_lsb': max((g for g in gaps if g is not None),
                            default=None),
            'points_px': worst}


def run(run, control: bool = False):
    """One run of the cell; with ``control`` the readings of the bfloat16
    control land in ``run.control``."""
    stack = make_stack(run.config, run.seed, run.device)
    step = Step(run, stack, run.seed)
    check_index = int(np.random.default_rng([run.seed, 3]).integers(
        0, CHECK_AMONG))
    window(run, step, check_index)
    free_device()
    values = readings(step, run.device)
    for name, value in values.items():
        run.check(name, value)
    if control:
        run.control = readings(step, run.device, control=True)
