"""Entry points: the flagship model's forward step, and the multi-device
dry run.

Port of ``__graft_entry__.py``.  ``dryrun_multichip`` runs one process a
device, joined by ``torch.distributed`` (NCCL on cards, gloo on the CPU):

    python -m vkit_tpu_torch.entry --devices 8 --device cpu
    python -m vkit_tpu_torch.entry --devices 1          # one card

spawns the ranks itself, one card each on this host; a process that has
already joined a process group (torchrun, or a caller's
``initialize_distributed``) calls ``dryrun_multichip`` on every rank
instead.  Ranks on several hosts need ``checkpoint_dir`` (``--checkpoint-
dir``), a directory that all of them see, for the checkpoint round trip;
without one they skip it, as vkit_tpu's multi-process dry run does.
"""
import argparse
import math
import os
import shutil
import socket
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from . import convert
from .models import (
    CheckpointManager,
    TrainBatch,
    create_model,
    create_optimizer,
    init_train_state,
    make_train_step,
    synth_to_train_batch,
)
from .models.train import train_state_sharding
from .ops.warp_mxu import apply_affine_warp
from .parallel import (
    DATA_AXIS,
    SPATIAL_AXIS,
    Sharding,
    batch_sharding,
    data_sharding,
    gather,
    initialize_distributed,
    make_mesh,
    make_multihost_mesh,
    put,
    sample_synthesis_params,
    shard_params_for_tp,
    synthesize_batch,
)
from .parallel.mesh import DEFAULT_AXIS_NAMES, local_slice
from .synth import synthesize_page_batch
from .synth.assets import build_assets, find_font, make_planner
from .synth.prep import CHAR_MASK, NUM_LABEL_CHANNELS


def entry(device='cuda'):
    """(fn, example_args): the forward step of the flagship model (default
    widths, bfloat16) and its arguments, parameters and a (4, 128, 128, 3)
    uint8 batch, on ``device``."""
    device = convert.resolve_device(device)
    model = create_model()
    images = torch.zeros((4, 128, 128, 3), dtype=torch.uint8, device=device)
    params = init_train_state(model, create_optimizer(), images,
                              device=device).params

    def forward(params, images):
        return torch.func.functional_call(model, params, (images,))

    return forward, (params, images)


WIDTHS = dict(stage_features=(64, 128, 256, 512), fpn_features=128)


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _from_rank0(make):
    """``make()`` run on rank 0, its result handed to every rank."""
    value = [make() if _rank() == 0 else None]
    if dist.is_initialized():
        dist.broadcast_object_list(value, src=0)
    return value[0]


def _all_ranks(value):
    """[``value`` of every rank], in rank order."""
    if not dist.is_initialized():
        return [value]
    values = [None] * dist.get_world_size()
    dist.all_gather_object(values, value)
    return values


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _rank_main(rank, n_devices, num_processes, device, store, kwargs):
    """One spawned rank: join the group through the FileStore ``store``,
    run the dry run, leave the group.  The ranks share this host, so rank
    r takes card r; ``LOCAL_WORLD_SIZE`` lays them out as
    ``num_processes`` nodes for ``make_multihost_mesh``."""
    os.environ.update(
        LOCAL_WORLD_SIZE=str(n_devices // max(num_processes, 1)),
        LOCAL_RANK=str(rank))
    if device == 'cpu':
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_devices))
    initialize_distributed(f'file://{store}', n_devices, rank, device)
    try:
        dryrun_multichip(n_devices, num_processes, device, **kwargs)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, num_processes: int = 0, device='cuda',
                     page_side: int = 320, pages_per_rank: int = 2,
                     checkpoint_dir=None, axes=DEFAULT_AXIS_NAMES):
    """One sharded train step, composed pages, a dp-sharded generate-and-
    train step and a sharded checkpoint round trip over an ``n_devices``
    dp x sp x tp mesh, after the sharded forward is held to the unsharded
    net.  Rank 0 prints the seconds and collective bytes, the forward's
    difference and, last, the reference's one-line report; the numbers
    are returned.

    Unless this process is already in a process group of ``n_devices``
    ranks, it spawns them (``num_processes`` > 1 lays them out as that many
    nodes: dp spans the nodes, sp x tp the ranks of one) and returns None.
    ``page_side`` and ``pages_per_rank`` size the composed pages: the
    reference's are 320 and 2.  The checkpoint round trip runs in
    ``checkpoint_dir``, which every rank must see, or else in a temporary
    directory when all ranks run on one host; ranks on several hosts
    without ``checkpoint_dir`` skip it.  ``axes`` names the mesh's axes:
    ``('tp',)`` puts every rank on tp, for instance.
    """
    if not dist.is_initialized() and n_devices > 1:
        import torch.multiprocessing as mp

        if device == 'cuda' and n_devices > torch.cuda.device_count():
            raise ValueError(f'{n_devices} ranks, one card each, on a host '
                             f'with {torch.cuda.device_count()} cards')
        with tempfile.TemporaryDirectory() as tmp:
            mp.start_processes(
                _rank_main,
                args=(n_devices, num_processes, device,
                      os.path.join(tmp, 'store'),
                      dict(page_side=page_side,
                           pages_per_rank=pages_per_rank,
                           checkpoint_dir=checkpoint_dir, axes=axes)),
                nprocs=n_devices, start_method='spawn')
        return None

    world = dist.get_world_size() if dist.is_initialized() else 1
    if num_processes > 1:
        mesh = make_multihost_mesh(axes, device_type=device)
    else:
        mesh = make_mesh(n_devices, axes, device_type=device)
    dev = mesh.device
    dp, sp = mesh.size(DATA_AXIS), mesh.size(SPATIAL_AXIS)

    # One sharded train step of the default-width net on random images.
    batch_size = dp * pages_per_rank
    side = max(32, sp * 32)   # Even rows per sp rank at every stride.
    model = create_model(**WIDTHS)
    optimizer = create_optimizer()
    images = np.random.default_rng(0).integers(
        0, 256, (batch_size, side, side, 3), dtype=np.uint8)
    half = side // 2
    labels = np.zeros((batch_size, half, half), dtype=np.float32)
    batch = TrainBatch(images=images, char_masks=labels,
                       char_heights=labels, char_gaussians=labels)
    state = init_train_state(model, optimizer, images[:1], device=dev)
    whole = create_model(**WIDTHS).to(dev)
    whole.load_state_dict(state.params)
    param_shardings = shard_params_for_tp(state.params, mesh,
                                          min_channels=256)
    model.shard(param_shardings)
    state = put(state, train_state_sharding(state, param_shardings))
    labels_sharding = data_sharding(mesh, ndim=3)
    batch = put(batch, TrainBatch(batch_sharding(mesh, ndim=4),
                                  labels_sharding, labels_sharding,
                                  labels_sharding))
    # The sharded forward against the unsharded net on the same images,
    # within 8 eps of the compute dtype at the largest output: the sums
    # of the sp-split GroupNorms and convs run in another order.
    with torch.no_grad():
        want = whole(torch.from_numpy(images).to(dev))
        got = [gather(out, batch_sharding(mesh, ndim=4))
               for out in model(batch.images)]
    forward_err = max(float((g.float() - w.float()).abs().max())
                      for g, w in zip(got, want))
    forward_tol = 8 * torch.finfo(model.dtype).eps * max(
        float(w.float().abs().max()) for w in want)
    del whole, want, got
    if not forward_err <= forward_tol:
        raise RuntimeError(f'the sharded forward is {forward_err} off the '
                           f'unsharded net (limit {forward_tol})')
    train_step = make_train_step(model, optimizer)
    _sync(dev)
    begin = time.perf_counter()
    new_state, metrics = train_step(state, batch)
    loss = float(metrics['loss'])
    step_seconds = time.perf_counter() - begin
    if not math.isfinite(loss):
        raise RuntimeError(f'non-finite loss: {loss}')

    # Composed pages (layout, text, glyphs; photometric and geometric off):
    # every rank writes the same small assets, plans the same pages and
    # composes its dp slice of them.
    gside = page_side
    with tempfile.TemporaryDirectory(prefix='vkit_dryrun_assets_') as tmp:
        planner = make_planner(build_assets(tmp, find_font(tmp)), gside,
                               full_content=False)
        host_pages = planner.prepare_batch(batch_size,
                                           np.random.default_rng(1))
    first = mesh.coordinate(DATA_AXIS) * pages_per_rank
    assembled = synthesize_page_batch(
        host_pages[first:first + pages_per_rank], 3,
        np.random.default_rng(2), enable_photometric=False,
        enable_geometric=False, keep_on_device=True, device=dev)
    raw = assembled.images
    labels = torch.cat([assembled.label_stack,
                        assembled.active_masks[..., None].float()], dim=-1)
    if tuple(raw.shape) != (pages_per_rank, gside, gside, 3):
        raise RuntimeError(f'composed pages {tuple(raw.shape)}')
    char_px = mesh.all_reduce_(labels[..., CHAR_MASK].sum(), (DATA_AXIS,))
    if float(char_px) <= 0:
        raise RuntimeError('composed pages carry no char mask')

    # Generate and train: the one-program chain on this rank's dp slice
    # (K1 warps it), the labels on the same warp plans, then the step.
    params, warp_statics = sample_synthesis_params(
        np.random.default_rng(3), batch_size, gside, gside, level=3)
    params = convert.synthesis_params(
        local_slice(params, Sharding(mesh, (DATA_AXIS,))), dev)
    generator = torch.Generator(device=dev)
    generator.manual_seed(0)
    _sync(dev)
    begin = time.perf_counter()
    synth = synthesize_batch(raw, params, generator, warp_statics,
                             out_shape=(gside, gside))
    warped = apply_affine_warp(labels, params.warp_plan, warp_statics)
    train_batch = synth_to_train_batch(
        synth, warped[..., :NUM_LABEL_CHANNELS],
        warped[..., NUM_LABEL_CHANNELS] > 0.5)
    # The images' rows go to the sp ranks; the labels stay whole rows.
    train_batch = train_batch._replace(images=local_slice(
        train_batch.images, Sharding(mesh, (None, SPATIAL_AXIS))))
    label_px = float(mesh.all_reduce_(train_batch.char_masks.sum(),
                                      (DATA_AXIS,)))
    gen_seconds = time.perf_counter() - begin
    traffic = dict(mesh.traffic)
    begin = time.perf_counter()
    new_state2, metrics2 = train_step(new_state, train_batch)
    loss2 = float(metrics2['loss'])
    gen_train_step_seconds = time.perf_counter() - begin
    step_traffic = {kind: count - traffic.get(kind, 0)
                    for kind, count in mesh.traffic.items()}
    if not math.isfinite(loss2):
        raise RuntimeError(f'non-finite gen+train loss: {loss2}')
    if label_px <= 0:
        raise RuntimeError('gen+train labels are degenerate (all zero)')

    # Checkpoint round trip of the sharded state: the ranks share the
    # directory, rank 0 writes the gathered state, each restores its
    # slices.
    one_host = len(set(_all_ranks(socket.gethostname()))) == 1
    ckpt_note = 'skipped-multihost'
    if checkpoint_dir is not None or one_host:
        root = checkpoint_dir or _from_rank0(
            lambda: tempfile.mkdtemp(prefix='vkit_dryrun_'))
        manager = CheckpointManager(os.path.join(root, 'dryrun_checkpoints'))
        manager.save(new_state2, metadata={'note': 'dryrun'},
                     sharding=param_shardings)
        restored = manager.restore(state, step=int(new_state2.step),
                                   sharding=param_shardings)
        moments = new_state2.opt_state['state']
        same = (int(restored.step) == int(new_state2.step)
                and all(torch.equal(value, new_state2.params[name])
                        for name, value in restored.params.items())
                and all(torch.equal(value, moments[index][key])
                        for index, entry in (
                            restored.opt_state['state'].items())
                        for key, value in entry.items()))
        if not same:
            raise RuntimeError('sharded checkpoint round trip failed')
        if dist.is_initialized():
            dist.barrier()
        if _rank() == 0:
            shutil.rmtree(root if checkpoint_dir is None else
                          manager.directory, ignore_errors=True)
        ckpt_note = 'ok'

    report = {
        'mesh': dict(mesh.shape), 'processes': world,
        'batch': (batch_size, side, side), 'loss': loss,
        'forward_err': forward_err, 'forward_tol': forward_tol,
        'gen_train_loss': loss2, 'label_px': label_px,
        'sharded_ckpt': ckpt_note, 'step_seconds': step_seconds,
        'gen_seconds': gen_seconds,
        'gen_train_step_seconds': gen_train_step_seconds,
        'gen_train_step_traffic': step_traffic,
    }
    if _rank() == 0:
        print(f'seconds: first sharded step {step_seconds}, generation '
              f'{gen_seconds}, train step on the generated batch '
              f'{gen_train_step_seconds}; bytes rank 0 handed to '
              f'collectives in that step {step_traffic}', flush=True)
        print(f'sharded forward vs the unsharded net: max abs difference '
              f'{forward_err} (limit {forward_tol}: 8 {model.dtype} eps of '
              f'the largest output)', flush=True)
        print(
            f'dryrun_multichip OK: mesh={report["mesh"]} '
            f'processes={world} '
            f'batch={batch_size}x{side}x{side} loss={loss:.4f} '
            f'gen+train(composed {gside}^2 prep pages) loss={loss2:.4f} '
            f'label_px={label_px:.0f} '
            f'sharded-ckpt={ckpt_note}', flush=True)
    return report


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--devices', type=int, default=None,
                        help='ranks, one device each (default: the cards)')
    parser.add_argument('--processes', type=int, default=0,
                        help='nodes to lay the ranks out as (dp spans them)')
    parser.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    parser.add_argument('--checkpoint-dir', default=None,
                        help='a directory every rank sees, for the '
                        'checkpoint round trip of ranks on several hosts')
    parser.add_argument('--axes', default=','.join(DEFAULT_AXIS_NAMES),
                        help='the mesh\'s axes, comma-separated (default: '
                        '%(default)s)')
    args = parser.parse_args()
    devices = args.devices
    if devices is None:
        devices = (torch.cuda.device_count() if args.device == 'cuda'
                   else 1)
    dryrun_multichip(devices, args.processes, args.device,
                     checkpoint_dir=args.checkpoint_dir,
                     axes=tuple(args.axes.split(',')))


if __name__ == '__main__':
    main()
