"""Host->device prefetch pump.

Port of vkit_tpu/parallel/prefetch.py.  Host threads produce batches (numpy
arrays or tensors, in any nesting of tuples, lists and dicts), a pump
thread moves them to the device ahead of consumption, and a bounded queue
gives backpressure with no serialization.  On a card the move goes through
pinned host memory on a side stream; a batch is handed over only once its
copy has finished.  With a ``sharding`` (parallel/mesh.py: one Sharding
for every array of a batch, or a nesting of them shaped like the batch)
each rank of the mesh receives its slice of every batch, cut on the host,
on the mesh's device in place of ``device``.
"""
import queue
import threading
from typing import Callable, Iterator, Optional

import torch

from ..convert import nested_to_device, resolve_device
from .mesh import local_slice, mesh_of


class DevicePrefetcher:
    """Iterate device-resident batches, staying ``depth`` batches ahead."""

    _SENTINEL = object()

    def __init__(
        self,
        batch_iterator: Iterator,
        device='cuda',
        depth: int = 2,
        sharding=None,
    ):
        self.batch_iterator = batch_iterator
        self.sharding = sharding
        self.device = resolve_device(
            device if sharding is None else mesh_of(sharding).device)
        self.queue: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self.error: Optional[BaseException] = None
        self.stopped = False
        self.thread = threading.Thread(target=self._pump, daemon=True)
        self.thread.start()

    def _pump(self):
        try:
            on_card = self.device.type == 'cuda'
            stream = torch.cuda.Stream(self.device) if on_card else None
            for batch in self.batch_iterator:
                if self.stopped:
                    return
                if self.sharding is not None:
                    batch = local_slice(batch, self.sharding)
                if on_card:
                    with torch.cuda.stream(stream):
                        batch = nested_to_device(batch, self.device, True)
                    stream.synchronize()
                else:
                    batch = nested_to_device(batch, self.device)
                self.queue.put(batch)
        except BaseException as exc:  # Surface worker errors to the consumer.
            self.error = exc
        finally:
            self.queue.put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.queue.get()
        if item is self._SENTINEL:
            if self.error is not None:
                raise self.error
            raise StopIteration
        return item

    def stop(self):
        self.stopped = True
        # Drain so the pump thread unblocks and exits.
        try:
            while True:
                self.queue.get_nowait()
        except queue.Empty:
            pass


def prefetch_map(
    produce_batch: Callable[[int], object],
    num_batches: int,
    device='cuda',
    depth: int = 2,
    sharding=None,
) -> DevicePrefetcher:
    """Prefetch ``produce_batch(idx)`` for idx in range(num_batches)."""
    return DevicePrefetcher(
        (produce_batch(idx) for idx in range(num_batches)),
        device=device,
        depth=depth,
        sharding=sharding,
    )
