"""Host→device prefetch pipeline for chunked datasets.

Port of ``photon_ml_tpu/data/prefetch.py``. Reference parity: the
executor-side record streaming of photon-client's HDFS reads (a
host-side reader feeding a device-prefetch pipeline): keeping ``depth``
chunks in flight overlaps the host→device copy of the NEXT chunks with
the device work on the CURRENT one.

A JAX ``device_put`` is asynchronous by itself; a torch copy is not, so on
a CUDA device the pipeline builds the overlap explicitly:

* every copy runs on the pipeline's own copy stream;
* it reads a pinned host staging buffer, because a ``non_blocking`` copy
  from pageable numpy memory does not overlap anything; the rows reach
  that buffer by ``Tensor.copy_``, which runs on torch's intra-op
  threads (the host side of the pipeline is this copy, and one thread
  copies several times slower);
* an event recorded after a chunk's copies is what the consuming stream
  waits on before its first read of the chunk;
* each device tensor made on the copy stream is marked with
  ``Tensor.record_stream`` for the consuming stream, so the caching
  allocator does not hand its memory back to the copy stream while the
  consumer's work may still read it;
* a pinned buffer is refilled only after the copy that last read it has
  finished (its event, waited on by the host): the buffers form a ring of
  ``depth + 1`` slots, so that wait is on a copy queued a chunk earlier
  than the ones still in flight.

On the CPU (``device`` None or ``"cpu"``, and no ``place``) the pipeline
is the identity: each batch comes back as it went in. The reference's
``sharding`` argument places batches over a mesh: slice 9 of the port.
"""

from __future__ import annotations

import collections
import dataclasses
import warnings
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from photon_ml_torch.data.game_data import GameDataset, SparseShard


def _map_arrays(dataset: GameDataset, fn) -> GameDataset:
    """``dataset`` with ``fn(name, array)`` applied to every array: the
    scalar columns, each dense shard or ELL shard's indices and values,
    and the entity ids."""
    def shard(k, v):
        if isinstance(v, SparseShard):
            return SparseShard(indices=fn(f"shard_{k}_indices", v.indices),
                               values=fn(f"shard_{k}_values", v.values),
                               num_features=v.num_features)
        return fn(f"shard_{k}", v)

    out = dataclasses.replace(
        dataset,
        response=fn("response", dataset.response),
        offsets=fn("offsets", dataset.offsets),
        weights=fn("weights", dataset.weights),
        feature_shards={k: shard(k, v)
                        for k, v in dataset.feature_shards.items()},
        entity_ids={k: fn(f"entity_{k}", v)
                    for k, v in dataset.entity_ids.items()})
    if getattr(dataset, "_content_digest", None) is not None:
        out._content_digest = dataset._content_digest
    return out


def _as_tensor(a) -> torch.Tensor:
    """``a`` as a CPU tensor sharing its memory (a tensor as it is)."""
    if isinstance(a, torch.Tensor):
        return a
    with warnings.catch_warnings():
        # A read-only array is only ever read here.
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.ascontiguousarray(a))


def stage_dataset(dataset: GameDataset, device=None) -> GameDataset:
    """Device-resident copy of a GameDataset (dense and sparse shards,
    scalars, entity ids) on ``device`` (``cuda`` unless the caller names
    another). ``GameModel.score`` uses the staged tensors as they are, so
    repeated scoring or evaluation does no further host→device copy."""
    from photon_ml_torch.device import resolve_device

    dev = resolve_device(device)
    return _map_arrays(dataset, lambda _, a: _as_tensor(a).to(dev))


class _StreamPlacer:
    """Copies GameDatasets onto a CUDA device through one copy stream and
    a ring of pinned staging buffers (see the module docstring)."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.buffers: list[dict[str, torch.Tensor]] = [
            {} for _ in range(slots)]
        self.copied: list[Optional[torch.cuda.Event]] = [None] * slots
        self.placed = 0

    def _pinned(self, slot: dict, name: str,
                src: torch.Tensor) -> torch.Tensor:
        nbytes = src.numel() * src.element_size()
        buf = slot.get(name)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            slot[name] = buf
        host = buf[:nbytes].view(src.dtype).view(src.shape)
        host.copy_(src)
        return host

    def __call__(self, batch: GameDataset):
        k = self.placed % len(self.buffers)
        self.placed += 1
        if self.copied[k] is not None:
            # The copy that last read this slot's buffers must be done
            # before the host overwrites them.
            self.copied[k].synchronize()
        slot, made = self.buffers[k], []

        def put(name, a):
            host = self._pinned(slot, name, _as_tensor(a))
            out = torch.empty(host.shape, dtype=host.dtype,
                              device=self.device)
            out.copy_(host, non_blocking=True)
            made.append(out)
            return out

        with torch.cuda.stream(self.stream):
            staged = _map_arrays(batch, put)
            done = torch.cuda.Event()
            done.record(self.stream)
        self.copied[k] = done
        return staged, done, made


def device_prefetch(batches: Iterable, depth: int = 2, device=None,
                    place=None) -> Iterator:
    """Yield device-placed copies of ``batches``, keeping up to ``depth``
    placements in flight ahead of the consumer.

    ``place``: a callable that places one batch (any object), run in
    order on the host. Without it, ``batches`` are GameDatasets copied to
    ``device``: on a CUDA device through the copy stream and pinned
    buffers of the module docstring, each chunk's copies overlapping the
    consumer's work on the chunks before it (the consumer is whatever
    stream is current when a chunk is yielded); on the CPU (``device``
    None or ``"cpu"``) each batch as it is.
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    dev = None if device is None else torch.device(device)
    streamed = place is None and dev is not None and dev.type == "cuda"
    if streamed:
        place = _StreamPlacer(dev, depth + 1)
    elif place is None:
        def place(b):
            return b
    it = iter(batches)
    q: collections.deque = collections.deque()
    exhausted = False
    while True:
        while not exhausted and len(q) < depth:
            try:
                q.append(place(next(it)))
            except StopIteration:
                exhausted = True
        if not q:
            return
        item = q.popleft()
        if streamed:
            item, done, made = item
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(done)
            for t in made:
                t.record_stream(consumer)
        yield item


def iter_row_chunks(dataset: GameDataset, batch_rows: int):
    """Split a GameDataset into contiguous row chunks.

    Chunks are sliced with basic indexing, so dense shards and scalar
    columns are numpy VIEWS: no host copy happens until the device
    transfer itself.
    """
    if batch_rows < 1:
        raise ValueError(f"batch_rows must be >= 1, got {batch_rows}")
    n = dataset.num_rows
    for lo in range(0, n, batch_rows):
        yield dataset.subset(slice(lo, min(lo + batch_rows, n)))
