"""Row-streamed sparse fixed-effect coordinate: the Criteo row axis.

Port of ``photon_ml_tpu/game/coordinates/streaming_fixed.py`` on one
device. Reference parity: photon-api ``FixedEffectCoordinate`` +
``DistributedGLMLossFunction``: the fixed-effect fit is a host-loop
optimization whose every value/gradient is one pass over the data, so
the row axis never has to fit on one device. Here the data is
host-resident hot/cold chunks (``ops/streaming_sparse.ChunkedHybrid``)
streamed through the device per evaluation, and the host loop is the
host-driven L-BFGS/OWL-QN (``optim/streaming.py``). The device-resident
``SparseFixedEffectCoordinate`` is faster whenever the staged rows fit.

Streaming contract: the chunks must be staged with ZERO offsets: in
coordinate descent the full residual (base offsets + other coordinates'
scores) arrives as the ``offsets`` argument of ``train_model``, and
``score`` returns pure wᵀx margins.

Not supported on the streamed path (the reference raises too):
normalization, down-sampling, SIMPLE/FULL variances. Not ported yet,
each raising and naming the slice that ports it: the stochastic solvers
``solver="sdca"|"sgd"`` (slice 7) and meshes (slice 9). Chunks are stored
in float32, bfloat16 or int8 (``ops/streaming_sparse.py``).

Mid-fit checkpoints: ``game/descent.run`` with a checkpoint manager binds
a ``StreamingStateStore`` per step (``bind_step_checkpoint``); the fit
then saves its L-BFGS state after every accepted iteration and, bound to
a store that holds a snapshot of the same step and objective, resumes
from it.
"""

from __future__ import annotations

import copy
import hashlib
import os
import time
from typing import Optional

import numpy as np
import torch

from photon_ml_torch import not_ported
from photon_ml_torch.device import DeviceLike, resolve_device
from photon_ml_torch.game.checkpoint import StreamingStateStore
from photon_ml_torch.game.descent import _jsonable
from photon_ml_torch.game.models import FixedEffectModel
from photon_ml_torch.models.coefficients import Coefficients
from photon_ml_torch.ops import streaming_sparse as ss
from photon_ml_torch.ops.losses import PointwiseLoss
from photon_ml_torch.optim.problem import (GLMOptimizationConfiguration,
                                           VarianceComputationType)
from photon_ml_torch.optim.regularization import (intercept_mask,
                                                  l1_weights_vector, with_l2,
                                                  with_l2_value)
from photon_ml_torch.optim.streaming import minimize_streaming
from photon_ml_torch.utils import events as ev_mod

Tensor = torch.Tensor

_SOLVERS = ("lbfgs", "sdca", "sgd")


def _validate_streaming_config(config: GLMOptimizationConfiguration,
                               solver: str = "lbfgs") -> None:
    """The streamed path's feature envelope, enforced at construction AND
    at every config swap (the estimator's grid path). The reference
    resolves the solver first (``_resolve_solver``): a per-coordinate
    SDCA/SGD optimizer type overrides it, and SDCA falls back to SGD on a
    loss without a conjugate. Both rules concern the stochastic solvers,
    which are not ported, so the streaming-level ``solver`` is the
    effective one here."""
    if solver not in _SOLVERS:
        raise ValueError(f"streaming solver must be one of {_SOLVERS}, "
                         f"got {solver!r}")
    if solver in ("sdca", "sgd"):
        raise not_ported(f"solver={solver!r} (the streamed stochastic "
                         f"solvers)", 7)
    if config.down_sampling_rate < 1.0:
        raise ValueError("down-sampling is not supported on the "
                         "streaming path")
    if VarianceComputationType(config.variance_computation) != \
            VarianceComputationType.NONE:
        raise ValueError(
            "variance computation is not supported on the streaming path")


class StreamingSparseFixedEffectCoordinate:
    """Drop-in coordinate for ``game/descent.run`` over a chunk stream.

    ``device`` (``cuda`` unless the caller passes ``"cpu"``) runs every
    pass. On a card the chunks' host memory is pinned once here, the
    first ``pin_device_chunks`` chunks are placed on the card with their
    column layouts, and the rest stream through ``stream`` (an
    ``ops/streaming_sparse.ChunkStream``, whose counters show the bytes
    moved and the passes run). ``last_solve`` describes the latest
    ``train_model`` solve.
    """

    def __init__(
        self,
        dataset,
        chunked: ss.ChunkedHybrid,
        shard_id: str,
        loss: PointwiseLoss,
        config: GLMOptimizationConfiguration,
        intercept_index: Optional[int] = None,
        prefetch_depth: int = 2,
        pin_device_chunks: int = 0,
        solver: str = "lbfgs",
        mesh=None,
        log=lambda m: None,
        device: Optional[DeviceLike] = None,
    ):
        if mesh is not None:
            raise not_ported("a mesh for the streamed fixed effect (chunk "
                             "ranges sharded over devices)", 9)
        if chunked.num_rows != dataset.num_rows:
            raise ValueError(
                f"chunk stream has {chunked.num_rows} rows, dataset "
                f"{dataset.num_rows}")
        for i, ch in enumerate(chunked.chunks):
            # A chunk staged with nonzero offsets would DOUBLE-COUNT the
            # residuals in coordinate descent.
            if bool((ch.offsets != 0.0).any()):
                raise ValueError(
                    f"chunk {i} was staged with nonzero offsets. "
                    "Streaming contract: the chunks must be staged with "
                    "ZERO offsets — in coordinate descent the full "
                    "residual arrives as the ``offsets`` argument of "
                    "``train_model``, and ``score`` must return pure "
                    "wᵀx margins; staged offsets would be double-counted.")
        self.solver = (solver or "lbfgs").lower()
        _validate_streaming_config(config, self.solver)
        self.device = resolve_device(device)
        self.dataset = dataset
        self.shard_id = shard_id
        self.loss = loss
        self.config = config
        self.intercept_index = intercept_index
        self._log = log
        self.last_solve: Optional[dict] = None
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            chunked = ss.pin_host_memory(chunked)
        self.chunked = chunked
        self._pinned = ss.pin_chunks(chunked, pin_device_chunks, self.device)
        self.stream = ss.ChunkStream(chunked, self.device, prefetch_depth,
                                     self._pinned)
        self._vg = ss.make_value_and_gradient(loss, chunked,
                                              stream=self.stream)
        # Value-only pass for the Armijo probes: rejected steps skip the
        # gradient half of the chunk pass.
        self._v = ss.make_value_only(loss, chunked, stream=self.stream)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # Pinning the host memory and placing the pinned chunks.
        self.pin_seconds = time.perf_counter() - t0
        self.staging_seconds: Optional[float] = None  # set by stage()
        self._padded_n = chunked.num_chunks * chunked.chunk_rows
        # Mid-optimization checkpoint binding (game/descent.py wires the
        # checkpoint manager's per-step stream directory through here).
        self._ckpt_store = None
        self._ckpt_step = None

    @classmethod
    def stage(
        cls,
        dataset,
        shard_id: str,
        loss: PointwiseLoss,
        config: GLMOptimizationConfiguration,
        mesh,
        streaming,
        default_dtype: Optional[str] = None,
        log=lambda m: None,
        device: Optional[DeviceLike] = None,
    ) -> "StreamingSparseFixedEffectCoordinate":
        """Build the coordinate from a GameDataset's SparseShard: slice the
        shard into zero-offset row chunks and canonicalize them into the
        hot-dense/cold-ELL layout (``workers``-parallel, bit-identical to
        the serial pass): the estimator's route onto the streamed path.
        ``streaming`` is an ``api/configs.StreamingConfig``; its
        ``feature_dtype=None`` inherits ``default_dtype``."""
        if mesh is not None:
            raise not_ported("a mesh for the streamed fixed effect (chunk "
                             "ranges sharded over devices)", 9)
        # Refuse an unported option before the staging work, not after.
        _validate_streaming_config(config, streaming.solver)
        dtype = ss.feature_dtype_name(
            streaming.feature_dtype or default_dtype or "float32")
        shard = dataset.feature_shards[shard_id]
        n = int(shard.indices.shape[0])
        workers = streaming.workers or os.cpu_count() or 1
        num_chunks = (n + streaming.chunk_rows - 1) // streaming.chunk_rows
        emitter = ev_mod.default_emitter
        emitter.emit(ev_mod.StreamStageStart(
            shard_id=shard_id, num_rows=n,
            chunk_rows=streaming.chunk_rows, num_chunks=num_chunks,
            workers=workers))
        t0 = time.perf_counter()
        chunked = None
        try:
            chunked = ss.build_chunked(
                ss.iter_shard_chunks(shard, dataset.response,
                                     dataset.weights, streaming.chunk_rows),
                int(shard.num_features), streaming.chunk_rows,
                num_hot=streaming.num_hot, feature_dtype=dtype,
                workers=workers, log=log)
        finally:
            # Balanced lifecycle: a staging failure still closes the
            # scope for listeners tracking it (the obs bridge's span).
            emitter.emit(ev_mod.StreamStageFinish(
                shard_id=shard_id,
                num_chunks=chunked.num_chunks if chunked else 0,
                seconds=time.perf_counter() - t0))
        staging_s = time.perf_counter() - t0
        coord = cls(
            dataset, chunked, shard_id, loss, config,
            intercept_index=dataset.intercept_index.get(shard_id),
            prefetch_depth=streaming.prefetch_depth,
            pin_device_chunks=streaming.pin_chunks,
            solver=streaming.solver, log=log, device=device)
        # Host canonicalization of every chunk.
        coord.staging_seconds = staging_s
        return coord

    def with_optimization_config(
        self, config: GLMOptimizationConfiguration
    ) -> "StreamingSparseFixedEffectCoordinate":
        """Same staged chunk stream, new optimization config (the
        estimator's grid swap; staging is the expensive part)."""
        _validate_streaming_config(config, self.solver)
        c = copy.copy(self)
        c.config = config
        c.last_solve = None
        c._ckpt_store = None
        c._ckpt_step = None
        return c

    @property
    def dim(self) -> int:
        return self.chunked.dim

    # -- mid-optimization checkpointing -----------------------------------

    def bind_step_checkpoint(self, directory: str, step: int) -> None:
        """Arm mid-L-BFGS checkpointing for the NEXT train_model call
        (game/descent.py binds one directory per descent step)."""
        self._ckpt_store = StreamingStateStore(directory)
        self._ckpt_step = step

    def clear_step_checkpoint(self) -> None:
        """Drop the committed step's mid-step state (descent calls this
        after the step-level checkpoint commits: stale stream state must
        not leak into a later step's resume)."""
        if self._ckpt_store is not None:
            self._ckpt_store.clear()
        self._ckpt_store = None
        self._ckpt_step = None

    def _stream_fingerprint(self, offsets: Tensor, w0: Tensor,
                            solver: str) -> dict:
        """What a mid-step snapshot must agree on to be resumable: the
        step, the optimizer config, the solver, and digests of the
        residual offsets and the warm start (the objective the snapshot
        was taken under). The reference's dict, key for key."""
        h = hashlib.sha1()
        h.update(np.ascontiguousarray(offsets.cpu().numpy()).tobytes())
        h.update(np.ascontiguousarray(w0.cpu().numpy()).tobytes())
        return {
            "step": self._ckpt_step,
            "shard": self.shard_id,
            "config": _jsonable(self.config),
            "dim": self.dim,
            "solver": solver,
            "objective_digest": h.hexdigest(),
        }

    def _pad_offsets(self, offsets) -> Tensor:
        offsets = torch.as_tensor(offsets, dtype=torch.float32,
                                  device=self.device)
        pad = self._padded_n - offsets.shape[0]
        if pad:
            offsets = torch.cat([offsets, offsets.new_zeros(pad)])
        return offsets

    def train_model(self, offsets,
                    initial: Optional[FixedEffectModel] = None
                    ) -> FixedEffectModel:
        w0 = (initial.coefficients.means.to(self.device)
              if initial is not None
              else torch.zeros(self.dim, dtype=torch.float32,
                               device=self.device))
        off = self._pad_offsets(offsets)
        mask = torch.as_tensor(intercept_mask(self.dim, self.intercept_index),
                               device=self.device)
        l2 = self.config.regularization.l2_weight()
        l1 = self.config.regularization.l1_weight()
        vg = with_l2(lambda w: self._vg(w, off), l2, mask)
        v = with_l2_value(lambda w: self._v(w, off), l2, mask)
        l1w = (l1_weights_vector(l1, self.dim, self.intercept_index,
                                 device=self.device) if l1 else None)
        checkpoint_save = None
        resume_state = None
        if self._ckpt_store is not None:
            store = self._ckpt_store
            fp = self._stream_fingerprint(off, w0, self.solver)
            resume_state = store.load(expected_fingerprint=fp)
            if resume_state is not None:
                self._log(f"resuming streamed fit from iteration "
                          f"{int(resume_state['it'])} checkpoint")

            def checkpoint_save(state, _store=store, _fp=fp):
                _store.save(state, fingerprint=_fp)

        before = dict(self.stream.passes)
        result = minimize_streaming(vg, w0, self.config.optimizer,
                                    log=self._log, value_only=v,
                                    checkpoint_save=checkpoint_save,
                                    resume_state=resume_state,
                                    l1_weights=l1w)
        # Every pass of the fit has been read on the host by now: record
        # its device-timed copies (no wait).
        self.stream.flush_timings()
        passes = {k: self.stream.passes[k] - before[k] for k in before}
        self.last_solve = {
            # The streamed solve runs L-BFGS, or OWL-QN under L1, whatever
            # the configured optimizer type (as in the reference).
            "optimizer": "OWLQN" if l1 > 0.0 else "LBFGS",
            "iterations": int(result.iterations),
            "converged": bool(result.converged),
            "gradient_evaluations": passes["value_grad"],
            "value_evaluations": passes["value"]}
        return FixedEffectModel(shard_id=self.shard_id,
                                coefficients=Coefficients(result.w))

    def score(self, model: FixedEffectModel) -> Tensor:
        """(n,) wᵀx margins, streamed (chunks staged with zero offsets)."""
        return ss.margins_chunked(
            self.chunked, model.coefficients.means.to(self.device),
            stream=self.stream)

    def initial_model(self) -> FixedEffectModel:
        return FixedEffectModel(
            shard_id=self.shard_id,
            coefficients=Coefficients.zeros(self.dim, device=self.device))
