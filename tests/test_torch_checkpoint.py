"""Checkpoints and resume in the port, against themselves and the
reference.

Mirrors ``tests/test_checkpoint.py`` (kill-and-resume, an atomic save over
an existing checkpoint, the estimator's grid resume, a discard on a
config change, resume with down-sampling) on the port's CPU path, where a
resumed run must equal its own uninterrupted run bit for bit (tighter
than the reference's rtol 1e-4: the saved residual total continues the
exact float32 chain, and the port's CPU ops are deterministic). Then:

- corruption of one generation falls back to ``.prev`` and emits
  ``CheckpointRecovered``; the resumed run still lands on the same bits;
- cross-package: a checkpoint written by the JAX package's
  ``CheckpointManager`` after 2 of 4 updates loads in the port with the
  same models (bit for bit), ``done_steps``, records and residual total,
  and the port resumes it without retraining those updates; the reverse
  holds too; both packages' ``_fingerprint`` dicts are equal;
- the streamed coordinate's mid-step state: a ``StreamingStateStore``
  round trip, a torn meta falling back to ``.prev``, a killed streamed fit
  resuming to the same bits, and the descent binding one directory per
  step and clearing it after the step commits.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from photon_ml_torch.api.configs import (CoordinateConfiguration,
                                         FixedEffectDataConfiguration,
                                         RandomEffectDataConfiguration,
                                         StreamingConfig)
from photon_ml_torch.api.estimator import GameEstimator
from photon_ml_torch.data import sparse, synthetic
from photon_ml_torch.data.game_data import from_sparse_batch, from_synthetic
from photon_ml_torch.game import descent
from photon_ml_torch.game.checkpoint import (CheckpointManager,
                                             StreamingStateStore)
from photon_ml_torch.game.coordinates import \
    StreamingSparseFixedEffectCoordinate
from photon_ml_torch.ops import losses
from photon_ml_torch.optim import OptimizerConfig
from photon_ml_torch.optim.problem import GLMOptimizationConfiguration
from photon_ml_torch.optim.regularization import (RegularizationContext,
                                                  RegularizationType)
from photon_ml_torch.types import TaskType
from photon_ml_torch.utils import events
from photon_ml_tpu.api import configs as ref_configs
from photon_ml_tpu.api.estimator import GameEstimator as RefEstimator
from photon_ml_tpu.data import synthetic as ref_synthetic
from photon_ml_tpu.data.game_data import from_synthetic as ref_from_synthetic
from photon_ml_tpu.game import checkpoint as ref_checkpoint
from photon_ml_tpu.game import descent as ref_descent
from photon_ml_tpu.optim import OptimizerConfig as RefOptimizerConfig
from photon_ml_tpu.optim.problem import \
    GLMOptimizationConfiguration as RefGLMConfig
from photon_ml_tpu.parallel.mesh import make_mesh
from photon_ml_tpu.types import TaskType as RefTaskType

SEED = 12345
SEQ = ["fixed", "per-user"]
TASK = TaskType.LOGISTIC_REGRESSION


def _data(module, from_syn, n=600, re_specs=None):
    return from_syn(module.game_data(
        np.random.default_rng(SEED), n=n, d_global=6,
        re_specs={"userId": (12, 3)} if re_specs is None else re_specs))


def _opt(iterations=40, rate=1.0):
    return GLMOptimizationConfiguration(
        optimizer=OptimizerConfig(max_iterations=iterations, tolerance=1e-7),
        down_sampling_rate=rate)


def _setup(iterations=2):
    """The reference test's GAME fixture: a fixed effect and a per-user
    random effect, 2 outer iterations, 4 updates."""
    ds = _data(synthetic, from_synthetic)
    opt = _opt()
    cc = {"fixed": CoordinateConfiguration(
              FixedEffectDataConfiguration("global"), opt),
          "per-user": CoordinateConfiguration(
              RandomEffectDataConfiguration("userId", "re_userId"), opt)}
    est = GameEstimator(TASK, cc, SEQ, device="cpu",
                        descent_iterations=iterations)
    coords = est._build_coordinates(ds, {c: opt for c in cc})
    return coords, descent.CoordinateDescentConfig(SEQ, iterations)


def _ref_setup():
    ds = _data(ref_synthetic, ref_from_synthetic)
    opt = RefGLMConfig(optimizer=RefOptimizerConfig(max_iterations=40,
                                                    tolerance=1e-7))
    cc = {"fixed": ref_configs.CoordinateConfiguration(
              ref_configs.FixedEffectDataConfiguration("global"), opt),
          "per-user": ref_configs.CoordinateConfiguration(
              ref_configs.RandomEffectDataConfiguration("userId",
                                                        "re_userId"), opt)}
    est = RefEstimator(RefTaskType.LOGISTIC_REGRESSION, cc, SEQ,
                       make_mesh(), descent_iterations=2)
    coords = est._build_coordinates(ds, {c: opt for c in cc})
    return coords, ref_descent.CoordinateDescentConfig(SEQ, iterations=2)


class Killed(Exception):
    """A simulated kill (an exception of its own: an interrupt escaping a
    test would stop the whole pytest run)."""


class _KillSwitch:
    """Proxy a coordinate; raise after ``allow`` train_model calls."""

    def __init__(self, inner, allow):
        self._inner = inner
        self._allow = allow
        self.calls = 0

    def train_model(self, offsets, initial=None):
        self.calls += 1
        if self.calls > self._allow:
            raise Killed("simulated kill")
        return self._inner.train_model(offsets, initial=initial)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _means(m) -> np.ndarray:
    """A coordinate model's coefficient table as host numpy (either
    package)."""
    t = m.means if hasattr(m, "means") else m.coefficients.means
    return (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t))


def _arrays(model) -> dict:
    return {cid: _means(m) for cid, m in model.models.items()}


def _assert_same_bits(a: dict, b: dict):
    assert a.keys() == b.keys()
    for cid in a:
        assert a[cid].dtype == b[cid].dtype and \
            a[cid].tobytes() == b[cid].tobytes(), cid


def _kill(coords, cfg, directory, allow, victim="fixed"):
    manager = CheckpointManager(directory)
    killed = dict(coords)
    killed[victim] = _KillSwitch(coords[victim], allow)
    with pytest.raises(Killed):
        descent.run(TASK, killed, cfg, checkpoint_manager=manager)
    return manager


def test_kill_and_resume_is_bit_exact(tmp_path):
    coords, cfg = _setup()
    clean_model, clean_hist = descent.run(TASK, coords, cfg)
    manager = _kill(coords, cfg, str(tmp_path / "ckpt"), allow=1)
    state = manager.load(device="cpu")
    assert state is not None and not state.complete
    assert state.done_steps == 2  # iter-0 fixed + iter-0 per-user
    assert state.residual_total.dtype == np.float32
    assert state.residual_total.shape == (coords["fixed"].dataset.num_rows,)

    resumed_model, resumed_hist = descent.run(
        TASK, coords, cfg, checkpoint_manager=manager)
    assert len(resumed_hist.records) == len(clean_hist.records)
    _assert_same_bits(_arrays(resumed_model), _arrays(clean_model))

    final = manager.load(device="cpu")
    assert final.complete and final.done_steps == 4
    # A third run short-circuits entirely (no training calls).
    counter = _KillSwitch(coords["fixed"], allow=0)
    again, _ = descent.run(TASK, {**coords, "fixed": counter}, cfg,
                           checkpoint_manager=CheckpointManager(
                               str(tmp_path / "ckpt")))
    assert counter.calls == 0
    _assert_same_bits(_arrays(again), _arrays(resumed_model))


def test_resumed_residual_total_continues_the_chain(tmp_path):
    """The restored (n,) total is the saved bits, not a re-sum: the
    final checkpoint's total equals the uninterrupted run's."""
    coords, cfg = _setup()
    full = CheckpointManager(str(tmp_path / "full"))
    descent.run(TASK, coords, cfg, checkpoint_manager=full)
    manager = _kill(coords, cfg, str(tmp_path / "killed"), allow=1)
    descent.run(TASK, coords, cfg, checkpoint_manager=manager)
    a, b = full.load(device="cpu").residual_total, manager.load(device="cpu").residual_total
    assert a.tobytes() == b.tobytes()


def test_checkpoint_save_is_atomic_over_existing(tmp_path):
    coords, cfg = _setup()
    manager = CheckpointManager(str(tmp_path / "ckpt"))
    model, hist = descent.run(TASK, coords, cfg, checkpoint_manager=manager)
    first = manager.load(device="cpu")
    manager.save(TASK, model.models, done_steps=99, records=hist.records,
                 complete=True)
    second = manager.load(device="cpu")
    assert second.done_steps == 99
    assert set(second.models) == set(first.models)
    assert second.residual_total is None  # this save carried none
    assert not os.path.exists(tmp_path / "ckpt" / "residuals.npz")


def test_estimator_checkpoint_dir_resumes_grid(tmp_path):
    ds = _data(synthetic, from_synthetic, n=400, re_specs={})
    opt = dataclasses.replace(_opt(30), regularization=RegularizationContext(
        RegularizationType.L2, 1.0))
    cc = {"fixed": CoordinateConfiguration(
        FixedEffectDataConfiguration("global"), opt,
        reg_weight_grid=(0.1, 10.0))}
    est = GameEstimator(TASK, cc, ["fixed"], device="cpu")
    r1 = est.fit(ds, checkpoint_dir=str(tmp_path / "ck"))
    assert (tmp_path / "ck" / "grid-0" / "state.json").exists()
    assert (tmp_path / "ck" / "grid-1" / "state.json").exists()
    # A second fit resumes every grid point from its complete checkpoint.
    r2 = est.fit(ds, checkpoint_dir=str(tmp_path / "ck"))
    for a, b in zip(r1, r2):
        _assert_same_bits(_arrays(a.model), _arrays(b.model))
    # The grid points trained different models.
    assert not np.array_equal(_arrays(r1[0].model)["fixed"],
                              _arrays(r1[1].model)["fixed"])


def test_checkpoint_discarded_on_config_change(tmp_path):
    coords, cfg = _setup()
    manager = CheckpointManager(str(tmp_path / "ckpt"))
    descent.run(TASK, coords, cfg, checkpoint_manager=manager)
    assert manager.load(device="cpu").complete
    cfg2 = descent.CoordinateDescentConfig(SEQ, iterations=1)
    counter = _KillSwitch(coords["fixed"], allow=10)
    descent.run(TASK, {**coords, "fixed": counter}, cfg2,
                checkpoint_manager=manager)
    assert counter.calls == 1  # it retrained instead of short-circuiting


@pytest.mark.parametrize("hybrid", [None, False, True])
def test_kill_and_resume_with_down_sampling(tmp_path, hybrid):
    """Resume fast-forwards each coordinate's generator, so the remaining
    steps draw the subsets of the uninterrupted run: the same bits. The
    dense fixed effect (``hybrid=None``) and the sparse one on ELL and on
    the hybrid layout."""
    if hybrid is None:
        ds = _data(synthetic, from_synthetic, n=800, re_specs={})
        data = FixedEffectDataConfiguration("global")
    else:
        b, _ = sparse.synthetic_sparse(1000, 40, 6, seed=3)
        ds = from_sparse_batch(b)
        data = FixedEffectDataConfiguration("global", hybrid=hybrid)
    opt = _opt(rate=0.5)
    est = GameEstimator(TASK, {"fixed": CoordinateConfiguration(data, opt)},
                        ["fixed"], device="cpu", descent_iterations=3)
    cfg = descent.CoordinateDescentConfig(["fixed"], iterations=3)
    clean, _ = descent.run(TASK, est._build_coordinates(ds, {"fixed": opt}),
                           cfg)
    coords = est._build_coordinates(ds, {"fixed": opt})
    manager = _kill(coords, cfg, str(tmp_path / "ckpt"), allow=2)
    assert manager.load(device="cpu").done_steps == 2
    resumed, _ = descent.run(TASK,
                             est._build_coordinates(ds, {"fixed": opt}),
                             cfg, checkpoint_manager=manager)
    _assert_same_bits(_arrays(resumed), _arrays(clean))


def test_corrupt_generation_falls_back_to_prev(tmp_path):
    coords, cfg = _setup()
    clean_model, _ = descent.run(TASK, coords, cfg)
    manager = _kill(coords, cfg, str(tmp_path / "ckpt"), allow=1)
    # Bit rot in the newest generation's per-user coefficients (written
    # by step 2); step 1's generation survives as .prev.
    path = tmp_path / "ckpt" / "model" / "random-effect" / "per-user" / \
        "coefficients.npz"
    assert os.path.exists(str(path) + ".prev")
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    path.write_bytes(bytes(raw))
    seen = []
    events.default_emitter.register(seen.append)
    try:
        state = CheckpointManager(str(tmp_path / "ckpt")).load(device="cpu")
    finally:
        events.default_emitter.unregister(seen.append)
    assert state.recovered and state.done_steps == 1
    recovered = [e for e in seen if isinstance(e, events.CheckpointRecovered)]
    assert len(recovered) == 1 and recovered[0].done_steps == 1
    assert "CRC" in recovered[0].reason
    # The lost step retrains on resume, to the same bits.
    resumed, _ = descent.run(TASK, coords, cfg, checkpoint_manager=manager)
    _assert_same_bits(_arrays(resumed), _arrays(clean_model))


def test_both_generations_corrupt_trains_from_scratch(tmp_path):
    coords, cfg = _setup()
    _kill(coords, cfg, str(tmp_path / "ckpt"), allow=1)
    for name in ("state.json", "state.json.prev"):
        (tmp_path / "ckpt" / name).write_text("{torn")
    assert CheckpointManager(str(tmp_path / "ckpt")).load(device="cpu") is None


def test_descent_emits_lifecycle_events(tmp_path):
    coords, cfg = _setup()
    seen = []
    events.default_emitter.register(seen.append)
    try:
        descent.run(TASK, coords, cfg)
    finally:
        events.default_emitter.unregister(seen.append)
    kinds = [type(e).__name__ for e in seen]
    assert kinds == ["TrainingStart"] + ["CoordinateUpdate"] * 4 + \
        ["TrainingFinish"]
    assert seen[0].update_sequence == tuple(SEQ) and seen[0].iterations == 2
    assert [(e.iteration, e.coordinate) for e in seen[1:5]] == \
        [(0, "fixed"), (0, "per-user"), (1, "fixed"), (1, "per-user")]
    assert seen[-1].total_updates == 4


def test_sweep_is_not_ported():
    coords, cfg = _setup()
    with pytest.raises(NotImplementedError, match="slice 8"):
        descent.run(TASK, coords, cfg, sweep=object())


# -- across packages ---------------------------------------------------------

def test_fingerprints_agree_across_packages():
    coords, cfg = _setup()
    ref_coords, ref_cfg = _ref_setup()
    n = coords["fixed"].dataset.num_rows
    fp = descent._fingerprint(TASK, coords, SEQ, cfg, set(), n)
    ref_fp = ref_descent._fingerprint(RefTaskType.LOGISTIC_REGRESSION,
                                      ref_coords, SEQ, ref_cfg, set(), n)
    for key in ref_fp:
        assert fp[key] == ref_fp[key], key
    assert fp == ref_fp
    assert json.loads(json.dumps(fp)) == fp
    assert descent._dataset_digest(coords["fixed"].dataset) == \
        ref_descent._dataset_digest(ref_coords["fixed"].dataset)


def _ref_kill(ref_coords, ref_cfg, directory):
    manager = ref_checkpoint.CheckpointManager(directory)
    killed = dict(ref_coords)
    killed["fixed"] = _KillSwitch(ref_coords["fixed"], allow=1)
    with pytest.raises(Killed):
        ref_descent.run(RefTaskType.LOGISTIC_REGRESSION, killed, ref_cfg,
                        checkpoint_manager=manager)
    return manager


def test_reference_checkpoint_loads_and_resumes_in_port(tmp_path):
    ref_coords, ref_cfg = _ref_setup()
    directory = str(tmp_path / "ckpt")
    ref_state = _ref_kill(ref_coords, ref_cfg, directory).load()
    assert ref_state.done_steps == 2
    state = CheckpointManager(directory).load(device="cpu")
    assert state.done_steps == ref_state.done_steps
    assert state.records == ref_state.records
    assert not state.complete and not state.recovered
    assert state.fingerprint == ref_state.fingerprint
    assert state.residual_total.tobytes() == \
        np.asarray(ref_state.residual_total).tobytes()
    _assert_same_bits({c: _means(m) for c, m in state.models.items()},
                      {c: _means(m) for c, m in ref_state.models.items()})
    # The port accepts it (same fingerprint) and trains only the 2
    # remaining updates.
    coords, cfg = _setup()
    fixed = _KillSwitch(coords["fixed"], allow=10)
    model, hist = descent.run(TASK, {**coords, "fixed": fixed}, cfg,
                              checkpoint_manager=CheckpointManager(directory))
    assert fixed.calls == 1 and len(hist.records) == 4
    assert CheckpointManager(directory).load(device="cpu").complete


def test_port_checkpoint_loads_in_reference(tmp_path):
    coords, cfg = _setup()
    directory = str(tmp_path / "ckpt")
    state = _kill(coords, cfg, directory, allow=1).load(device="cpu")
    ref_state = ref_checkpoint.CheckpointManager(directory).load()
    assert ref_state.done_steps == state.done_steps == 2
    assert ref_state.records == state.records
    assert ref_state.fingerprint == state.fingerprint
    assert np.asarray(ref_state.residual_total).tobytes() == \
        state.residual_total.tobytes()
    _assert_same_bits({c: _means(m) for c, m in state.models.items()},
                      {c: _means(m) for c, m in ref_state.models.items()})
    # The reference accepts it too: its fingerprint is the port's.
    ref_coords, ref_cfg = _ref_setup()
    fixed = _KillSwitch(ref_coords["fixed"], allow=10)
    ref_descent.run(RefTaskType.LOGISTIC_REGRESSION,
                    {**ref_coords, "fixed": fixed}, ref_cfg,
                    checkpoint_manager=ref_checkpoint.CheckpointManager(
                        directory))
    assert fixed.calls == 1


# -- the streamed coordinate's mid-step state -------------------------------

N, DIM = 1200, 200


@pytest.fixture(scope="module")
def stream_data():
    b, _ = sparse.synthetic_sparse(N, DIM, 8, seed=21)
    return from_sparse_batch(b)


def _stream_coord(ds, iterations=12):
    return StreamingSparseFixedEffectCoordinate.stage(
        ds, "global", losses.LOGISTIC, _opt(iterations), None,
        StreamingConfig(feature_dtype="int8", chunk_rows=512, num_hot=24,
                        workers=2), device="cpu")


def _snapshot(it, d=4):
    rng = np.random.default_rng(it)
    return {"w": rng.normal(size=d).astype(np.float32),
            "it": np.int32(it), "fv": np.float32(1.5 * it)}


def test_stream_store_round_trip(tmp_path):
    store = StreamingStateStore(str(tmp_path / "s"))
    assert store.load() is None
    store.save(_snapshot(3), fingerprint={"step": 1})
    got = store.load(expected_fingerprint={"step": 1})
    want = _snapshot(3)
    assert got.keys() == want.keys()
    for k in want:
        assert np.asarray(got[k]).tobytes() == np.asarray(want[k]).tobytes()
    assert store.load(expected_fingerprint={"step": 2}) is None
    store.clear()
    assert not os.path.exists(tmp_path / "s")


def test_stream_store_torn_meta_falls_back(tmp_path):
    store = StreamingStateStore(str(tmp_path / "s"))
    store.save(_snapshot(1))
    store.save(_snapshot(2))
    # A kill between the npz and the meta write: a newer npz under the
    # committed meta. The meta's CRC vouches for the .prev npz.
    os.replace(tmp_path / "s" / "stream_meta.json.prev",
               tmp_path / "s" / "stream_meta.json")
    assert int(store.load()["it"]) == 1
    # A torn meta: the previous generation, announced.
    store = StreamingStateStore(str(tmp_path / "t"))
    store.save(_snapshot(1))
    store.save(_snapshot(2))
    (tmp_path / "t" / "stream_meta.json").write_text("{torn")
    seen = []
    events.default_emitter.register(seen.append)
    try:
        assert int(store.load()["it"]) == 1
    finally:
        events.default_emitter.unregister(seen.append)
    assert [type(e).__name__ for e in seen] == ["CheckpointRecovered"]


def test_killed_streamed_fit_resumes_to_same_bits(stream_data, tmp_path):
    off = np.zeros(N, np.float32)
    clean = _stream_coord(stream_data)
    clean.bind_step_checkpoint(str(tmp_path / "clean"), 1)
    w_clean = clean.train_model(off).coefficients.means
    assert clean.last_solve["iterations"] > 6

    victim = _stream_coord(stream_data)
    victim.bind_step_checkpoint(str(tmp_path / "victim"), 1)
    store = victim._ckpt_store
    save, saves = store.save, []

    def failing_save(state, **kw):
        if len(saves) == 5:
            raise Killed("simulated kill")
        saves.append(int(state["it"]))
        save(state, **kw)

    store.save = failing_save
    with pytest.raises(Killed):
        victim.train_model(off)
    store.save = save
    assert saves == [1, 2, 3, 4, 5]
    before = dict(victim.stream.passes)
    w = victim.train_model(off).coefficients.means
    assert w.numpy().tobytes() == w_clean.numpy().tobytes()
    # The resumed leg starts at iteration 6: no initial pass.
    resumed = {k: victim.stream.passes[k] - before[k] for k in before}
    assert resumed["value_grad"] == \
        clean.last_solve["gradient_evaluations"] - 6
    # Other residuals: the snapshot is discarded, the fit starts over.
    other = np.full(N, 0.25, np.float32)
    fresh = _stream_coord(stream_data).train_model(other)
    assert victim.train_model(other).coefficients.means.numpy().tobytes() \
        == fresh.coefficients.means.numpy().tobytes()


def test_descent_binds_and_clears_stream_state(stream_data, tmp_path):
    coord = _stream_coord(stream_data, iterations=6)
    bound, cleared = [], []
    bind, clear = coord.bind_step_checkpoint, coord.clear_step_checkpoint

    def spy_bind(directory, step):
        bound.append((os.path.basename(directory), step))
        bind(directory, step)

    def spy_clear():
        cleared.append(os.path.isdir(coord._ckpt_store.directory))
        clear()

    coord.bind_step_checkpoint, coord.clear_step_checkpoint = \
        spy_bind, spy_clear
    cfg = descent.CoordinateDescentConfig(["fixed"], iterations=2)
    manager = CheckpointManager(str(tmp_path / "ckpt"))
    descent.run(TASK, {"fixed": coord}, cfg, checkpoint_manager=manager)
    assert bound == [("stream-step-1", 1), ("stream-step-2", 2)]
    assert cleared == [True, True]  # each step wrote state, then dropped it
    assert not [p for p in os.listdir(tmp_path / "ckpt")
                if p.startswith("stream-step")]
    assert coord._ckpt_store is None
    assert manager.load(device="cpu").complete


def test_load_defaults_to_cuda(tmp_path):
    """Without CUDA, loading a checkpoint raises unless the caller asks
    for the CPU: nothing drops silently to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the refusal needs its absence")
    coords, cfg = _setup(iterations=1)
    manager = CheckpointManager(str(tmp_path / "ckpt"))
    descent.run(TASK, coords, cfg, checkpoint_manager=manager)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        manager.load()
    assert manager.load(device="cpu").complete
