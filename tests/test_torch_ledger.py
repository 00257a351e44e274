"""The port's run ledger and convergence watchdogs, against themselves and
the reference.

Carries over ``tests/test_ledger.py`` against ``photon_ml_torch.obs``:
ledger integrity (round trip, torn tail, row and manifest CRCs, identity
reset), curves and time-to-target, the watchdog detectors and their
config DSL, the streamed L-BFGS's live ``opt_iter`` rows, a poisoned
objective dying with the defined ``WatchdogError`` while the ledger
survives, the early stop, and the estimator's ``ledger_dir``. The
reference's ``game_train`` cases become estimator fits (the GAME CLIs
are not ported yet): a two-seed diff, a fit over other data replacing
a stale ledger, and a fit killed mid-descent whose rerun appends.

Then the same small fits in both packages, in this process, traced and
with a ledger (a fixed effect and a per-user random effect with
checkpoints, and a streamed int8 fixed effect): equal span-name and
parent-name multisets, the same ``identity_of``, ``opt_iter`` values
within the slice's 5e-3 band; and cross-reading: each package's
``cli/obs`` verifies, summarizes, tails and diffs the other's files, a
ledger started by either resume-appends in the other, and the diff of
the two packages' ledgers shows no config delta beyond versions.
"""

import collections
import os
import shutil

import numpy as np
import pytest
import torch

import photon_ml_torch
from photon_ml_torch import obs
from photon_ml_torch.cli import obs as obs_cli
from photon_ml_torch.obs.ledger import (LedgerError, RunLedger,
                                        build_manifest, config_delta,
                                        convergence_curves, diff_ledgers,
                                        identity_of, read_manifest,
                                        read_rows, spill_history,
                                        time_to_fraction, time_to_target,
                                        verify_ledger)
from photon_ml_torch.obs.watchdog import (ConvergenceWatchdog,
                                          WatchdogConfig, WatchdogError,
                                          parse_watchdog_config)
from photon_ml_torch.utils import events as ev

FP = {"task": "LOGISTIC_REGRESSION", "sequence": ["fixed"],
      "iterations": 1, "locked": [], "num_rows": 100,
      "data_digest": "abc123", "coordinates": {"fixed": {"config": {}}}}
TOL = 5e-3
# Spans of reference paths that the port does not have yet: the sharded
# stream's partial merge (slice 9). The reference's streamed estimator
# route runs on its mesh even with one device.
UNPORTED_SPANS = {"stream.psum_merge"}


@pytest.fixture(autouse=True)
def _clean_obs_state():
    """Ledger/watchdog globals must never leak across tests."""
    yield
    obs.set_ledger(None)
    obs.set_watchdog(None)
    obs.disable()


# ---------------------------------------------------------------- core IO


def test_ledger_round_trip_and_verify(tmp_path):
    d = str(tmp_path / "run")
    led = RunLedger.resume(d, manifest=build_manifest(config={"k": 1}))
    led.bind_fingerprint(FP)
    with led.bound(coordinate="fixed", step=1):
        for i in range(1, 5):
            led.record("opt_iter", iteration=i, value=10.0 / i,
                       grad_norm=1.0 / i, seconds=0.01,
                       value_passes=1, grad_passes=1)
    led.close()
    rows, problems = read_rows(d)
    assert problems == []
    assert [r["seq"] for r in rows] == list(range(5))  # + run_end
    assert rows[-1]["kind"] == "run_end"
    assert all(rows[i]["t"] <= rows[i + 1]["t"]
               for i in range(len(rows) - 1))
    assert rows[0]["coordinate"] == "fixed"  # bound context rode along
    assert verify_ledger(d) == []
    manifest = read_manifest(d)
    assert manifest["identity"] == identity_of(FP)
    assert manifest["versions"]["torch"] == torch.__version__
    # The package's own key, where the reference records its own.
    assert manifest["versions"][photon_ml_torch.__name__] == "dev"


def test_torn_tail_keeps_clean_prefix_and_resume_repairs(tmp_path):
    d = str(tmp_path / "run")
    led = RunLedger.resume(d)
    led.bind_fingerprint(FP)
    for i in range(3):
        led.record("opt_iter", iteration=i + 1, value=float(3 - i),
                   grad_norm=0.1)
    led.flush()
    run_id = led.manifest["run_id"]
    # The kill shape: the process dies mid-append — no close(), half a
    # final line on disk.
    with open(led.telemetry_path, "a") as f:
        f.write('{"seq": 3, "kind": "opt_it')
    rows, problems = read_rows(d)
    assert len(rows) == 3 and problems  # clean prefix + reported tear
    led2 = RunLedger.resume(d)
    led2.bind_fingerprint(FP)
    led2.record("opt_iter", iteration=4, value=0.5, grad_norm=0.05)
    led2.close()
    rows2, problems2 = read_rows(d)
    assert problems2 == []
    assert [r["seq"] for r in rows2] == list(range(5))
    assert read_manifest(d)["run_id"] == run_id
    assert rows2[3]["t"] >= rows2[2]["t"]  # monotone across the crash


def test_corrupt_row_crc_stops_the_prefix(tmp_path):
    d = str(tmp_path / "run")
    led = RunLedger.resume(d)
    for i in range(4):
        led.record("opt_iter", iteration=i, value=float(i), grad_norm=1.0)
    led.close()
    lines = open(led.telemetry_path).read().splitlines()
    lines[2] = lines[2].replace('"value":2', '"value":7')
    with open(led.telemetry_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    rows, problems = read_rows(d)
    assert len(rows) == 2
    assert any("CRC" in p for p in problems)
    assert verify_ledger(d) != []


def test_manifest_crc_mismatch_is_loud(tmp_path):
    import json

    d = str(tmp_path / "run")
    RunLedger.resume(d).close()
    path = os.path.join(d, "manifest.json")
    body = json.load(open(path))
    body["run_id"] = "f" * 32
    with open(path, "w") as f:
        json.dump(body, f)  # marker CRC now stale
    with pytest.raises(LedgerError):
        read_manifest(d)


def test_identity_mismatch_resets_to_fresh_run(tmp_path):
    d = str(tmp_path / "run")
    led = RunLedger.resume(d)
    led.bind_fingerprint(FP)
    led.record("opt_iter", iteration=1, value=1.0, grad_norm=1.0)
    led.close()
    old_id = led.manifest["run_id"]
    led2 = RunLedger.resume(d)
    led2.bind_fingerprint(dict(FP, data_digest="DIFFERENT"))
    led2.record("opt_iter", iteration=1, value=2.0, grad_norm=1.0)
    led2.close()
    rows, _ = read_rows(d)
    assert [r["kind"] for r in rows] == ["opt_iter", "run_end"]
    assert rows[0]["value"] == 2.0
    assert read_manifest(d)["run_id"] != old_id


def test_grid_and_trial_fingerprints_share_one_identity():
    fp_b = dict(FP, coordinates={"fixed": {"config": {"reg_weight": 9}}})
    assert identity_of(FP) == identity_of(fp_b)
    assert identity_of(dict(FP, data_digest="x")) != identity_of(FP)


def test_curves_spill_and_time_to_target(tmp_path):
    d = str(tmp_path / "run")
    led = RunLedger.resume(d)
    vals = np.array([10.0, 5.0, 2.0, 1.0, np.nan, np.nan])
    gns = np.array([3.0, 2.0, 1.0, 0.5, np.nan, np.nan])
    with led.bound(coordinate="fixed"):
        n = spill_history(led, vals, gns, opt="lbfgs")
    led.close()
    assert n == 4  # NaN padding skipped
    rows, _ = read_rows(d)
    curve = convergence_curves(rows)["fixed"]
    assert [p["value"] for p in curve] == [10.0, 5.0, 2.0, 1.0]
    tt = time_to_target(curve, 2.0)
    assert tt["iteration"] == 2 and tt["value"] == 2.0
    ttf = time_to_fraction(curve, fraction=0.99)
    assert ttf is not None and ttf["target_value"] == pytest.approx(
        1.0 + 0.01 * 9.0)
    assert time_to_target(curve, 0.5) is None  # never got there


# ---------------------------------------------------------------- watchdog


def test_watchdog_nan_raises_defined_error_and_emits_event():
    wd = ConvergenceWatchdog(WatchdogConfig())  # defaults: nan=raise
    seen = []
    ev.default_emitter.register(seen.append)
    try:
        wd.observe(1, 2.0, 1.0, 0.1)  # healthy
        with pytest.raises(WatchdogError) as exc:
            wd.observe(2, float("nan"), 1.0, 0.1)
    finally:
        ev.default_emitter.unregister(seen.append)
    assert exc.value.kind == "nan"
    alerts = [e for e in seen if isinstance(e, ev.WatchdogAlert)]
    assert len(alerts) == 1 and alerts[0].kind == "nan" \
        and alerts[0].action == "raise"


def test_watchdog_nan_writes_ledger_row_before_raising(tmp_path):
    led = RunLedger.resume(str(tmp_path / "run"))
    obs.set_ledger(led)
    wd = ConvergenceWatchdog(WatchdogConfig(), coordinate="fixed")
    with pytest.raises(WatchdogError):
        wd.observe(1, float("inf"), 1.0, 0.1)
    rows, problems = read_rows(led.directory)
    assert problems == []  # partial ledger stays parseable
    assert rows[-1]["kind"] == "watchdog"
    assert rows[-1]["watchdog_kind"] == "nan"


def test_watchdog_stall_stops_after_k_flat_iterations():
    wd = ConvergenceWatchdog(WatchdogConfig(
        nan="off", stall_iterations=3, stall_action="stop"))
    assert wd.observe(1, 5.0, 1.0, 0.1) is None
    assert wd.observe(2, 4.0, 1.0, 0.1) is None  # progress resets
    assert wd.observe(3, 4.0, 1.0, 0.1) is None
    assert wd.observe(4, 4.0, 1.0, 0.1) is None
    assert wd.observe(5, 4.0, 1.0, 0.1) == "stop"


def test_watchdog_divergence_raises_beyond_tolerance():
    wd = ConvergenceWatchdog(WatchdogConfig(
        nan="off", divergence_factor=2.0))
    wd.observe(1, 1.0, 1.0, 0.1)
    wd.observe(2, 0.5, 1.0, 0.1)
    with pytest.raises(WatchdogError) as exc:
        wd.observe(3, 4.0, 1.0, 0.1)  # 4.0 > 0.5 + 2*max(|1|,1)
    assert exc.value.kind == "divergence"


def test_watchdog_slow_iteration_warns_not_raises(caplog):
    import logging

    wd = ConvergenceWatchdog(WatchdogConfig(
        nan="off", iter_seconds_factor=5.0))
    with caplog.at_level(logging.WARNING, "photon_ml_torch.obs"):
        for i in range(1, 5):
            assert wd.observe(i, 1.0 / i, 1.0, 0.1) is None
        assert wd.observe(5, 0.1, 1.0, 10.0) is None  # 100x the EMA
    assert any("slow_iter" in r.message for r in caplog.records)


def test_watchdog_gap_gate_and_non_finite_gap():
    wd = ConvergenceWatchdog(WatchdogConfig(gap_tolerance=1e-3))
    assert wd.observe_gap(1, 0.5) is None
    assert wd.observe_gap(2, 1e-4) == "stop"  # convergence certified
    with pytest.raises(WatchdogError) as exc:
        wd.observe_gap(3, float("nan"))
    assert exc.value.kind == "nan"


def test_parse_watchdog_config():
    assert parse_watchdog_config("") == WatchdogConfig()
    cfg = parse_watchdog_config(
        "nan=warn,stall=8:raise,stall_rtol=1e-6,divergence=3,"
        "slow_iter=10:stop,gap=1e-4")
    assert cfg.nan == "warn"
    assert cfg.stall_iterations == 8 and cfg.stall_action == "raise"
    assert cfg.stall_rtol == 1e-6
    assert cfg.divergence_factor == 3.0
    assert cfg.iter_seconds_factor == 10.0 and cfg.iter_action == "stop"
    assert cfg.gap_tolerance == 1e-4 and cfg.gap_action == "stop"
    with pytest.raises(ValueError):
        parse_watchdog_config("bogus=1")
    with pytest.raises(ValueError):
        parse_watchdog_config("nan=explode")


# ---------------------------------------------- streamed L-BFGS integration


def _quadratic():
    def vg(w):
        return 0.5 * torch.sum(w * w), w

    def v(w):
        return 0.5 * torch.sum(w * w)

    return vg, v


def test_minimize_streaming_records_live_opt_iter_rows(tmp_path):
    from photon_ml_torch.optim.common import OptimizerConfig
    from photon_ml_torch.optim.streaming import minimize_streaming

    led = RunLedger.resume(str(tmp_path / "run"))
    obs.set_ledger(led)
    vg, v = _quadratic()
    with led.bound(coordinate="fixed"):
        res = minimize_streaming(
            vg, torch.ones(4), OptimizerConfig(max_iterations=6,
                                               tolerance=1e-9),
            value_only=v)
    led.close()
    rows, problems = read_rows(led.directory)
    assert problems == []
    iters = [r for r in rows if r["kind"] == "opt_iter"]
    assert len(iters) == int(res.iterations)
    assert [r["iteration"] for r in iters] == \
        list(range(1, len(iters) + 1))
    for r in iters:
        assert r["coordinate"] == "fixed" and r["opt"] == "lbfgs-stream"
        assert r["seconds"] > 0 and r["probes"] >= 1
        assert r["grad_passes"] >= 1  # acceptance gradient pass
    vals = [r["value"] for r in iters]
    assert vals == sorted(vals, reverse=True)


def test_poisoned_objective_dies_with_watchdog_error_ledger_survives(
        tmp_path):
    """The reference's chaos drill, with the objective poisoned directly
    (the port has no fault injector yet): from the second probe on the
    value pass returns NaN; the armed watchdog turns the line-search
    death into the DEFINED WatchdogError; the partial ledger stays
    parseable and resume-appendable."""
    from photon_ml_torch.optim.common import OptimizerConfig
    from photon_ml_torch.optim.streaming import minimize_streaming

    led = RunLedger.resume(str(tmp_path / "run"))
    obs.set_ledger(led)
    obs.set_watchdog(WatchdogConfig())  # nan=raise
    vg, v = _quadratic()
    calls = [0]

    def poisoned(w):
        calls[0] += 1
        return v(w) * (float("nan") if calls[0] >= 2 else 1.0)

    with pytest.raises(WatchdogError) as exc:
        minimize_streaming(vg, torch.ones(4),
                           OptimizerConfig(max_iterations=6,
                                           tolerance=1e-9),
                           value_only=poisoned)
    assert exc.value.kind == "nan"
    rows, _ = read_rows(led.directory)
    assert [r["seq"] for r in rows] == list(range(len(rows)))
    assert rows[-1]["kind"] == "watchdog"
    assert len([r for r in rows if r["kind"] == "opt_iter"]) >= 1
    led.close()
    led2 = RunLedger.resume(led.directory)
    led2.record("opt_iter", iteration=99, value=0.0, grad_norm=0.0)
    led2.close()
    rows2, problems2 = read_rows(led.directory)
    assert problems2 == []
    assert [r["seq"] for r in rows2] == list(range(len(rows2)))


def test_watchdog_early_stop_keeps_partial_result():
    from photon_ml_torch.optim.common import OptimizerConfig
    from photon_ml_torch.optim.streaming import minimize_streaming

    obs.set_watchdog(WatchdogConfig(
        nan="off", stall_iterations=2, stall_action="stop",
        stall_rtol=1.0))  # everything counts as a stall
    res = minimize_streaming(
        lambda w: (0.25 * torch.sum(w ** 4), w ** 3), torch.ones(4),
        OptimizerConfig(max_iterations=50, tolerance=0.0),
        value_only=lambda w: 0.25 * torch.sum(w ** 4))
    assert int(res.iterations) <= 4
    assert not bool(res.converged)


# ---------------------------------------------------------- estimator API


def _game_data(seed, n=200, entities=8):
    from photon_ml_torch.data import synthetic
    from photon_ml_torch.data.game_data import from_synthetic

    return from_synthetic(synthetic.game_data(
        np.random.default_rng(seed), n=n, d_global=6,
        re_specs={"userId": (entities, 3)}))


def _game_estimator(iterations=1, **kw):
    from photon_ml_torch.api.configs import (CoordinateConfiguration,
                                             FixedEffectDataConfiguration,
                                             RandomEffectDataConfiguration)
    from photon_ml_torch.api.estimator import GameEstimator
    from photon_ml_torch.optim import OptimizerConfig
    from photon_ml_torch.optim.problem import GLMOptimizationConfiguration
    from photon_ml_torch.types import TaskType

    opt = GLMOptimizationConfiguration(
        optimizer=OptimizerConfig(max_iterations=40, tolerance=1e-7))
    return GameEstimator(
        TaskType.LOGISTIC_REGRESSION,
        {"fixed": CoordinateConfiguration(
            FixedEffectDataConfiguration("global"), opt),
         "per-user": CoordinateConfiguration(
             RandomEffectDataConfiguration("userId", "re_userId"), opt)},
        ["fixed", "per-user"], device="cpu", descent_iterations=iterations,
        **kw)


def test_estimator_ledger_dir_library_path(tmp_path):
    d = str(tmp_path / "ledger")
    _game_estimator(ledger_dir=d).fit(_game_data(3, n=128))
    assert verify_ledger(d) == []
    rows, _ = read_rows(d)
    kinds = collections.Counter(r["kind"] for r in rows)
    assert kinds["opt_iter"] >= 1 and kinds["coordinate_update"] == 2
    assert kinds["re_fit_wave"] >= 1
    assert rows[-1]["kind"] == "run_end" and rows[-1]["status"] == "ok"
    assert obs.ledger() is None  # deactivated after fit
    waves = [r for r in rows if r["kind"] == "re_fit_wave"]
    assert all(r["coordinate"] == "per-user" and r["entities_fit"] > 0
               for r in waves)


def test_two_seed_diff_renders_time_to_target(tmp_path):
    ledgers = []
    for seed in (0, 1):
        d = str(tmp_path / f"ledger{seed}")
        _game_estimator(ledger_dir=d).fit(_game_data(seed))
        ledgers.append(d)
    diff = diff_ledgers(*ledgers)
    entry = diff["coordinates"]["fixed"]
    assert entry["time_to_target_a"] is not None
    assert entry["time_to_target_b"] is not None
    assert entry["time_to_target_ratio"] is not None
    text = obs_cli.render_diff(diff)
    assert "time to target" in text and "value vs wall clock" in text
    assert obs_cli.main(["diff", ledgers[0], ledgers[1]]) == 0
    assert obs_cli.main(["verify", ledgers[0]]) == 0
    assert obs_cli.main(["tail", ledgers[0]]) == 0


def test_fit_over_other_data_replaces_the_stale_ledger(tmp_path):
    d = str(tmp_path / "ledger")
    _game_estimator(ledger_dir=d).fit(_game_data(0))
    first = read_manifest(d)["run_id"]
    _game_estimator(ledger_dir=d).fit(_game_data(1))
    # Another dataset is another run: new run id, rows reset.
    assert read_manifest(d)["run_id"] != first
    rows, problems = read_rows(d)
    assert problems == []
    assert sum(r["kind"] == "run_end" for r in rows) == 1


class _Killed(Exception):
    """A simulated kill (an exception of its own: an interrupt escaping
    a test would stop the whole pytest run)."""


def test_fit_killed_mid_descent_keeps_its_prefix_and_resume_appends(
        tmp_path, monkeypatch):
    """The reference's kill-mid-fit drill on the estimator: a fit killed
    at its third update keeps a parseable ledger closed with "error";
    the rerun over the same checkpoint resume-appends under the SAME
    run id, seq contiguous, and closes with "ok"."""
    from photon_ml_torch.game.checkpoint import CheckpointManager

    ds = _game_data(5)
    d, ck = str(tmp_path / "ledger"), str(tmp_path / "ckpt")
    save = CheckpointManager.save
    saves = [0]

    def killing_save(self, *a, **kw):
        saves[0] += 1
        if saves[0] == 3:
            raise _Killed("killed at the third update")
        return save(self, *a, **kw)

    monkeypatch.setattr(CheckpointManager, "save", killing_save)
    with pytest.raises(_Killed):
        _game_estimator(iterations=2, ledger_dir=d).fit(
            ds, checkpoint_dir=ck)
    monkeypatch.setattr(CheckpointManager, "save", save)
    rows, problems = read_rows(d)
    assert problems == []
    assert rows[-1]["kind"] == "run_end" and rows[-1]["status"] == "error"
    killed = read_manifest(d)
    assert killed.get("identity")
    done = [r for r in rows if r["kind"] == "coordinate_update"]
    assert len(done) == 3
    _game_estimator(iterations=2, ledger_dir=d).fit(ds, checkpoint_dir=ck)
    rows2, problems2 = read_rows(d)
    assert problems2 == []
    assert read_manifest(d)["run_id"] == killed["run_id"]
    assert [r["seq"] for r in rows2] == list(range(len(rows2)))
    assert rows2[-1]["kind"] == "run_end" and rows2[-1]["status"] == "ok"
    # The kill struck step 3's checkpoint save, after its row: the
    # resumed leg retrains step 3 (its second row) and runs step 4.
    steps = [r["step"] for r in rows2 if r["kind"] == "coordinate_update"]
    assert steps == [1, 2, 3, 3, 4]


# ------------------------------------------- both packages, one process


def _spans(trace):
    return [e for e in trace["traceEvents"] if e.get("ph") == "X"]


def _name_pairs(trace):
    spans = _spans(trace)
    by_id = {e["args"]["span_id"]: e["name"] for e in spans}
    return collections.Counter(
        (e["name"], by_id.get(e["args"].get("parent_id")))
        for e in spans if e["name"] not in UNPORTED_SPANS)


def _fit_both(root):
    """The two fixtures in each package, traced and with a ledger: a
    GAME fit (fixed + per-user random effect, 2 outer iterations, with
    checkpoints) and a streamed int8 fixed effect (3 chunks)."""
    import jax

    from photon_ml_torch.api import configs as pc
    from photon_ml_torch.api.estimator import GameEstimator
    from photon_ml_torch.data import sparse, synthetic
    from photon_ml_torch.data.game_data import (from_sparse_batch,
                                                from_synthetic)
    from photon_ml_torch.optim import OptimizerConfig
    from photon_ml_torch.optim.problem import GLMOptimizationConfiguration
    from photon_ml_torch.types import TaskType
    from photon_ml_tpu import obs as ref_obs
    from photon_ml_tpu.api import configs as rc
    from photon_ml_tpu.api.estimator import GameEstimator as RefEstimator
    from photon_ml_tpu.data import sparse as ref_sparse
    from photon_ml_tpu.data import synthetic as ref_synthetic
    from photon_ml_tpu.data.game_data import \
        from_sparse_batch as ref_from_sparse_batch
    from photon_ml_tpu.data.game_data import \
        from_synthetic as ref_from_synthetic
    from photon_ml_tpu.optim import OptimizerConfig as RefOptimizerConfig
    from photon_ml_tpu.optim.problem import \
        GLMOptimizationConfiguration as RefGLMConfig
    from photon_ml_tpu.parallel.mesh import make_mesh
    from photon_ml_tpu.types import TaskType as RefTaskType

    n, dim = 1200, 200
    b, _ = ref_sparse.synthetic_sparse(n, dim, 8, seed=21)
    idx, val, y = (np.array(b.indices), np.array(b.values),
                   np.array(b.labels))
    packages = {
        "port": (pc, GameEstimator, OptimizerConfig,
                 GLMOptimizationConfiguration, TaskType, obs,
                 synthetic, from_synthetic, dict(device="cpu"),
                 from_sparse_batch(sparse.SparseBatch(
                     torch.from_numpy(idx), torch.from_numpy(val),
                     torch.from_numpy(y), torch.ones(n), torch.zeros(n),
                     dim))),
        "ref": (rc, RefEstimator, RefOptimizerConfig, RefGLMConfig,
                RefTaskType, ref_obs, ref_synthetic, ref_from_synthetic,
                dict(mesh=make_mesh(num_data=1,
                                    devices=jax.devices()[:1])),
                ref_from_sparse_batch(ref_sparse.SparseBatch(
                    idx, val, y, np.ones(n, np.float32),
                    np.zeros(n, np.float32), dim)))}
    out = {}
    for pkg, (C, Est, OC, GC, TT, pobs, syn, from_syn, kw,
              sparse_ds) in packages.items():
        ds = from_syn(syn.game_data(np.random.default_rng(12345), n=600,
                                    d_global=6,
                                    re_specs={"userId": (12, 3)}))
        opt = GC(optimizer=OC(max_iterations=40, tolerance=1e-7))
        tr = pobs.Tracer()
        game_dir = os.path.join(root, pkg, "game")
        Est(TT.LOGISTIC_REGRESSION,
            {"fixed": C.CoordinateConfiguration(
                C.FixedEffectDataConfiguration("global"), opt),
             "per-user": C.CoordinateConfiguration(
                 C.RandomEffectDataConfiguration("userId", "re_userId"),
                 opt)},
            ["fixed", "per-user"], descent_iterations=2, trace=tr,
            ledger_dir=game_dir, **kw).fit(
                ds, checkpoint_dir=os.path.join(root, pkg, "ckpt"))
        game_trace = os.path.join(root, pkg, "game.json")
        tr.dump(game_trace)
        opt = GC(optimizer=OC(max_iterations=8, tolerance=1e-9))
        tr = pobs.Tracer()
        stream_dir = os.path.join(root, pkg, "stream")
        Est(TT.LOGISTIC_REGRESSION,
            {"ctr": C.CoordinateConfiguration(
                C.FixedEffectDataConfiguration("global", hybrid=False),
                opt)},
            ["ctr"], trace=tr, ledger_dir=stream_dir,
            streaming=C.StreamingConfig(feature_dtype="int8",
                                        chunk_rows=512, num_hot=24,
                                        workers=2), **kw).fit(sparse_ds)
        stream_trace = os.path.join(root, pkg, "stream.json")
        tr.dump(stream_trace)
        out[pkg] = {"game": (game_trace, game_dir),
                    "stream": (stream_trace, stream_dir)}
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return _fit_both(str(tmp_path_factory.mktemp("both")))


@pytest.mark.parametrize("fit", ["game", "stream"])
def test_span_names_and_parents_equal_the_references(both, fit):
    traces = {pkg: obs_cli.load_trace(both[pkg][fit][0])
              for pkg in ("port", "ref")}
    port, ref = (_name_pairs(traces[p]) for p in ("port", "ref"))
    assert port == ref
    names = {n for n, _ in port}
    if fit == "game":
        assert {"estimator.fit", "training", "descent.update",
                "re.fit_wave", "checkpoint.save"} <= names
    else:
        assert {"stream_stage", "stream.pass", "stream.chunk_transfer",
                "lbfgs.iteration", "lbfgs.probe",
                "lbfgs.initial_pass"} <= names
    assert obs_cli.verify_trace(traces["port"]) == []


@pytest.mark.parametrize("fit", ["game", "stream"])
def test_identity_and_opt_iter_rows_match_the_references(both, fit):
    dirs = {pkg: both[pkg][fit][1] for pkg in ("port", "ref")}
    man = {pkg: read_manifest(d) for pkg, d in dirs.items()}
    assert man["port"]["identity"] == man["ref"]["identity"]
    rows = {pkg: read_rows(d)[0] for pkg, d in dirs.items()}
    kinds = {pkg: collections.Counter(r["kind"] for r in rs)
             for pkg, rs in rows.items()}
    assert kinds["port"]["coordinate_update"] == \
        kinds["ref"]["coordinate_update"]
    assert kinds["port"].get("re_fit_wave") == \
        kinds["ref"].get("re_fit_wave")
    curves = {pkg: convergence_curves(rs) for pkg, rs in rows.items()}
    assert set(curves["port"]) == set(curves["ref"])
    for coord in curves["ref"]:
        a, b = curves["port"][coord], curves["ref"][coord]
        # Iteration counts may differ by one (ROADMAP §C); the shared
        # prefix agrees within the slice's band.
        assert abs(len(a) - len(b)) <= 1 + sum(
            r["kind"] == "coordinate_update" and r["coordinate"] == coord
            for r in rows["ref"])
        for pa, pb in zip(a, b):
            assert pa["iteration"] == pb["iteration"]
            assert abs(pa["value"] - pb["value"]) <= \
                TOL * max(1.0, abs(pb["value"]))
    assert config_delta(man["port"], man["ref"]) and all(
        d["key"].startswith("versions.")
        for d in config_delta(man["port"], man["ref"]))


@pytest.mark.parametrize("reader", ["port", "ref"])
def test_each_cli_reads_the_other_packages_files(both, reader, capsys):
    from photon_ml_tpu.cli import obs as ref_cli

    cli = obs_cli if reader == "port" else ref_cli
    other = "ref" if reader == "port" else "port"
    for fit in ("game", "stream"):
        trace, ledger = both[other][fit]
        assert cli.main(["verify", trace]) == 0
        assert cli.main(["summarize", trace]) == 0
        assert cli.main(["verify", ledger]) == 0
        assert cli.main(["tail", ledger]) == 0
        assert cli.main(["diff", both[reader][fit][1], ledger]) == 0
    s = cli.summarize_trace(cli.load_trace(both[other]["stream"][0]))
    assert s["attribution"]["transfer_by_dtype"]["int8"]["chunks"] > 0
    capsys.readouterr()


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_a_ledger_resume_appends_in_the_other_package(both, writer,
                                                      tmp_path):
    """A ledger started by one package resume-appends in the other: the
    other package binds its own descent fingerprint of the same fit (the
    one its checkpoint holds), the identity holds, and rows append."""
    import json

    from photon_ml_tpu.obs.ledger import RunLedger as RefLedger
    from photon_ml_tpu.obs.ledger import read_rows as ref_read_rows

    d = str(tmp_path / "ledger")
    shutil.copytree(both[writer]["game"][1], d)
    before, _ = read_rows(d)
    run_id = read_manifest(d)["run_id"]
    other = "ref" if writer == "port" else "port"
    with open(os.path.join(os.path.dirname(both[other]["game"][1]),
                           "ckpt", "grid-0", "state.json")) as f:
        fp = json.load(f)["fingerprint"]
    led = (RefLedger if writer == "port" else RunLedger).resume(d)
    with led.bound(grid=0):
        led.bind_fingerprint(fp)
    led.record("opt_iter", iteration=1, value=0.5, grad_norm=0.1)
    led.close()
    for reader in (read_rows, ref_read_rows):
        rows, problems = reader(d)
        assert problems == []
        assert [r["seq"] for r in rows] == list(range(len(before) + 2))
        assert rows[-1]["kind"] == "run_end"
        assert rows[-2]["t"] >= before[-1]["t"]
    assert read_manifest(d)["run_id"] == run_id
