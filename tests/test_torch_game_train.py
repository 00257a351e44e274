"""The GAME training driver: ``photon_ml_torch.cli.game_train`` against the
reference CLI.

Both CLIs run on the same files (``--device cpu`` for the port):

* config 4: ``tests/test_cli.py``'s fixture (1,200 synthetic rows, a
  dense global shard and ``userId`` 20 × 4), written by the reference's
  ``save_game_dataset``; a fixed effect and a per-user random effect, L2
  on both, a two-point grid on the fixed effect, ``--output-mode ALL``;
* config 5: a LIBSVM file as one sparse ``global`` shard, fitted with
  ``hybrid=auto``, ``hybrid=false``, ``dtype=bfloat16`` and
  ``--streaming``, with a LIBSVM validation file read into the training
  feature space.

Coefficients and metrics agree within 5e-3 (the band for full solves),
the output trees match (``best/``, ``model-i/``, ``checkpoints/``,
``ledger/``, ``summary.json``'s keys), and each package's best model
scores through the other's ``game_score``. ``python -m
photon_ml_torch.cli.game_train`` fits the same model as the in-process
run, a rerun with ``--resume`` gives the same ``model_digest``, and every
option the port does not have raises ``NotImplementedError`` naming its
slice before any data is read.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from photon_ml_torch import not_ported, obs
from photon_ml_torch.cli import game_score, game_train
from photon_ml_torch.models import io as tio
from photon_ml_tpu.cli import game_score as ref_game_score
from photon_ml_tpu.cli import game_train as ref_game_train
from photon_ml_tpu.data import sparse as ref_sparse
from photon_ml_tpu.data import synthetic as ref_synthetic
from photon_ml_tpu.data.game_data import from_synthetic as ref_from_synthetic
from photon_ml_tpu.data.io import save_game_dataset as ref_save_game_dataset
from photon_ml_tpu.models import io as jio

SOLVE_TOL = 5e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUMMARY_KEYS = {"task", "model_digest", "candidates", "best_metrics",
                "tuning", "ledger", "wall_seconds"}


@pytest.fixture(autouse=True)
def _obs_off_after():
    yield
    obs.disable()


def _config4_files(root):
    """tests/test_cli.py's config-4 fixture, written by the reference."""
    rng = np.random.default_rng(12345)
    n = 1200
    ds = ref_from_synthetic(ref_synthetic.game_data(
        rng, n=n, d_global=8, re_specs={"userId": (20, 4)},
        task="logistic"))
    idx = rng.permutation(n)
    train, val = str(root / "train"), str(root / "val")
    ref_save_game_dataset(ds.subset(idx[:960]), train)
    ref_save_game_dataset(ds.subset(idx[960:]), val)
    return train, val


def _write_libsvm(path, batch, rows):
    """ELL rows as LIBSVM text, one-based, every float32 to 9 digits (it
    reads back exactly)."""
    idx, val = np.asarray(batch.indices), np.asarray(batch.values)
    labels = np.asarray(batch.labels)
    with open(path, "w") as f:
        for i in rows:
            keep = idx[i] < batch.num_features
            feats = " ".join(f"{c + 1}:{v:.9g}"
                             for c, v in zip(idx[i][keep], val[i][keep]))
            f.write(f"{labels[i]:g} {feats}\n")


def _config5_files(root):
    batch, _ = ref_sparse.synthetic_sparse(2000, 300, 16, seed=5)
    train, val = str(root / "train.libsvm"), str(root / "val.libsvm")
    _write_libsvm(train, batch, range(1800))
    _write_libsvm(val, batch, range(1800, 2000))
    return train, val


CONFIG4 = [
    "--coordinate", "name=fixed,type=fixed,shard=global",
    "--coordinate", "name=per-user,type=random,shard=re_userId,re=userId,"
                    "min_samples=2",
    "--update-sequence", "fixed,per-user", "--iterations", "2",
    "--evaluators", "AUC,AUC@userId",
    "--opt-config", "fixed:optimizer=LBFGS,reg=L2,reg_weight=1.0",
    "--opt-config", "per-user:optimizer=LBFGS,reg=L2,reg_weight=1.0",
    "--reg-weight-grid", "fixed:0.5,2.0", "--output-mode", "ALL"]

CONFIG5 = {
    "hybrid_auto": ["--coordinate", "name=ctr,type=fixed,shard=global"],
    "ell": ["--coordinate",
            "name=ctr,type=fixed,shard=global,hybrid=false"],
    "bfloat16": ["--coordinate",
                 "name=ctr,type=fixed,shard=global,dtype=bfloat16"],
    "streaming": ["--coordinate", "name=ctr,type=fixed,shard=global",
                  "--streaming", "chunk_rows=512,num_hot=32"],
}
CONFIG5_COMMON = ["--update-sequence", "ctr",
                  "--evaluators", "AUC,LOGISTIC_LOSS", "--opt-config",
                  "ctr:optimizer=LBFGS,reg=L2,reg_weight=10.0,max_iter=300,"
                  "tolerance=1e-9"]


def _both(tmp_path, train, val, flags):
    """The port's and the reference's run of the same flags."""
    common = ["--train", train, "--validation", val, *flags]
    port_out, ref_out = str(tmp_path / "port"), str(tmp_path / "ref")
    got = game_train.run(game_train.build_parser().parse_args(
        [*common, "--output-dir", port_out, "--device", "cpu"]))
    want = ref_game_train.run(ref_game_train.build_parser().parse_args(
        [*common, "--output-dir", ref_out]))
    return got, want, port_out, ref_out


def _close_metrics(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert abs(got[k] - v) <= SOLVE_TOL, k


def _close_models(port_dir, ref_dir):
    got, want = tio.load_game_model(port_dir), jio.load_game_model(ref_dir)
    assert got.models.keys() == want.models.keys()
    for cid, g in got.models.items():
        w = want.models[cid]
        a = getattr(g, "coefficients", g).means.numpy()
        b = np.asarray(getattr(w, "coefficients", w).means)
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=SOLVE_TOL,
                                   err_msg=cid)


def _tree(out):
    return {"top": sorted(os.listdir(out)),
            "checkpoints": sorted(os.listdir(os.path.join(out,
                                                          "checkpoints"))),
            "best": sorted(os.listdir(os.path.join(out, "best")))}


def _compare_runs(got, want, port_out, ref_out):
    assert set(got) == set(want) == SUMMARY_KEYS
    with open(os.path.join(port_out, "summary.json")) as f:
        assert set(json.load(f)) == SUMMARY_KEYS
    assert got["task"] == want["task"]
    assert got["tuning"] is None and want["tuning"] is None
    assert len(got["candidates"]) == len(want["candidates"])
    for g, w in zip(got["candidates"], want["candidates"]):
        assert g["configs"] == w["configs"]
        _close_metrics(g["metrics"], w["metrics"])
    _close_metrics(got["best_metrics"], want["best_metrics"])
    assert _tree(port_out) == _tree(ref_out)
    assert got["ledger"]["dir"] == os.path.join(port_out, "ledger")
    _close_models(os.path.join(port_out, "best"),
                  os.path.join(ref_out, "best"))
    for i in range(len(want["candidates"])):
        if os.path.isdir(os.path.join(ref_out, f"model-{i}")):
            _close_models(os.path.join(port_out, f"model-{i}"),
                          os.path.join(ref_out, f"model-{i}"))


def _cross_score(tmp_path, data, port_out, ref_out):
    """Each package's best model through the other's game_score, against
    the owner's own scoring."""
    scores = {}
    for tag, cli, model_out, extra in (
            ("port_by_port", game_score, port_out, ["--device", "cpu"]),
            ("port_by_ref", ref_game_score, port_out, []),
            ("ref_by_ref", ref_game_score, ref_out, []),
            ("ref_by_port", game_score, ref_out, ["--device", "cpu"])):
        out = str(tmp_path / f"scores-{tag}")
        cli.run(cli.build_parser().parse_args([
            "--data", data, "--model-dir", os.path.join(model_out, "best"),
            "--output-dir", out, *extra]))
        scores[tag] = np.load(os.path.join(out, "scores.npz"))["score"]
    np.testing.assert_allclose(scores["port_by_ref"], scores["port_by_port"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(scores["ref_by_port"], scores["ref_by_ref"],
                               rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def config4(tmp_path_factory):
    root = tmp_path_factory.mktemp("config4")
    train, val = _config4_files(root)
    got, want, port_out, ref_out = _both(root, train, val, CONFIG4)
    return {"root": root, "train": train, "val": val, "got": got,
            "want": want, "port_out": port_out, "ref_out": ref_out}


def test_config4_matches_reference_cli(config4):
    c = config4
    _compare_runs(c["got"], c["want"], c["port_out"], c["ref_out"])
    assert _tree(c["port_out"])["top"] == [
        "best", "checkpoints", "ledger", "model-0", "model-1",
        "summary.json"]
    assert c["got"]["best_metrics"]["AUC"] > 0.7


def test_config4_best_models_cross_game_score(config4, tmp_path):
    _cross_score(tmp_path, config4["val"], config4["port_out"],
                 config4["ref_out"])


def test_config4_resume_gives_the_same_model_digest(config4):
    c = config4
    first = c["got"]
    again = game_train.run(game_train.build_parser().parse_args(
        ["--train", c["train"], "--validation", c["val"], *CONFIG4,
         "--output-dir", c["port_out"], "--device", "cpu", "--resume"]))
    assert again["model_digest"] == first["model_digest"]
    assert again["ledger"]["run_id"] == first["ledger"]["run_id"]
    assert tio.game_model_digest(tio.load_game_model(
        os.path.join(c["port_out"], "best"))) == first["model_digest"]


def test_module_entry_point_fits_the_same_model(config4, tmp_path):
    """``python -m photon_ml_torch.cli.game_train`` as a user runs it:
    the same model (digest) as the in-process run of the same flags."""
    out = str(tmp_path / "module")
    run = subprocess.run(
        [sys.executable, "-m", "photon_ml_torch.cli.game_train",
         "--train", config4["train"], "--validation", config4["val"],
         *CONFIG4, "--output-dir", out, "--device", "cpu"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    assert summary["model_digest"] == config4["got"]["model_digest"]


@pytest.fixture(scope="module")
def config5_files(tmp_path_factory):
    return _config5_files(tmp_path_factory.mktemp("config5"))


@pytest.mark.parametrize("case", sorted(CONFIG5))
def test_config5_libsvm_matches_reference_cli(config5_files, tmp_path, case):
    train, val = config5_files
    got, want, port_out, ref_out = _both(
        tmp_path, train, val, [*CONFIG5[case], *CONFIG5_COMMON])
    _compare_runs(got, want, port_out, ref_out)
    assert got["best_metrics"]["AUC"] > 0.6
    if case == "hybrid_auto":
        # The LIBSVM validation file scores in the training space, so the
        # other package's game_score reads the model beside a dataset
        # directory of the same rows.
        from photon_ml_torch.cli.game_train import _load_dataset
        from photon_ml_torch.data.io import save_game_dataset

        train_ds = _load_dataset(train)
        data_dir = str(tmp_path / "val-ds")
        save_game_dataset(_load_dataset(
            val, num_features=train_ds.shard_dim("global")), data_dir)
        _cross_score(tmp_path, data_dir, port_out, ref_out)


def _missing(tmp_path):
    return str(tmp_path / "no-such-data")


NOT_PORTED = {
    "tuning_random": ("train", ["--tuning", "RANDOM"], 9),
    "tuning_bayesian": ("train", ["--tuning", "BAYESIAN"], 9),
    "distributed": ("train", ["--distributed"], 9),
    "fabric": ("train", ["--fabric"], 9),
    "ingest": ("train", ["--ingest", "workers=2"], 9),
    "ingest_cache_dir": ("train", ["--ingest-cache-dir", "c"], 9),
    "avro_feature_shard": ("train", ["--avro-feature-shard",
                                     "name=global"], 9),
    "avro_re_types": ("train", ["--avro-re-types", "userId"], 9),
    "feature_index_dir": ("train", ["--feature-index-dir", "m"], 9),
    "date_range": ("train", ["--date-range", "20200101-20200102"], 9),
    "model_output_avro": ("train", ["--model-output-format", "AVRO"], 10),
    "model_output_both": ("train", ["--model-output-format", "BOTH"], 10),
    "fault_plan": ("train", ["--fault-plan", "plan.json"], 10),
    "sweep": ("train", ["--sweep"], 8),
    "sweep_spec": ("train", ["--sweep", "theta=1e-4"], 8),
    "factored": ("train", ["--coordinate",
                           "name=f,type=factored,shard=re_userId,re=userId"],
                 8),
    "projector_random": ("train", [
        "--coordinate", "name=r,type=random,shard=re_userId,re=userId,"
                        "projector=RANDOM,projected_dim=2"], 8),
    "score_avro_feature_shard": ("score", ["--avro-feature-shard",
                                           "name=global"], 9),
    "score_avro_re_types": ("score", ["--avro-re-types", "userId"], 9),
    "score_feature_index_dir": ("score", ["--feature-index-dir", "m"], 9),
    "score_ingest": ("score", ["--ingest", "workers=2"], 9),
    "score_model_format_avro": ("score", ["--model-format", "AVRO"], 10),
    "score_output_avro": ("score", ["--output-format", "AVRO"], 9),
    "score_output_both": ("score", ["--output-format", "BOTH"], 9),
}


@pytest.mark.parametrize("case", sorted(NOT_PORTED))
def test_unported_options_raise_before_reading_data(tmp_path, case):
    cli, extra, slice_no = NOT_PORTED[case]
    missing = _missing(tmp_path)
    if cli == "train":
        argv = ["--train", missing, "--coordinate",
                "name=fixed,type=fixed,shard=global", "--update-sequence",
                "fixed", "--output-dir", str(tmp_path / "out"), *extra,
                "--device", "cpu"]
        module = game_train
    else:
        argv = ["--data", missing, "--model-dir", missing, "--output-dir",
                str(tmp_path / "out"), *extra, "--device", "cpu"]
        module = game_score
    message = str(not_ported("x", slice_no)).split(": ", 1)[1]
    with pytest.raises(NotImplementedError, match=message):
        module.run(module.build_parser().parse_args(argv))
    assert not os.path.exists(str(tmp_path / "out"))
