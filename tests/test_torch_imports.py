"""The PyTorch port stands alone: no JAX, nothing of photon_ml_tpu.

A subprocess blocks both packages and imports every module of
``photon_ml_torch`` and ``chip_smoke``; an AST scan finds no import of
either; and the entry points refuse to fall back to the CPU when CUDA is
absent and the caller did not ask for it.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import photon_ml_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(photon_ml_torch.__file__))


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if not d.startswith(("_build", "__"))]
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _module_names():
    names = ["chip_smoke"]
    for path in _port_files()[1:]:
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        names.append(rel[: -len(".__init__")] if rel.endswith("__init__")
                     else rel)
    return names


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['photon_ml_tpu'] = None\n"
        f"for name in {_module_names()!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'jaxlib',"
        " 'photon_ml_tpu.')) for m, v in sys.modules.items()"
        " if v is not None), 'a JAX module was imported'\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    banned = ("jax", "jaxlib", "photon_ml_tpu")
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in banned, \
                f"{path}:{node.lineno} imports {name}"


@pytest.mark.parametrize("module", [
    "photon_ml_torch.game.projector", "photon_ml_torch.game.staging",
    "photon_ml_torch.game.staging_cache"])
def test_projection_modules_are_covered(module):
    """The projected random effect's host modules are among the scanned
    ones, and a spawned staging worker's imports bring no JAX either."""
    assert module in _module_names()
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['photon_ml_tpu'] = None\n"
        f"import {module}\n"
        "print(sorted(m for m in sys.modules if m.startswith("
        "'photon_ml_torch.game.')))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert module in out.stdout


def _tiny_model():
    from photon_ml_torch.game.models import (FixedEffectModel, GameModel,
                                             RandomEffectModel)
    from photon_ml_torch.models.coefficients import Coefficients
    from photon_ml_torch.types import TaskType

    rng = np.random.default_rng(0)
    return GameModel(TaskType.LOGISTIC_REGRESSION, {
        "fixed": FixedEffectModel("global", Coefficients(
            torch.from_numpy(rng.normal(size=6).astype(np.float32)))),
        "per-user": RandomEffectModel("userId", "re_userId", torch.from_numpy(
            rng.normal(size=(12, 4)).astype(np.float32)))})


def test_entry_points_refuse_cpu_fallback(tmp_path):
    """Without CUDA, the default device raises instead of running on the
    CPU; ``device="cpu"`` is the only way onto the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the refusal needs its absence")
    from photon_ml_torch.cli import serve
    from photon_ml_torch.device import resolve_device
    from photon_ml_torch.models.io import save_game_model
    from photon_ml_torch.serving import ScoringService

    model = _tiny_model()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ScoringService(model)
    save_game_model(model, str(tmp_path))
    args = serve.build_parser().parse_args(
        ["--model-dir", str(tmp_path), "--port", "0"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        server, svc = serve.create_server(args)
        try:  # not reached: the default device is cuda
            server.server_close()
        finally:
            svc.close()
    with ScoringService(model, device="cpu") as svc:
        assert svc.device == torch.device("cpu")
        assert svc.store.random[0].cache.device.type == "cpu"
    # The GAME drivers refuse before they read any data.
    from photon_ml_torch.cli import game_score, game_train

    missing = str(tmp_path / "no-such-data")
    for argv in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            game_train.run(game_train.build_parser().parse_args([
                "--train", missing, "--coordinate",
                "name=fixed,type=fixed,shard=global", "--update-sequence",
                "fixed", "--output-dir", str(tmp_path / "out"), *argv]))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            game_score.run(game_score.build_parser().parse_args([
                "--data", missing, "--model-dir", str(tmp_path),
                "--output-dir", str(tmp_path / "scores"), *argv]))
    assert not os.path.exists(str(tmp_path / "out"))
    assert not os.path.exists(str(tmp_path / "scores"))


def test_precision_policy_keeps_float32():
    from photon_ml_torch.device import resolve_device

    resolve_device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_precision_policy_keeps_bfloat16_reductions_float32():
    """cuBLAS may not reduce a bfloat16 product's split-K partials in
    bfloat16 (PyTorch's default allows it)."""
    from photon_ml_torch.device import resolve_device

    matmul = torch.backends.cuda.matmul
    matmul.allow_bf16_reduced_precision_reduction = True
    resolve_device("cpu")
    assert matmul.allow_bf16_reduced_precision_reduction is False


def test_chip_smoke_refuses_without_cuda():
    """chip_smoke.py exits non-zero and prints no result without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
