"""GAME and GLM model persistence: the npz layout of
``photon_ml_tpu/models/io.py``.

A model directory holds ``metadata.json`` plus one
``{fixed,random}-effect/<coordinate>/coefficients.npz`` per coordinate
(reference: photon-client ``ModelProcessingUtils.scala``'s directory
shape). A single GLM is a ``<path>.npz`` (``means``, optional
``variances``) beside a ``<path>.json`` (``task``, ``dim``). Both
packages read and write the same bytes, so a model trained by either
serves in either, and :func:`game_model_digest` agrees across them.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from photon_ml_torch.game.models import (FixedEffectModel, GameModel,
                                         RandomEffectModel,
                                         SubspaceRandomEffectModel)
from photon_ml_torch.models.coefficients import Coefficients
from photon_ml_torch.models.glm import GeneralizedLinearModel
from photon_ml_torch.types import TaskType
from photon_ml_torch.utils.diskio import atomic_write

_METADATA = "metadata.json"


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def coordinate_meta(m) -> dict:
    """Metadata entry for one coordinate model (no file writes)."""
    if isinstance(m, FixedEffectModel):
        return {"type": "fixed", "shard_id": m.shard_id,
                "dim": int(m.coefficients.dim)}
    if isinstance(m, RandomEffectModel):
        return {"type": "random", "shard_id": m.shard_id,
                "re_type": m.re_type, "num_entities": int(m.num_entities),
                "dim": int(m.dim)}
    if isinstance(m, SubspaceRandomEffectModel):
        return {"type": "random-subspace", "shard_id": m.shard_id,
                "re_type": m.re_type, "num_entities": int(m.num_entities),
                "dim": int(m.dim), "subspace_dim": int(m.subspace_dim)}
    raise TypeError(f"unsupported coordinate model {type(m).__name__}")


def coordinate_arrays(m) -> dict:
    """One coordinate model's persisted arrays, as host numpy — the one
    definition of "the model's bytes", shared by the npz writer and the
    digest."""
    if isinstance(m, FixedEffectModel):
        payload = {"means": _host(m.coefficients.means)}
        if m.coefficients.variances is not None:
            payload["variances"] = _host(m.coefficients.variances)
    elif isinstance(m, SubspaceRandomEffectModel):
        payload = {"cols": _host(m.cols), "means": _host(m.means)}
        if m.variances is not None:
            payload["variances"] = _host(m.variances)
    elif isinstance(m, RandomEffectModel):
        payload = {"means": _host(m.means)}
        if m.variances is not None:
            payload["variances"] = _host(m.variances)
    else:
        raise TypeError(f"unsupported coordinate model {type(m).__name__}")
    return payload


def save_coordinate(path: str, cid: str, m) -> dict:
    """Atomically write one coordinate's coefficients under a GameModel
    directory; returns its metadata entry."""
    meta = coordinate_meta(m)
    sub = os.path.join(
        path, "fixed-effect" if meta["type"] == "fixed" else "random-effect",
        cid)
    os.makedirs(sub, exist_ok=True)
    payload = coordinate_arrays(m)
    atomic_write(os.path.join(sub, "coefficients.npz"),
                 lambda f: np.savez(f, **payload))
    return meta


def game_model_digest(model: GameModel) -> str:
    """SHA-256 over every coordinate's persisted arrays in canonical
    order: two models digest equal iff their bytes are identical (the
    same digest as ``photon_ml_tpu.models.io.game_model_digest``)."""
    h = hashlib.sha256()
    for cid in sorted(model.models):
        m = model.models[cid]
        h.update(json.dumps(coordinate_meta(m), sort_keys=True).encode())
        for key, arr in sorted(coordinate_arrays(m).items()):
            h.update(key.encode())
            h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def write_metadata(path: str, task: TaskType,
                   coordinates_meta: dict[str, dict]) -> None:
    """Atomically write a GameModel directory's metadata.json."""
    meta = {"task": TaskType(task).value, "coordinates": coordinates_meta}
    body = json.dumps(meta, indent=2, sort_keys=True)
    atomic_write(os.path.join(path, _METADATA),
                 lambda f: f.write(body.encode()))


def save_game_model(model: GameModel, path: str) -> None:
    """Write a GameModel directory (reference: saveGameModelToHDFS)."""
    os.makedirs(path, exist_ok=True)
    meta = {cid: save_coordinate(path, cid, m)
            for cid, m in model.models.items()}
    write_metadata(path, model.task, meta)


def _coordinate_from_arrays(info: dict, arrays, device):
    def put(key):
        if key not in arrays:
            return None
        return torch.from_numpy(np.array(arrays[key])).to(device)

    kind = info["type"]
    if kind == "fixed":
        return FixedEffectModel(
            shard_id=info["shard_id"],
            coefficients=Coefficients(means=put("means"),
                                      variances=put("variances")))
    if kind == "random-subspace":
        return SubspaceRandomEffectModel(
            re_type=info["re_type"], shard_id=info["shard_id"],
            num_features=int(info["dim"]), cols=put("cols"),
            means=put("means"), variances=put("variances"))
    if kind == "random":
        return RandomEffectModel(
            re_type=info["re_type"], shard_id=info["shard_id"],
            means=put("means"), variances=put("variances"))
    raise ValueError(f"unsupported coordinate type {kind!r} (this port "
                     "reads fixed, random and random-subspace)")


def game_model_from_arrays(task, coordinates: dict[str, tuple[dict, dict]],
                           device="cpu") -> GameModel:
    """A GameModel from ``{cid: (meta, arrays)}`` — the numpy dicts that
    ``coordinate_meta``/``coordinate_arrays`` return, in either package.
    This is how a model's parameters cross from the reference. ``task``
    is a TaskType of either package, or its string value."""
    return GameModel(
        task=TaskType(getattr(task, "value", task)),
        models={cid: _coordinate_from_arrays(meta, arrays, device)
                for cid, (meta, arrays) in coordinates.items()})


def load_game_model(path: str, device="cpu") -> GameModel:
    """Inverse of :func:`save_game_model` (the npz layout). Tables land
    on ``device``; the serving path loads them on the host, where its
    hash-sharded store keeps them."""
    with open(os.path.join(path, _METADATA)) as f:
        meta = json.load(f)
    coords = {}
    for cid, info in meta["coordinates"].items():
        sub = "fixed-effect" if info["type"] == "fixed" else "random-effect"
        with np.load(os.path.join(path, sub, cid, "coefficients.npz")) as z:
            coords[cid] = (info, {k: z[k] for k in z.files})
    return game_model_from_arrays(meta["task"], coords, device=device)


def _glm_base(path: str) -> str:
    return path[:-4] if path.endswith(".npz") else path


def save_glm(model: GeneralizedLinearModel, path: str) -> None:
    """Write a single GLM (reference: legacy GLMSuite output):
    ``<path>.npz`` and ``<path>.json``, each written atomically."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    base = _glm_base(path)
    payload = {"means": _host(model.coefficients.means)}
    if model.coefficients.variances is not None:
        payload["variances"] = _host(model.coefficients.variances)
    atomic_write(base + ".npz", lambda f: np.savez(f, **payload))
    meta_body = json.dumps({"task": TaskType(model.task).value,
                            "dim": int(model.coefficients.dim)})
    atomic_write(base + ".json", lambda f: f.write(meta_body.encode()))


def load_glm(path: str, device="cpu") -> GeneralizedLinearModel:
    """Inverse of :func:`save_glm`; the coefficients land on
    ``device``."""
    base = _glm_base(path)
    with np.load(base + ".npz") as z:
        arrays = {k: z[k] for k in z.files}
    with open(base + ".json") as f:
        meta = json.load(f)

    def put(key):
        if key not in arrays:
            return None
        return torch.from_numpy(arrays[key]).to(device)

    return GeneralizedLinearModel(
        task=TaskType(meta["task"]),
        coefficients=Coefficients(means=put("means"),
                                  variances=put("variances")))
