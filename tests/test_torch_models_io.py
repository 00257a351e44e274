"""Model files and offline scores: the port against photon_ml_tpu.

A model written by either package loads in the other with equal arrays,
``game_model_digest`` agrees across them, ``game_model_from_arrays``
carries a reference model's parameters into the port unchanged, and the
port's ``GameModel.score`` matches the reference's (rtol 1e-5) on dense
and ELL shards with unseen ids.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_torch.data.game_data import GameDataset as TDataset
from photon_ml_torch.data.game_data import SparseShard as TSparse
from photon_ml_torch.models import io as tio
from photon_ml_tpu.data.game_data import GameDataset as JDataset
from photon_ml_tpu.data.game_data import SparseShard as JSparse
from photon_ml_tpu.game.models import (FixedEffectModel, GameModel,
                                       RandomEffectModel,
                                       SubspaceRandomEffectModel,
                                       sort_subspace_rows)
from photon_ml_tpu.models import io as jio
from photon_ml_tpu.models.coefficients import Coefficients
from photon_ml_tpu.types import TaskType

D_GLOBAL, D_RE, E = 6, 4, 12


def reference_model(rng, subspace: bool, variances: bool = False):
    """A reference GameModel: dense fixed effect, a dense per-user RE and
    a per-item RE that is dense or kept in subspaces."""
    def f32(*shape):
        return rng.normal(size=shape).astype(np.float32)

    models = {
        "fixed": FixedEffectModel("global", Coefficients(
            jnp.asarray(f32(D_GLOBAL)),
            jnp.asarray(np.abs(f32(D_GLOBAL))) if variances else None)),
        "per-user": RandomEffectModel("userId", "re_userId",
                                      jnp.asarray(f32(E, D_RE))),
    }
    if subspace:
        A = 3
        cols = np.stack([rng.choice(D_RE, A, replace=False)
                         for _ in range(E)]).astype(np.int32)
        cols[1, -1] = -1
        cols[5, 1:] = -1
        cols_s, _, means_s = sort_subspace_rows(cols, f32(E, A))
        models["per-item"] = SubspaceRandomEffectModel(
            "itemId", "re_itemId", D_RE, jnp.asarray(cols_s),
            jnp.asarray(means_s))
    else:
        models["per-item"] = RandomEffectModel(
            "itemId", "re_itemId", jnp.asarray(f32(E, D_RE)),
            jnp.asarray(np.abs(f32(E, D_RE))) if variances else None)
    return GameModel(TaskType.LOGISTIC_REGRESSION, models)


def _ref_arrays(model):
    return {cid: jio.coordinate_arrays(m) for cid, m in model.models.items()}


def _port_arrays(model):
    return {cid: tio.coordinate_arrays(m) for cid, m in model.models.items()}


def _assert_same_arrays(a, b):
    assert sorted(a) == sorted(b)
    for cid in a:
        assert sorted(a[cid]) == sorted(b[cid])
        for k in a[cid]:
            assert a[cid][k].dtype == b[cid][k].dtype, (cid, k)
            np.testing.assert_array_equal(a[cid][k], b[cid][k])


@pytest.mark.parametrize("subspace", [False, True])
def test_reference_files_load_in_port(tmp_path, subspace):
    ref = reference_model(np.random.default_rng(1), subspace,
                          variances=not subspace)
    jio.save_game_model(ref, str(tmp_path))
    port = tio.load_game_model(str(tmp_path))
    assert port.task.value == ref.task.value
    _assert_same_arrays(_ref_arrays(ref), _port_arrays(port))
    assert tio.game_model_digest(port) == jio.game_model_digest(ref)


@pytest.mark.parametrize("subspace", [False, True])
def test_port_files_load_in_reference(tmp_path, subspace):
    ref = reference_model(np.random.default_rng(2), subspace)
    port = tio.game_model_from_arrays(ref.task, {
        cid: (jio.coordinate_meta(m), jio.coordinate_arrays(m))
        for cid, m in ref.models.items()})
    assert tio.game_model_digest(port) == jio.game_model_digest(ref)
    tio.save_game_model(port, str(tmp_path))
    back = jio.load_game_model(str(tmp_path), host=True, mapped=False)
    _assert_same_arrays(_port_arrays(port), _ref_arrays(back))
    assert jio.game_model_digest(back) == jio.game_model_digest(ref)


def _datasets(rng, n=40, sparse=False, unseen_extra=3):
    """The same rows as a reference and a port GameDataset."""
    def shard(d):
        if not sparse:
            return (rng.normal(size=(n, d)).astype(np.float32),) * 2
        k = 3
        idx = rng.integers(0, d + 1, (n, k)).astype(np.int32)  # d = pad
        val = rng.normal(size=(n, k)).astype(np.float32)
        val[idx == d] = 0.0
        return JSparse(idx, val, d), TSparse(idx, val, d)

    shards = {"global": shard(D_GLOBAL), "re_userId": shard(D_RE),
              "re_itemId": shard(D_RE)}
    ids = {t: rng.integers(0, E + unseen_extra, n).astype(np.int32)
           for t in ("userId", "itemId")}
    common = dict(response=np.zeros(n, np.float32),
                  offsets=rng.normal(size=n).astype(np.float32),
                  weights=np.ones(n, np.float32), entity_ids=ids,
                  num_entities={"userId": E, "itemId": E})
    return (JDataset(feature_shards={k: v[0] for k, v in shards.items()},
                     **common),
            TDataset(feature_shards={k: v[1] for k, v in shards.items()},
                     **common))


@pytest.mark.parametrize("subspace", [False, True])
@pytest.mark.parametrize("sparse", [False, True])
def test_offline_score_matches_reference(subspace, sparse):
    rng = np.random.default_rng(3)
    ref = reference_model(rng, subspace)
    port = tio.game_model_from_arrays(ref.task, {
        cid: (jio.coordinate_meta(m), jio.coordinate_arrays(m))
        for cid, m in ref.models.items()})
    jds, tds = _datasets(rng, sparse=sparse)
    want = {cid: np.asarray(s)
            for cid, s in ref.coordinate_scores(jds).items()}
    got = {cid: s.numpy() for cid, s in port.coordinate_scores(tds).items()}
    for cid in want:
        np.testing.assert_allclose(got[cid], want[cid], rtol=1e-5,
                                   atol=1e-6, err_msg=cid)
    unseen = tds.entity_ids["userId"] >= E
    assert unseen.any() and np.all(got["per-user"][unseen] == 0.0)
    np.testing.assert_allclose(port.score(tds).numpy(),
                               np.asarray(ref.score(jds)), rtol=1e-5,
                               atol=1e-6)


def test_entity_rows_match_reference():
    rng = np.random.default_rng(4)
    ref = reference_model(rng, subspace=True)
    port = tio.game_model_from_arrays(ref.task, {
        cid: (jio.coordinate_meta(m), jio.coordinate_arrays(m))
        for cid, m in ref.models.items()})
    ids = rng.permutation(E)[:7]
    for cid in ("per-user", "per-item"):
        np.testing.assert_array_equal(port.models[cid].entity_rows(ids),
                                      ref.models[cid].entity_rows(ids))


def test_synthetic_game_data_matches_reference():
    """The port's generator draws the reference's numbers from one seed."""
    from photon_ml_torch.data import game_data as tgd
    from photon_ml_torch.data import synthetic as tsyn
    from photon_ml_tpu.data import game_data as jgd
    from photon_ml_tpu.data import synthetic as jsyn

    specs = {"userId": (30, 4), "itemId": (20, 3)}
    t = tgd.from_synthetic(tsyn.game_data(np.random.default_rng(5), n=64,
                                          d_global=6, re_specs=specs))
    j = jgd.from_synthetic(jsyn.game_data(np.random.default_rng(5), n=64,
                                          d_global=6, re_specs=specs))
    assert sorted(t.feature_shards) == sorted(j.feature_shards)
    for k in j.feature_shards:
        np.testing.assert_array_equal(t.feature_shards[k],
                                      j.feature_shards[k])
    for k in j.entity_ids:
        np.testing.assert_array_equal(t.entity_ids[k], j.entity_ids[k])
    np.testing.assert_array_equal(t.response, j.response)
    assert t.intercept_index == j.intercept_index
    idx = np.arange(0, 64, 3)
    np.testing.assert_array_equal(t.subset(idx).feature_shards["global"],
                                  j.subset(idx).feature_shards["global"])


def test_coefficients_helpers():
    from photon_ml_torch.models.coefficients import Coefficients as TC

    w = np.array([3.0, -4.0], np.float32)
    c = TC(torch.from_numpy(w))
    assert c.dim == 2
    assert float(c.norm(1)) == 7.0 and float(c.norm(2)) == 5.0
    x = np.array([[1.0, 1.0], [2.0, 0.5]], np.float32)
    np.testing.assert_array_equal(c.compute_score(torch.from_numpy(x)).numpy(),
                                  x @ w)
    z = TC.zeros(3, with_variances=True)
    assert z.means.shape == (3,) and z.variances is not None
    with pytest.raises(ValueError):
        c.norm(3)
