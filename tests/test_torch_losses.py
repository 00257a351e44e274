"""Port losses against ``photon_ml_tpu.ops.losses`` on the same inputs.

Both are float32 elementwise functions, so they agree to rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_torch.ops import losses as tl
from photon_ml_torch.types import TaskType as TorchTask
from photon_ml_tpu.ops import losses as jl
from photon_ml_tpu.types import TaskType as JaxTask

RTOL = 1e-6


def _inputs(name):
    rng = np.random.default_rng(11)
    margin = np.concatenate([
        rng.normal(size=200) * 3.0,
        np.array([-30.0, -1.0, 0.0, 0.5, 1.0, 2.0, 25.0]),
    ]).astype(np.float32)
    if name == "poisson":
        label = rng.poisson(2.0, margin.shape[0]).astype(np.float32)
        margin = np.clip(margin, -10.0, 10.0)
    elif name == "squared":
        label = rng.normal(size=margin.shape[0]).astype(np.float32)
    else:
        label = (rng.random(margin.shape[0]) < 0.5).astype(np.float32)
    return margin, label


def _assert_close(got, want, terms):
    """rtol 1e-6 of ``terms``, the magnitude the result was formed from:
    |want| itself, or for a difference A − B the size of A and B, since a
    one-ulp difference in A (an ``exp`` of either library) is one ulp of
    A, not of A − B."""
    assert got.dtype == torch.float32
    got, want = got.numpy(), np.asarray(want)
    err = np.abs(got - want)
    assert np.all(err <= RTOL * terms + 1e-7), float(np.max(err / terms))


@pytest.mark.parametrize("name", ["logistic", "squared", "poisson",
                                  "smoothed_hinge"])
def test_loss_matches_reference(name):
    margin, label = _inputs(name)
    jloss, tloss = jl.get_loss(name), tl.get_loss(name)
    tm, ty = torch.from_numpy(margin), torch.from_numpy(label)
    jm, jy = jnp.asarray(margin), jnp.asarray(label)
    value = np.abs(np.asarray(jloss.loss(jm, jy)))
    dz = np.abs(np.asarray(jloss.dz(jm, jy)))
    if name in ("logistic", "poisson"):
        # l = A(z) − y·z and dl = A'(z) − y: differences of two terms.
        value = value + 2 * np.abs(label * margin)
        dz = dz + 2 * np.abs(label)
    _assert_close(tloss.loss(tm, ty), jloss.loss(jm, jy), value)
    _assert_close(tloss.dz(tm, ty), jloss.dz(jm, jy), dz)
    _assert_close(tloss.d2z(tm, ty), jloss.d2z(jm, jy),
                  np.abs(np.asarray(jloss.d2z(jm, jy))))
    _assert_close(tloss.mean(tm), jloss.mean(jm),
                  np.abs(np.asarray(jloss.mean(jm))))


@pytest.mark.parametrize("task", list(JaxTask))
def test_loss_for_task_matches_reference(task):
    assert tl.loss_for_task(TorchTask(task.value)).name == \
        jl.loss_for_task(task).name
    assert TorchTask(task.value).is_classification == task.is_classification
