"""GAME coordinates: fixed-effect and random-effect training units.

Port of ``photon_ml_tpu/game/coordinates/``. Reference parity: photon-api
``algorithm/Coordinate.scala``, ``FixedEffectCoordinate.scala`` (one GLM
fit over the whole dataset, over a dense or an ELL sparse shard) and
``RandomEffectCoordinate.scala`` (per-entity local GLM fits).

Residency: each coordinate stages its data on its device once, in
``__init__``; per coordinate-descent step the only new inputs are the
(n,) offsets and the warm start. Both expose ``train_model(offsets,
initial)``, ``score(model)``, ``compute_model_variances`` and
``initial_model``, mirroring the reference Coordinate contract (offsets
are passed explicitly rather than mutating a dataset).
"""

from photon_ml_torch.game.coordinates.fixed import FixedEffectCoordinate
from photon_ml_torch.game.coordinates.random_effect import \
    RandomEffectCoordinate
from photon_ml_torch.game.coordinates.sparse_fixed import \
    SparseFixedEffectCoordinate

__all__ = ["FixedEffectCoordinate", "RandomEffectCoordinate",
           "SparseFixedEffectCoordinate"]
