"""Shared down-sampling draw and per-step advance of the fixed-effect
coordinates (port of ``photon_ml_tpu/game/coordinates/_down_sampling.py``).

The sampler is picked by the task's loss (reference behavior), not by
inspecting label values. ``draw_down_sample`` is the one place that
dispatch lives: ``train_model`` uses its (idx, mult) to gather the
sampled rows on the device, and checkpoint resume replays the same
generator through ``_advance_down_sampling``. Both must consume the
generator identically, or a resumed run draws other subsets.
"""

from __future__ import annotations

import numpy as np

from photon_ml_torch.game.sampling import (binary_classification_down_sample,
                                           default_down_sample)


def draw_down_sample(coord, rate: float) -> tuple[np.ndarray, np.ndarray]:
    """One sampling draw for a fixed-effect coordinate: (row indices,
    weight multipliers), advancing ``coord._rng`` exactly one step."""
    if coord.loss.name in ("logistic", "smoothed_hinge"):
        return binary_classification_down_sample(
            coord._rng, coord.dataset.response, rate)
    return default_down_sample(coord._rng, coord.dataset.num_rows, rate)


def _advance_down_sampling(coord, steps: int) -> None:
    rate = coord.config.down_sampling_rate
    if rate >= 1.0:
        return
    for _ in range(steps):
        draw_down_sample(coord, rate)
