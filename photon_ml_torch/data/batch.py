"""Columnar labeled-example batches.

Port of ``photon_ml_tpu/data/batch.py``. Reference parity: photon-lib
``data/LabeledPoint.scala`` (label, features, offset, weight) and
photon-api ``data/LocalDataset.scala``, but columnar: a batch is a
struct of tensors, so the whole batch feeds one matrix product.

A batch may carry a leading lane axis (features (..., n, d), the rest
(..., n)): a random-effect bucket is one batch of (E_b, cap) examples.

Padding: a padded row has ``weight == 0`` and every aggregator treats
zero-weight rows as absent (masked with ``where``, not multiplied, so
non-finite garbage in padding can never poison a sum).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_ml_torch import not_ported

Tensor = torch.Tensor


def check_feature_dtype(feature_dtype) -> None:
    if feature_dtype not in (None, "float32", torch.float32):
        raise not_ported(f"feature_dtype {feature_dtype!r} (the port stores "
                         "features in float32 only)", 6)


@dataclasses.dataclass(frozen=True)
class LabeledBatch:
    """A (possibly padded) batch: X (..., n, d), labels/weights/offsets
    (..., n)."""

    features: Tensor
    labels: Tensor
    weights: Tensor
    offsets: Tensor

    @property
    def num_rows(self) -> int:
        return int(self.features.shape[-2])

    @property
    def dim(self) -> int:
        return int(self.features.shape[-1])

    @staticmethod
    def build(features, labels, weights=None, offsets=None,
              dtype=torch.float32, feature_dtype=None,
              device=None) -> "LabeledBatch":
        """Tensors from array-likes on ``device`` (default: where they
        already are, the CPU for numpy). ``feature_dtype`` other than
        float32 raises: bf16 storage is not ported yet."""
        check_feature_dtype(feature_dtype)

        def put(a):
            if isinstance(a, np.ndarray):
                a = torch.from_numpy(np.ascontiguousarray(a))
            return torch.as_tensor(a, dtype=dtype, device=device)

        features = put(features)
        labels = put(labels)
        n = features.shape[-2]
        weights = (torch.ones((n,), dtype=dtype, device=features.device)
                   if weights is None else put(weights))
        offsets = (torch.zeros((n,), dtype=dtype, device=features.device)
                   if offsets is None else put(offsets))
        return LabeledBatch(features, labels, weights, offsets)

    def pad_to(self, n: int) -> "LabeledBatch":
        """Pad rows up to ``n`` with zero-weight rows."""
        cur = self.num_rows
        if cur == n:
            return self
        if cur > n:
            raise ValueError(f"cannot pad {cur} rows down to {n}")
        pad = n - cur

        def _pad(a):
            # F.pad lists widths from the last dimension backwards.
            widths = (0, 0, 0, pad) if a.dim() == self.features.dim() \
                else (0, pad)
            return torch.nn.functional.pad(a, widths, value=0.0)

        return LabeledBatch(features=_pad(self.features),
                            labels=_pad(self.labels),
                            weights=_pad(self.weights),
                            offsets=_pad(self.offsets))
