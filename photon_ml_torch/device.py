"""Device and precision policy of the port.

Entry points default to ``cuda``. Where CUDA is absent and the caller did
not ask for the CPU, they raise: nothing drops silently to the CPU.

The reference accumulates in float32, so TF32 stays off for matrix
products and convolutions, float32 matmul precision is ``"highest"``, and
cuBLAS may not reduce the split-K partials of a bfloat16 product in
bfloat16 (PyTorch allows it by default).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DEFAULT_DEVICE = "cuda"

DeviceLike = Union[str, torch.device]


def set_precision() -> None:
    """Full float32 everywhere: no TF32 in cuBLAS or cuDNN, and no
    bfloat16 reduction of a bfloat16 product's partial sums."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: Optional[DeviceLike] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another. Raises when CUDA is asked for (explicitly or by
    default) and is not available. Also applies :func:`set_precision`."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to "
            "run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    set_precision()
    return dev
