"""photon_ml_torch: the PyTorch and CUDA port of ``photon_ml_tpu``.

Module paths mirror the JAX package (``photon_ml_torch/serving/service.py``
ports ``photon_ml_tpu/serving/service.py``). The port imports ``torch``
and never ``jax``, and nothing of ``photon_ml_tpu``: what it needs from a
reference module it keeps as its own copy.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see :mod:`photon_ml_torch.device`). Every TPU kernel on
a ported path is a hand-written Hopper kernel under ``csrc/``, with a
plain PyTorch version beside its wrapper in ``ops/kernels/``.
"""
