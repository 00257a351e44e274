"""Hand-written Hopper kernels of the port, one module per kernel.

Each module holds the wrapper (CPU tensors → its plain PyTorch version,
CUDA tensors → the kernel, or raise), the plain version, and a launch
count on the wrapper. Sources live in ``photon_ml_torch/csrc/`` and are
built by ``_build.py`` at first use.
"""
