"""scanobjectnn_torch — the PyTorch/CUDA port of ``scanobjectnn_tpu``.

The layout mirrors the JAX package so each module's counterpart is easy to
find:

  nn/        Dense, eval BatchNorm, MLP; PointNet++ SA modules
  ops/       FPS and gathers; ``ops/cuda`` holds the hand-written CUDA
             kernels (sources in ``csrc/``) beside their plain versions
  models/    PointNet2ClsSSG and the ``get_model`` registry
  data/      seeded synthetic clouds (numpy)
  convert.py JAX ``variables`` -> this package's ``state_dict``; init

Nothing here imports JAX or the JAX package, so the port runs where
neither is installed.  Kernels are compiled with nvcc on first use, never
at import time.
"""

__version__ = "0.1.0"
