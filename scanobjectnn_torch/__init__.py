"""scanobjectnn_torch — the PyTorch/CUDA port of ``scanobjectnn_tpu``.

The layout mirrors the JAX package so each module's counterpart is easy to
find:

  nn/        Dense, eval BatchNorm, MLP; PointNet++ SA modules
  ops/       FPS, gathers, ProbSample and the EMD auction; ``ops/cuda``
             holds the hand-written CUDA kernels (sources in ``csrc/``)
             beside their plain versions
  models/    the ``get_model`` registry of the ported models
  data/      loaders, splits, the epoch sampler, synthetic clouds (numpy)
  train/     the trainer (steps, evaluation, ``fit``, checkpoints), the
             evaluation protocols and the command line (``train/cli.py``)
  parallel/  data parallelism over torch.distributed: the mesh helpers,
             the cross-replica reductions and the global-batch draws
  utils/     the logger and the profiler trace
  viz/       renders, the viewer, the interpolation check and the
             confusion-matrix plot
  convert.py JAX ``variables`` -> this package's ``state_dict``; init

Nothing here imports JAX or the JAX package, so the port runs where
neither is installed.  Kernels are compiled with nvcc on first use, never
at import time.
"""

__version__ = "0.1.0"
