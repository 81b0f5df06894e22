"""Hand-written CUDA kernels for Hopper (sources in ``scanobjectnn_torch/csrc``),
each beside its plain PyTorch version.  Importing this package builds
nothing; ``_build.library()`` compiles on first launch."""
