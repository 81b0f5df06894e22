"""Hand-written CUDA kernels for Hopper (sources in ``scanobjectnn_torch/csrc``),
each beside its plain PyTorch version.  Importing this package builds
nothing; ``_build.library()`` compiles on first launch.

Every wrapper takes its plain version where ``takes_plain`` holds for its
input: a CPU tensor, or any tensor inside ``plain_ops()``, the switch
behind ``TrainerConfig.ops_backend="lax"`` (JAX's pure-lax reference path)
that runs the plain versions on the card.  Nothing turns the switch on but
the caller: a kernel that fails to build or launch raises."""

from __future__ import annotations

import contextlib

__all__ = ["plain_ops", "takes_plain"]

# Process-wide, not thread-local: autograd runs a CUDA backward (the
# scatter-add under a gather, say) on its own device threads.
_plain_depth = 0


@contextlib.contextmanager
def plain_ops():
    """Inside the block every wrapper runs its plain version on any device
    and launches no kernel."""
    global _plain_depth
    _plain_depth += 1
    try:
        yield
    finally:
        _plain_depth -= 1


def takes_plain(t) -> bool:
    """Whether a wrapper given ``t`` runs its plain version: ``t`` on the
    CPU, or inside ``plain_ops()``."""
    return t.device.type == "cpu" or _plain_depth > 0
