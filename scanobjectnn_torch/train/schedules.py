"""Learning-rate and BatchNorm-momentum schedules (counterpart of
``scanobjectnn_tpu/train/schedules.py``).

Reference: pointnet2/train.py:116-134.
  * LR: staircase exponential decay on SAMPLES seen (step·batch_size),
    clipped below at 1e-5 (get_learning_rate).
  * PointCNN's LR (``step_exponential_decay_lr``): staircase decay on
    global STEPS, clipped below at learning_rate_min
    (PointCNN/train.py:160-162).
  * BN momentum (bn_decay): 1 − 0.5·0.5^floor(samples/decay_step), clipped
    above at 0.99 (get_bn_decay).
Each schedule maps the integer step to a Python float.  The arithmetic runs
in numpy float32, in the JAX schedules' order, so the values are the JAX
package's bit for bit.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

__all__ = ["bn_momentum_schedule", "exponential_decay_lr", "step_exponential_decay_lr"]

_F32 = np.float32


def _exponent(step: int, batch_size: int, decay_step: int, staircase: bool) -> np.float32:
    p = _F32(step) * _F32(batch_size) / _F32(decay_step)
    return np.floor(p) if staircase else p


def exponential_decay_lr(
    base_lr: float,
    batch_size: int,
    decay_step: int = 200_000,
    decay_rate: float = 0.7,
    staircase: bool = True,
    floor: float = 1e-5,
) -> Callable[[int], float]:
    """LR(step) = max(base · rate^(step·bs/decay_step), floor)."""

    def schedule(step: int) -> float:
        p = _exponent(step, batch_size, decay_step, staircase)
        return float(np.maximum(_F32(base_lr) * np.power(_F32(decay_rate), p), _F32(floor)))

    return schedule


def step_exponential_decay_lr(
    base_lr: float, decay_steps: int, decay_rate: float, floor: float
) -> Callable[[int], float]:
    """LR(step) = max(base · rate^floor(step/decay_steps), floor)."""

    def schedule(step: int) -> float:
        p = _exponent(step, 1, decay_steps, True)
        return float(np.maximum(_F32(base_lr) * np.power(_F32(decay_rate), p), _F32(floor)))

    return schedule


def bn_momentum_schedule(
    batch_size: int,
    decay_step: int = 200_000,
    init_decay: float = 0.5,
    decay_rate: float = 0.5,
    clip: float = 0.99,
    staircase: bool = True,
) -> Callable[[int], float]:
    """bn_decay(step) = min(clip, 1 − init·rate^(step·bs/decay_step))."""

    def schedule(step: int) -> float:
        p = _exponent(step, batch_size, decay_step, staircase)
        momentum = _F32(init_decay) * np.power(_F32(decay_rate), p)
        return float(np.minimum(_F32(clip), _F32(1.0) - momentum))

    return schedule
