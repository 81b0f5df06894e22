"""Dataset helpers (counterpart of ``scanobjectnn_tpu/data/io.py``).

Ported: ``convert_to_binary_mask``.  The h5 and .bin loaders wait for the
CLI slice.
"""

from __future__ import annotations

import numpy as np

__all__ = ["convert_to_binary_mask"]


def convert_to_binary_mask(masks: np.ndarray) -> np.ndarray:
    """Mask -1 (background) -> 0, every other value -> 1, as float64
    (ref data_utils.py:280-290)."""
    return (np.asarray(masks) != -1).astype(np.float64)
