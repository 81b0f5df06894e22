"""The port's numpy synthetic clouds against the JAX package's generator:
equal arguments must give bit-identical clouds and labels."""

import numpy as np
import pytest

from scanobjectnn_tpu.data import synthetic as jsynth
from scanobjectnn_torch.data.synthetic import make_synthetic_dataset


@pytest.mark.parametrize(
    "num_per_class,num_classes,num_points,seed", [(2, 15, 64, 0), (3, 4, 33, 7), (1, 1, 5, 11)]
)
def test_synthetic_matches_reference(num_per_class, num_classes, num_points, seed):
    args = dict(num_per_class=num_per_class, num_classes=num_classes, num_points=num_points, seed=seed)
    data, labels = make_synthetic_dataset(**args)
    want_data, want_labels = jsynth.make_synthetic_dataset(**args)
    assert data.dtype == want_data.dtype == np.float32 and labels.dtype == want_labels.dtype
    np.testing.assert_array_equal(data, want_data)
    np.testing.assert_array_equal(labels, want_labels)


def test_synthetic_refuses_too_many_classes():
    with pytest.raises(ValueError, match="num_classes"):
        make_synthetic_dataset(num_classes=16)
