"""The port's numpy data pipeline against the JAX package's: the synthetic
clouds (equal arguments give bit-identical clouds and labels) and the
epochs of ragged input (per-cloud draws, masks, parts and types) and of
rectangular input with types, under one seed."""

import numpy as np
import pytest

from scanobjectnn_tpu.data import pipeline as jpipeline
from scanobjectnn_tpu.data import synthetic as jsynth
from scanobjectnn_torch.data import pipeline
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


def _ragged(rng, sizes, with_targets=True):
    clouds = [rng.randn(n, 3) for n in sizes]  # float64: the epoch casts to float32
    out = {"data": clouds, "labels": rng.randint(0, 15, len(sizes))}
    if with_targets:
        out["masks"] = [rng.randint(-1, 3, n) for n in sizes]
        out["parts"] = [rng.randint(0, 5, n).astype(np.int32) for n in sizes]
        out["types"] = rng.randint(0, 2, len(sizes))
    return out


def _same_epochs(got, want):
    assert list(got) == list(want)
    for key, v in want.items():
        assert got[key].dtype == v.dtype and got[key].shape == v.shape, key
        np.testing.assert_array_equal(got[key], v, err_msg=key)


@pytest.mark.parametrize("container", ["list", "tuple", "object_array"])
@pytest.mark.parametrize("shuffle", [True, False])
def test_ragged_epochs_match_jax(container, shuffle):
    """Each cloud's own point draw, masks and parts co-sampled, types
    co-shuffled: the same epochs as JAX's under one seed, two in a row."""
    rng = np.random.RandomState(9)
    ds = _ragged(rng, (40, 17, 33, 16, 25))
    if container != "list":
        for key in ("data", "masks", "parts"):
            ds[key] = tuple(ds[key]) if container == "tuple" else np.array(ds[key] + [None], dtype=object)[:-1]
    assert pipeline.is_ragged(ds["data"]) and jpipeline.is_ragged(ds["data"])
    kw = dict(masks=ds["masks"], parts=ds["parts"], types=ds["types"], num_points=16, shuffle=shuffle, seed=4)
    ours = pipeline.EpochSampler(ds["data"], ds["labels"], **kw)
    theirs = jpipeline.EpochSampler(ds["data"], ds["labels"], **kw)
    for _ in range(2):
        _same_epochs(ours.epoch(), theirs.epoch())


@pytest.mark.parametrize("fields", [(), ("masks",), ("parts",), ("types",)])
def test_ragged_epochs_match_jax_with_each_field_alone(fields):
    rng = np.random.RandomState(10)
    ds = _ragged(rng, (12, 30, 9, 21))
    kw = {key: ds[key] for key in fields}
    ours = pipeline.EpochSampler(ds["data"], ds["labels"], num_points=9, seed=1, **kw).epoch()
    theirs = jpipeline.EpochSampler(ds["data"], ds["labels"], num_points=9, seed=1, **kw).epoch()
    _same_epochs(ours, theirs)
    assert ours["points"].dtype == np.float32


def test_rectangular_epochs_with_types_match_jax():
    rng = np.random.RandomState(11)
    data, labels = rng.randn(6, 20, 3).astype(np.float32), rng.randint(0, 15, 6)
    kw = dict(masks=rng.randint(0, 2, (6, 20)), types=rng.randint(0, 2, 6), num_points=8, seed=2)
    _same_epochs(pipeline.EpochSampler(data, labels, **kw).epoch(), jpipeline.EpochSampler(data, labels, **kw).epoch())


def test_ragged_cloud_below_num_points_raises_as_jax():
    rng = np.random.RandomState(12)
    ds = _ragged(rng, (20, 7, 30), with_targets=False)
    with pytest.raises(ValueError) as ours:
        pipeline.EpochSampler(ds["data"], ds["labels"], num_points=8, seed=0).epoch()
    with pytest.raises(ValueError) as theirs:
        jpipeline.EpochSampler(ds["data"], ds["labels"], num_points=8, seed=0).epoch()
    assert str(ours.value) == str(theirs.value) == "cloud has 7 < num_points=8"


def test_is_ragged_matches_jax():
    for data in ([np.zeros((3, 3))], (np.zeros((3, 3)),), np.zeros((2, 3, 3)), np.array([None], dtype=object),
                 np.zeros((2, 3, 3), dtype=np.float64)):
        assert pipeline.is_ragged(data) == jpipeline.is_ragged(data)
