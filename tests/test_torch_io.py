"""The port's dataset I/O (``data/io.py``, ``data/splits.py``,
``synthetic.write_synthetic_h5``) against the JAX package's on the same
files: arrays equal with their dtypes, PLY files byte-identical.  Every test
writes its own small files (h5py, numpy, pickle, XML)."""

import os
import pickle

import numpy as np
import pytest

from scanobjectnn_tpu.data import io as jio
from scanobjectnn_tpu.data import splits as jsplits
from scanobjectnn_tpu.data import synthetic as jsynth
from scanobjectnn_torch.data import io, splits, synthetic


def _same(got, want):
    assert type(got) is type(want)
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def _write_bin(path, n, rng, labels=None, floats=11):
    """A raw object file: the point-count header, then ``floats`` floats a
    point; the last column the semantic label where ``labels`` is given."""
    pts = rng.randn(n, floats).astype(np.float32)
    if labels is not None:
        pts[:, -1] = labels
    np.concatenate([np.float32([n]), pts.reshape(-1)]).astype(np.float32).tofile(path)


# The h5 loaders: each reads what save_h5 (the port's or JAX's) wrote.
LOADERS = {
    "load_h5": dict(),
    "load_withmask_h5": dict(mask=True),
    "load_parts_h5": dict(parts=True),
    "load_discriminator_h5": dict(model_type=True),
}


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("loader", sorted(LOADERS))
def test_h5_loaders_match_jax(tmp_path, loader, writer):
    rng = np.random.RandomState(0)
    fields = {"data": rng.randn(5, 16, 3), "label": rng.randint(0, 15, 5)}
    extra = LOADERS[loader]
    kw = {}
    if extra.get("mask"):
        kw["mask"] = rng.choice([-1, 0, 3, 7], (5, 16)).astype(np.int64)
    if extra.get("parts"):
        kw["parts"] = rng.randint(0, 4, (5, 16)).astype(np.int32)
    if extra.get("model_type"):
        kw["model_type"] = rng.randint(0, 2, 5).astype(np.int8)
    path = str(tmp_path / "set.h5")
    (io if writer == "port" else jio).save_h5(path, fields["data"], fields["label"], **kw)
    got, want = getattr(io, loader)(path), getattr(jio, loader)(path)
    _same(got, want)
    assert got[0].dtype == np.float32 and got[1].dtype == np.int64


def test_save_h5_writes_what_jax_writes(tmp_path):
    import h5py

    rng = np.random.RandomState(1)
    args = (rng.randn(3, 8, 3), np.array([1, 2, 3], np.int32))
    kw = dict(mask=rng.randint(-1, 2, (3, 8)), parts=rng.randint(0, 3, (3, 8)).astype(np.uint8),
              model_type=np.array([0, 1, 0]))
    io.save_h5(str(tmp_path / "port.h5"), *args, **kw)
    jio.save_h5(str(tmp_path / "jax.h5"), *args, **kw)
    with h5py.File(tmp_path / "port.h5") as p, h5py.File(tmp_path / "jax.h5") as j:
        assert sorted(p) == sorted(j) == ["data", "label", "mask", "parts", "type"]
        for name in j:
            _same(p[name][:], j[name][:])


@pytest.mark.parametrize("with_mask,with_parts", [(False, False), (True, False), (True, True)])
def test_write_synthetic_h5_matches_jax(tmp_path, with_mask, with_parts):
    kw = dict(num_per_class=2, num_classes=4, num_points=32, seed=3, with_mask=with_mask, with_parts=with_parts)
    synthetic.write_synthetic_h5(str(tmp_path / "port.h5"), **kw)
    jsynth.write_synthetic_h5(str(tmp_path / "jax.h5"), **kw)
    loader = "load_parts_h5" if with_parts else "load_withmask_h5" if with_mask else "load_h5"
    _same(getattr(io, loader)(str(tmp_path / "port.h5")), getattr(jio, loader)(str(tmp_path / "jax.h5")))
    if with_parts:
        _same(io.load_withmask_h5(str(tmp_path / "port.h5")), jio.load_withmask_h5(str(tmp_path / "jax.h5")))


# (points, semantic labels or None, suncg, with_bg)
PC_FILES = {
    "with_bg": (40, "mixed", False, True),
    "foreground": (40, "mixed", False, False),
    "foreground_minus_one_dominant": (40, "minus_one", False, False),
    "all_background": (12, "background", False, False),
    "all_background_with_bg": (12, "background", False, True),
    "suncg": (25, None, True, True),
    "empty": (0, "mixed", False, True),
}


def _labels(kind, n, rng):
    if kind == "mixed":  # walls, floor, ceiling, an object class and -1
        return rng.choice([0.0, 1.0, 2.0, 5.0, 5.0, 9.0, -1.0], n)
    if kind == "minus_one":  # -1 (unannotated) outnumbers the object class: it is kept
        return rng.choice([0.0, -1.0, -1.0, -1.0, 4.0], n)
    return rng.choice([0.0, 1.0, 2.0], n)


@pytest.mark.parametrize("case", sorted(PC_FILES))
def test_load_pc_file_matches_jax(tmp_path, case):
    n, kind, suncg, with_bg = PC_FILES[case]
    rng = np.random.RandomState(len(case))
    path = str(tmp_path / "obj.bin")
    _write_bin(path, n, rng, None if kind is None else _labels(kind, n, rng), floats=3 if suncg else 11)
    got = io.load_pc_file(path, suncg=suncg, with_bg=with_bg)
    _same(got, jio.load_pc_file(path, suncg=suncg, with_bg=with_bg))
    assert got.dtype == np.float32 and got.shape[1] == 3
    if case == "all_background":
        assert got.shape == (0, 3)


@pytest.mark.parametrize("with_bg", [True, False])
@pytest.mark.parametrize("data_dir", [True, False])
def test_load_data_matches_jax_and_drops_small_objects(tmp_path, with_bg, data_dir):
    rng = np.random.RandomState(5)
    root = tmp_path / "objects"
    root.mkdir()
    entries = []
    for i, (n, kind) in enumerate([(60, "mixed"), (20, "mixed"), (50, "minus_one"), (70, "background"),
                                   (64, "mixed")]):
        name = f"scene{i}_obj.bin"
        _write_bin(str(root / name), n, rng, _labels(kind, n, rng))
        entries.append({"filename": "objects_bin/" + (name if data_dir else str(root / name)), "label": i % 3})
    listing = str(tmp_path / "list.pickle")
    with open(listing, "wb") as f:
        pickle.dump(entries, f)
    kw = dict(num_points=32, with_bg=with_bg, data_dir=str(root) if data_dir else None)
    got, want = io.load_data(listing, **kw), jio.load_data(listing, **kw)
    _same(got, want)
    assert len(got[0]) < len(entries)  # the 20-point object is always dropped


@pytest.mark.parametrize("ragged", [False, True])
def test_center_and_normalize_match_jax(ragged):
    rng = np.random.RandomState(6)
    if ragged:
        pcs = [rng.randn(n, 3).astype(np.float32) * 3 + 1 for n in (7, 19, 33)]
    else:
        pcs = (rng.randn(4, 21, 3) * 3 + 1).astype(np.float32)
    for fn in ("center_data", "normalize_data"):
        _same(getattr(io, fn)(pcs), getattr(jio, fn)(pcs))
    _same(io.normalize_data(io.center_data(pcs)), jio.normalize_data(jio.center_data(pcs)))
    mv = rng.randn(2, 5, 9, 3).astype(np.float32)
    _same(io.normalize_data_multiview(mv), jio.normalize_data_multiview(mv))


def test_masks_and_types_match_jax():
    rng = np.random.RandomState(7)
    masks = rng.choice([-1, 0, 2, 14], (3, 10))
    _same(io.convert_to_binary_mask(masks), jio.convert_to_binary_mask(masks))
    types = rng.randint(0, 3, 12)
    _same(io.flip_types(types), jio.flip_types(types))


@pytest.mark.parametrize("colors,normals", [(False, False), (True, False), (False, True), (True, True)])
def test_save_ply_writes_jax_bytes_and_reads_back(tmp_path, colors, normals):
    rng = np.random.RandomState(8)
    pts = rng.randn(17, 3)
    kw = dict(colors=rng.rand(17, 3) if colors else None, normals=rng.randn(17, 3) if normals else None)
    io.save_ply(pts, str(tmp_path / "port.ply"), **kw)
    jio.save_ply(pts, str(tmp_path / "jax.ply"), **kw)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    got, want = io.load_ply(str(tmp_path / "port.ply")), jio.load_ply(str(tmp_path / "jax.ply"))
    assert list(got) == list(want)
    for name in want:
        _same(got[name], want[name])
    np.testing.assert_array_equal(np.stack([got["x"], got["y"], got["z"]], 1), pts.astype(np.float32))


def test_split_files_match_jax(tmp_path):
    path = tmp_path / "split1.txt"
    # Blank lines, a trailing blank line, a third field other than "t", and
    # spaces around the marker.
    path.write_text("a/obj_1.bin\t3\n\nb/obj_2.bin\t0\tt\nc/obj_3.bin\t14\tx\n\nd/obj_4.bin\t7\t t \n\n")
    got, want = splits.load_split(str(path)), jsplits.load_split(str(path))
    assert [vars(e) for e in got] == [vars(e) for e in want]
    assert [e.is_test for e in got] == [False, True, False, True]
    assert [[vars(e) for e in part] for part in splits.split_train_test(got)] == \
        [[vars(e) for e in part] for part in jsplits.split_train_test(want)]


def test_class_names_and_object_labels_match_jax(tmp_path):
    names = tmp_path / "shape_names_ext.txt"
    names.write_text("bag\n\n  bin  \nbox\n\n")
    assert splits.load_class_names(str(names)) == jsplits.load_class_names(str(names)) == ["bag", "bin", "box"]
    labels = tmp_path / "object_labels.txt"
    # Short lines (fewer than four fields) and blank lines are skipped.
    labels.write_text("005_00020 1 chair 2048\nshort line\n\n011_00001 7 table 512 extra\n   \n012 2 bed\n")
    got, want = splits.load_object_labels(str(labels)), jsplits.load_object_labels(str(labels))
    assert got == want and len(got) == 2


def test_part_colormap_matches_jax(tmp_path):
    path = tmp_path / "chair_meta.xml"
    path.write_text('<?xml version="1.0"?>\n<classes>\n  <class id="0" text="back" color="255 0 0"/>\n'
                    '  <class id="1" text="seat" color="0 128 255"/>\n  <other id="9"/>\n</classes>\n')
    got, want = splits.load_part_colormap(str(path)), jsplits.load_part_colormap(str(path))
    assert got == want and [p["color"] for p in got] == [(255, 0, 0), (0, 128, 255)]


def test_default_training_data_dir_matches_jax(tmp_path, monkeypatch):
    for value in (str(tmp_path), str(tmp_path / "missing"), None):
        if value is None:
            monkeypatch.delenv("SCANOBJECTNN_TRAINING_DATA", raising=False)
        else:
            monkeypatch.setenv("SCANOBJECTNN_TRAINING_DATA", value)
        assert splits.default_training_data_dir() == jsplits.default_training_data_dir()
    monkeypatch.setenv("SCANOBJECTNN_TRAINING_DATA", str(tmp_path))
    assert splits.default_training_data_dir() == str(tmp_path)


def test_the_port_imports_no_jax():
    """The data modules are the port's own copies: none names JAX or the JAX
    package."""
    root = os.path.dirname(io.__file__)
    for name in ("io.py", "splits.py", "pipeline.py", "synthetic.py"):
        with open(os.path.join(root, name)) as f:
            text = f.read()
        for statement in ("import jax", "from jax", "import scanobjectnn_tpu", "from scanobjectnn_tpu"):
            assert statement not in text, (name, statement)
