"""Dataset I/O for ScanObjectNN, numpy only (counterpart of
``scanobjectnn_tpu/data/io.py``).

Loads the benchmark's h5 containers (fields ``data``, ``label`` and
optionally ``mask``, ``parts``, ``type``) and the raw per-object ``.bin``
files (a float32 point-count header, then 11 floats a point: x y z nx ny nz
r g b label nyu_label; 3 floats for suncg).

Behavioural reference: data_utils.py:16-294 (load_h5:249,
load_withmask_h5:255, load_parts_h5:271, load_discriminator_h5:263,
load_pc_file:50, load_data:77, center_data:162, normalize_data:133,
convert_to_binary_mask:280, flip_types:292, save_ply:16).  ``h5py`` is
imported inside the functions that read or write h5 files; the PLY writer
and reader are direct binary little-endian code, no ``plyfile``.
"""

from __future__ import annotations

import os
import pickle
from typing import Sequence

import numpy as np

__all__ = [
    "center_data",
    "convert_to_binary_mask",
    "flip_types",
    "load_data",
    "load_discriminator_h5",
    "load_h5",
    "load_parts_h5",
    "load_pc_file",
    "load_ply",
    "load_withmask_h5",
    "normalize_data",
    "normalize_data_multiview",
    "object_array",
    "save_h5",
    "save_ply",
]

_BIN_FLOATS_PER_POINT = 11  # x y z nx ny nz r g b label nyu_label


def _h5py():
    try:
        import h5py
    except ImportError as err:  # pragma: no cover
        raise ImportError("h5py is required for .h5 dataset files") from err
    return h5py


def _load_fields(path: str, *fields: str) -> tuple[np.ndarray, ...]:
    with _h5py().File(path, "r") as f:
        return tuple(f[name][:] for name in fields)


def load_h5(path: str) -> tuple[np.ndarray, np.ndarray]:
    """``(data [B, N, 3], label [B])`` of an h5 file (ref data_utils.py:249)."""
    return _load_fields(path, "data", "label")


def load_withmask_h5(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(data, label, mask [B, N])`` (ref data_utils.py:255)."""
    return _load_fields(path, "data", "label", "mask")


def load_parts_h5(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(data, label, parts [B, N])`` (ref data_utils.py:271)."""
    return _load_fields(path, "data", "label", "parts")


def load_discriminator_h5(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(data, label, type [B])`` (ref data_utils.py:263)."""
    return _load_fields(path, "data", "label", "type")


def save_h5(
    path: str,
    data: np.ndarray,
    label: np.ndarray,
    mask: np.ndarray | None = None,
    parts: np.ndarray | None = None,
    model_type: np.ndarray | None = None,
) -> None:
    """Write a ScanObjectNN-format h5 container (the loaders' inverse): data
    as float32, label as int64, the optional fields as given."""
    with _h5py().File(path, "w") as f:
        f.create_dataset("data", data=np.asarray(data, dtype=np.float32))
        f.create_dataset("label", data=np.asarray(label, dtype=np.int64))
        for name, arr in (("mask", mask), ("parts", parts), ("type", model_type)):
            if arr is not None:
                f.create_dataset(name, data=np.asarray(arr))


def load_pc_file(path: str, suncg: bool = False, with_bg: bool = True) -> np.ndarray:
    """One raw ``.bin`` object file as ``[n, 3]`` float32 coordinates (ref
    data_utils.py:50-75).

    With ``with_bg=False`` only the points of the dominant semantic class
    (last column) other than 0, 1 and 2 (wall, floor, ceiling) are kept:
    a negative label such as -1 (unannotated) is a candidate too.  A cloud
    with no such point gives an empty ``[0, 3]`` cloud."""
    pc = np.fromfile(path, dtype=np.float32)
    if suncg:
        return np.array(pc[1:].reshape((-1, 3))[:, 0:3])
    pc = pc[1:].reshape((-1, _BIN_FLOATS_PER_POINT))
    if with_bg:
        return np.array(pc[:, 0:3])
    sem = pc[:, -1]
    fg = ~np.isin(sem, (0.0, 1.0, 2.0))
    if not np.any(fg):
        return np.empty((0, 3), dtype=np.float32)
    values, counts = np.unique(sem[fg], return_counts=True)
    return np.array(pc[sem == values[np.argmax(counts)], 0:3])


def load_data(
    path: str,
    num_points: int = 1024,
    suncg: bool = False,
    with_bg: bool = True,
    data_dir: str | None = None,
) -> tuple[list[np.ndarray], list[int]]:
    """A pickled file list of raw ``.bin`` objects as (clouds, labels) (ref
    data_utils.py:77-106): each entry's ``filename`` with its
    ``objects_bin/`` prefix removed and joined to ``data_dir`` where given;
    clouds of fewer than ``num_points`` points are dropped."""
    with open(path, "rb") as handle:
        entries = pickle.load(handle)
    pcs: list[np.ndarray] = []
    labels: list[int] = []
    for entry in entries:
        filename = entry["filename"].replace("objects_bin/", "")
        if data_dir is not None:
            filename = os.path.join(data_dir, filename)
        pc = load_pc_file(filename, suncg=suncg, with_bg=with_bg)
        if pc.shape[0] < num_points:
            continue
        pcs.append(pc)
        labels.append(entry["label"])
    return pcs, labels


def object_array(pcs: Sequence[np.ndarray]) -> np.ndarray:
    """A 1-D object array of the clouds, also where they are all one size."""
    out = np.empty(len(pcs), dtype=object)
    for i, pc in enumerate(pcs):
        out[i] = pc
    return out


def center_data(pcs: np.ndarray | Sequence[np.ndarray]):
    """Each cloud less its centroid (ref data_utils.py:162-169): an array
    ``[..., N, 3]`` keeps its dtype; a list gives a list, an object array
    of clouds an object array (the JAX function raises on one)."""
    if isinstance(pcs, np.ndarray) and pcs.dtype == object:
        return object_array(center_data(list(pcs)))
    if isinstance(pcs, np.ndarray):
        return (pcs - pcs.mean(axis=-2, keepdims=True)).astype(pcs.dtype, copy=False)
    return [pc - pc.mean(axis=0, keepdims=True) for pc in pcs]


def normalize_data(pcs: np.ndarray | Sequence[np.ndarray]):
    """Each cloud scaled by its largest point norm, into the unit sphere (ref
    data_utils.py:133-143): an array keeps its dtype; a list gives a list,
    an object array of clouds an object array (the JAX function raises on
    one)."""
    if isinstance(pcs, np.ndarray) and pcs.dtype == object:
        return object_array(normalize_data(list(pcs)))
    if isinstance(pcs, np.ndarray):
        d = np.sqrt((pcs**2).sum(axis=-1)).max(axis=-1)
        return (pcs / d[..., None, None]).astype(pcs.dtype, copy=False)
    return [pc / np.sqrt((pc**2).sum(axis=-1)).max() for pc in pcs]


def normalize_data_multiview(pcs: np.ndarray, num_view: int = 5) -> np.ndarray:
    """Each view of ``[B, V, N, 3]`` into the unit sphere (ref
    data_utils.py:145-159)."""
    d = np.sqrt((pcs**2).sum(axis=-1)).max(axis=-1)
    return pcs / d[..., None, None]


def convert_to_binary_mask(masks: np.ndarray) -> np.ndarray:
    """Mask -1 (background) -> 0, every other value -> 1, as float64
    (ref data_utils.py:280-290)."""
    return (np.asarray(masks) != -1).astype(np.float64)


def flip_types(types: np.ndarray) -> np.ndarray:
    """Type 0 -> True (ref data_utils.py:292-294)."""
    return np.asarray(types) == 0


def save_ply(
    points: np.ndarray,
    filename: str,
    colors: np.ndarray | None = None,
    normals: np.ndarray | None = None,
) -> None:
    """A binary little-endian PLY of one vertex element (ref
    data_utils.py:16-48): x y z as float, then nx ny nz (float) and red green
    blue (uchar, ``colors`` in [0, 1] times 255) where given."""
    points = np.asarray(points, dtype=np.float32)
    props = [("x", "f4"), ("y", "f4"), ("z", "f4")]
    columns = [points[:, 0], points[:, 1], points[:, 2]]
    if normals is not None:
        normals = np.asarray(normals, dtype=np.float32)
        props += [("nx", "f4"), ("ny", "f4"), ("nz", "f4")]
        columns += [normals[:, 0], normals[:, 1], normals[:, 2]]
    if colors is not None:
        colors = (np.asarray(colors) * 255).astype(np.uint8)
        props += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        columns += [colors[:, 0], colors[:, 1], colors[:, 2]]
    rec = np.empty(points.shape[0], dtype=props)
    for (name, _), col in zip(props, columns):
        rec[name] = col
    ply_type = {"f4": "float", "u1": "uchar"}
    header = (
        ["ply", "format binary_little_endian 1.0", f"element vertex {points.shape[0]}"]
        + [f"property {ply_type[fmt]} {name}" for name, fmt in props]
        + ["end_header"]
    )
    with open(filename, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        rec.tofile(f)


def load_ply(filename: str) -> dict[str, np.ndarray]:
    """The vertex properties of a PLY that ``save_ply`` wrote, by name."""
    ply_np = {"float": "f4", "uchar": "u1"}
    props: list[tuple[str, str]] = []
    n = 0
    with open(filename, "rb") as f:
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property"):
                _, typ, name = line.split()
                props.append((name, ply_np[typ]))
            elif line == "end_header":
                break
        rec = np.fromfile(f, dtype=props, count=n)
    return {name: rec[name] for name, _ in props}
