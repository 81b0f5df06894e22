"""A visual check of the FP layers' inverse-distance interpolation
(counterpart of ``scanobjectnn_tpu/viz/interp_check.py``; the reference's
pointnet2/tf_ops/3d_interpolation/visu_interpolation.py).

Colours known at 4 anchors are interpolated onto 100 random query points
through the port's ``three_nn`` and ``three_interpolate``
(``ops/interpolate.py``: the kNN kernel and the gather kernel on a CUDA
tensor, their plain versions on a CPU one), with the reference's 1e-10
distance clamp, and three frames are rendered with ``viz.show3d``'s splat
and written as PNGs: the anchors, the queries, both.

Run: ``python -m scanobjectnn_torch.viz.interp_check [out_dir] [--device
cpu]`` (the card unless ``--device cpu``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from scanobjectnn_torch.ops import interpolate as interp

__all__ = ["interpolated_colors", "main"]


def interpolated_colors(
    xyz1: np.ndarray, xyz2: np.ndarray, colors2: np.ndarray, device: str | torch.device = "cuda"
) -> np.ndarray:
    """Colours interpolated from the known points ``xyz2`` (with
    ``colors2``) onto the queries ``xyz1``, on ``device``: [N, 3] f32."""
    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32)[None], device=device)

    dist, idx = interp.three_nn(put(xyz1), put(xyz2))
    weight = interp.three_interpolate_weights(dist)
    return interp.three_interpolate(put(colors2), idx, weight)[0].cpu().numpy()


def main(out_dir: str = ".", seed: int = 0, device: str | torch.device = "cuda") -> list[str]:
    """Write the three frames into ``out_dir``; returns their paths."""
    from scanobjectnn_torch.viz.render import save_image_rgb
    from scanobjectnn_torch.viz.show3d import render_frame

    rng = np.random.RandomState(seed)
    colors2 = np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    xyz1 = rng.random_sample((100, 3)).astype(np.float32)
    xyz2 = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 1]], np.float32)
    colors1 = interpolated_colors(xyz1, xyz2, colors2, device)

    frames = {
        "interp_known.png": (xyz2, colors2),
        "interp_queries.png": (xyz1, colors1),
        "interp_all.png": (np.concatenate([xyz1, xyz2]), np.concatenate([colors1, colors2])),
    }
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for name, (pts, cols) in frames.items():
        path = os.path.join(out_dir, name)
        save_image_rgb(path, render_frame(pts, cols, size=400, radius=8))
        paths.append(path)
    return paths


if __name__ == "__main__":
    parser = argparse.ArgumentParser(prog="python -m scanobjectnn_torch.viz.interp_check")
    parser.add_argument("out_dir", nargs="?", default=".")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="'cuda' (the card; raises without one) or 'cpu'")
    args = parser.parse_args()
    for p in main(args.out_dir, args.seed, args.device):
        print(f"wrote {p}")
