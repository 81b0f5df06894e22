"""PyTorch port, PointNet++ MSG at eval: ``SAModuleMSG``, ``SAModule``'s kNN
and K > 64 branches, and the full-width ``pointnet2_cls_msg``, on the CPU,
against the JAX package on the same inputs and weights (numpy seeds; random
positive BN running stats, so the BN fold matters).

Modules, against the JAX module run as its own tests run it
(``SCANOBJECTNN_FUSED_SA_EVAL=interpret``: the fused Pallas kernels in
interpret mode where JAX takes them, the unfused chain elsewhere):
  * ``SAModuleMSG`` in the cases of ``tests/test_samlp_fused.py``: mixed K
    8/16/80/72 without points (8 and 16 fused, 80 fused on the chunked
    path, 72 unfused); a second layer with 24 point channels, whose scales
    are lifted (24 + 3 > 8), at K 8/16 and at K 16/72 (the lifted scale
    unfused, ``LiftedGroupMLP`` at eval); ``use_xyz=False``; and an
    ``npoint`` that is not a multiple of 8 (every scale unfused);
  * ``SAModule`` with ``knn=True`` (with and without the coordinates,
    with and without point features) and with ``nsample=128`` (the ball
    group, then #10's plain version ``sa_mlp_pool``).
The model: ``pointnet2_cls_msg`` logits at B=2, N=1024 against the JAX lax
path (``SCANOBJECTNN_FUSED_SA_EVAL=off``), predicted classes equal.

Tolerances: f32 rtol 2e-4, atol 2e-5 (the modules) and 2e-5 x max(1,
|ref|max) (the logits), those of ``test_torch_pointnet2_ssg.py``.  The
unfused JAX chain's lax ball query tests ``sqrt`` of the EXPANDED distance
and the lax kNN ranks expanded distances too, so a point within rounding of
a ball's boundary, or a near-tie at the k-th neighbour, could flip; the
inputs are pinned instead of loosening the bound: no (centroid, point) pair
lies within 1e-6 of a radius², and every kNN row's k-th and (k+1)-th
squared distances (float64) are more than 1e-5 apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu import models as jzoo
from scanobjectnn_tpu.nn.pointnet_modules import SAModule as JSAModule
from scanobjectnn_tpu.nn.pointnet_modules import SAModuleMSG as JSAModuleMSG
from scanobjectnn_torch.convert import load_jax_variables
from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
from scanobjectnn_torch.models import MODEL_REGISTRY, PointNet2ClsMSG, PointNet2ClsSSG, get_model, get_recipe
from scanobjectnn_torch.nn.pointnet_modules import GroupMLPPool, LiftedGroupMLP, SAModule, SAModuleMSG

RTOL, ATOL = 2e-4, 2e-5


def random_stats(variables, rng):
    """``variables`` with random positive BN running stats."""
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(
            0.1 + 0.1 * np.abs(rng.randn(*a.shape)) if p[-1].key == "var" else 0.05 * np.abs(rng.randn(*a.shape)),
            jnp.float32,
        ),
        variables["batch_stats"],
    )
    return {**variables, "batch_stats": stats}


def pin_off_boundaries(queries, points, radii):
    """No (query, point) pair within 1e-6 of a radius² (module doc)."""
    d2 = ((queries[:, :, None, :].astype(np.float64) - points[:, None, :, :]) ** 2).sum(-1)
    for radius in radii:
        assert np.abs(d2 - radius * radius).min() > 1e-6


def _centroids(xyz, npoint):
    from scanobjectnn_torch import ops

    return ops.gather_point(torch.from_numpy(xyz), ops.farthest_point_sample(torch.from_numpy(xyz), npoint)).numpy()


def _run(monkeypatch, jmodule, tmodule, xyz, pts, mode="interpret"):
    """(JAX output, port output) of the eval forward on the same weights."""
    v = jmodule.init(jax.random.PRNGKey(0), jnp.asarray(xyz), None if pts is None else jnp.asarray(pts), train=False)
    v = random_stats(v, np.random.RandomState(5))
    monkeypatch.setenv("SCANOBJECTNN_FUSED_SA_EVAL", mode)
    monkeypatch.setenv("SCANOBJECTNN_SA_BUCKET", "off")
    ref = jmodule.apply(v, jnp.asarray(xyz), None if pts is None else jnp.asarray(pts), train=False)
    load_jax_variables(tmodule, v).eval()
    with torch.no_grad():
        got = tmodule(torch.from_numpy(xyz), None if pts is None else torch.from_numpy(pts))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))  # the centroids
    return np.asarray(ref[1]), got[1].numpy()


# name: (b, n, channels, npoint, radii, K, mlps, use_xyz)
MSG_CASES = {
    "l1_mixed_k": (2, 256, 0, 64, (0.2, 0.4, 0.6, 0.8), (8, 16, 80, 72), ((8, 16),) * 4, True),
    "l2_lifted": (2, 128, 24, 32, (0.3, 0.6), (8, 16), ((8, 16), (8, 16)), True),
    "l2_lifted_k72": (2, 128, 24, 32, (0.3, 0.7), (16, 72), ((8, 16), (8, 12, 16)), True),
    "use_xyz_false": (1, 128, 8, 32, (0.4,), (8,), ((16, 16),), False),
    "npoint_not_multiple_of_8": (2, 128, 0, 30, (0.3, 0.6), (8, 16), ((8, 16), (8, 16)), True),
}


@pytest.mark.parametrize("case", sorted(MSG_CASES))
def test_msg_module_matches_jax(monkeypatch, case):
    b, n, c, npoint, radii, ks, mlps, use_xyz = MSG_CASES[case]
    rng = np.random.RandomState(n + c + npoint)
    xyz = (rng.randn(b, n, 3) * 0.5).astype(np.float32)
    pts = rng.randn(b, n, c).astype(np.float32) if c else None
    pin_off_boundaries(_centroids(xyz, npoint), xyz, radii)
    jm = JSAModuleMSG(npoint=npoint, radius_list=radii, nsample_list=ks, mlp_list=mlps, use_xyz=use_xyz)
    tm = SAModuleMSG(npoint, radii, ks, mlps, in_channels=c, use_xyz=use_xyz)
    lifted = [isinstance(getattr(tm, f"mlp_scale{i}"), LiftedGroupMLP) for i in range(len(ks))]
    assert lifted == [case.startswith("l2")] * len(ks)
    ref, got = _run(monkeypatch, jm, tm, xyz, pts)
    assert got.shape == (b, npoint, sum(m[-1] for m in mlps)) and float(np.abs(ref).max()) > 0.1
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


# name: (b, n, channels, npoint, radius, K, mlp, knn, use_xyz)
SA_CASES = {
    "knn_features": (2, 256, 8, 32, None, 16, (16, 32), True, True),
    "knn_features_no_xyz": (2, 256, 8, 32, None, 16, (16, 32), True, False),
    "knn_xyz_only": (1, 256, 0, 32, None, 24, (16, 16), True, True),
    "ball_k128_features": (2, 256, 8, 32, 1.0, 128, (16, 32), False, True),
}


@pytest.mark.parametrize("case", sorted(SA_CASES))
def test_sa_module_knn_and_large_k_match_jax(monkeypatch, case):
    b, n, c, npoint, radius, k, mlp, knn, use_xyz = SA_CASES[case]
    rng = np.random.RandomState(n + c + k)
    xyz = (rng.randn(b, n, 3) * 0.5).astype(np.float32)
    pts = rng.randn(b, n, c).astype(np.float32) if c else None
    queries = _centroids(xyz, npoint)
    if knn:
        d2 = np.sort(((queries[:, :, None, :].astype(np.float64) - xyz[:, None, :, :]) ** 2).sum(-1), axis=-1)
        assert (d2[..., k] - d2[..., k - 1]).min() > 1e-5  # pinned off near-ties (module doc)
    else:
        pin_off_boundaries(queries, xyz, (radius,))
    jm = JSAModule(npoint, radius, k, mlp, knn=knn, use_xyz=use_xyz)
    tm = SAModule(npoint, radius, k, mlp, in_channels=c, knn=knn, use_xyz=use_xyz)
    ref, got = _run(monkeypatch, jm, tm, xyz, pts)
    assert got.shape == (b, npoint, mlp[-1]) and float(np.abs(ref).max()) > 0.1
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def points():
    data, _ = make_synthetic_dataset(num_per_class=1, num_classes=2, num_points=1024, seed=3)
    return data.astype(np.float32)


@pytest.fixture(scope="module")
def variables():
    """JAX variables of ``pointnet2_cls_msg``: the tree of the JAX model's
    init (traced by ``jax.eval_shape``, which compiles nothing), filled with
    the port's seeded reference init by name (every JAX leaf must exist in
    the port with its shape), and random positive BN running stats."""
    model, _, _ = jzoo.get_model("pointnet2_cls_msg")
    key = jax.random.PRNGKey(0)
    tree = jax.eval_shape(lambda: model.init({"params": key, "dropout": key}, jnp.zeros((2, 128, 3)), train=False))
    port = get_model("pointnet2_cls_msg", device="cpu").state_dict()

    def fill(path, leaf):
        value = port[".".join(p.key for p in path[1:])].numpy()
        assert value.shape == leaf.shape, path
        return jnp.asarray(value)

    return random_stats(jax.tree_util.tree_map_with_path(fill, dict(tree)), np.random.RandomState(1))


def test_msg_logits_match_jax_lax_path(monkeypatch, points, variables):
    tmodel = load_jax_variables(get_model("pointnet2_cls_msg", device="cpu"), variables).eval()
    with torch.no_grad():
        xyz1, feats1 = tmodel.sa1(torch.from_numpy(points), None)
        xyz2, _ = tmodel.sa2(xyz1, feats1)
    for (_, radii, *_), pts, queries in zip(
        PointNet2ClsMSG.MSG_CONFIGS, (points, xyz1.numpy()), (xyz1.numpy(), xyz2.numpy())
    ):
        pin_off_boundaries(queries, pts, radii)
    monkeypatch.setenv("SCANOBJECTNN_FUSED_SA_EVAL", "off")
    jmodel = jzoo.get_model("pointnet2_cls_msg")[0]
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(points), train=False)["logits"], np.float32)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(points))["logits"]
    assert got.shape == (2, 15) and got.dtype == torch.float32
    got = got.numpy()
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(ref).max()) > 0.1  # the activations did not vanish
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL * scale)
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))


def test_state_dict_names_match_jax_tree(variables):
    tmodel = get_model("pointnet2_cls_msg", device="cpu")
    load_jax_variables(tmodel, variables)  # strict: every name and shape matches, both ways
    assert tmodel.sa2.mlp_scale2.dense_0.kernel.shape == (320 + 3, 128)
    assert all(isinstance(getattr(tmodel.sa1, f"mlp_scale{i}"), GroupMLPPool) for i in range(3))
    assert all(isinstance(getattr(tmodel.sa2, f"mlp_scale{i}"), LiftedGroupMLP) for i in range(3))
    assert tmodel.sa3.mlp.dense_0.kernel.shape == (640 + 3, 256)


def test_registry_entry():
    assert MODEL_REGISTRY["pointnet2_cls_msg"] is PointNet2ClsMSG
    assert PointNet2ClsMSG.kind == jzoo.MODEL_REGISTRY["pointnet2_cls_msg"].kind == "cls"
    assert PointNet2ClsMSG.loss is PointNet2ClsSSG.loss and get_recipe("pointnet2_cls_msg") is None


def test_get_model_defaults_to_the_card():
    # Built on the CPU, then moved: without a card the default device fails
    # at the move, which shows the default.
    if torch.cuda.is_available():
        assert next(get_model("pointnet2_cls_msg").parameters()).is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            get_model("pointnet2_cls_msg")
    assert next(get_model("pointnet2_cls_msg", device="cpu").parameters()).device.type == "cpu"
