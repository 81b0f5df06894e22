"""PyTorch port, the SpiderCNN slice: the full-width ``spidercnn_cls_xyz``
forward on the CPU at B=2, N=128 (nsample 8, and 20 once) against the JAX
``SpiderCNNCls`` on the same weights, fused and ``fused=False``, in f32 and
bf16; the port's fused path against its unfused one; and the weights
carried across.

The JAX side runs ``model.apply(train=False)`` eagerly, taking the lax
paths (the CPU default: ``spider_conv_lax`` for the fused layers).  Random
positive BN running stats and random GroupNorm scales and biases make every
normalisation matter.

Neighbours.  Both sides take one kNN of the same xyz, but JAX's d² comes
from an einsum at HIGHEST precision and the port's from sums in ascending
channel order: a query whose k-th and (k+1)-th distances lie within
rounding may pick another k-th neighbour.  So the JAX model is fed the
port's graph (``scanobjectnn_tpu.ops.knn_graph`` patched in the test only),
after checking it against JAX's own ``knn_graph_lax`` on every row whose
float64 k/(k+1) gap exceeds 1e-4 x (1 + d²_(k+1)) (``clear_share`` of
``test_torch_dgcnn.py``); at least ``CLEAR_SHARE`` of the rows must clear it
(printed).

Tolerances (readings on these inputs in brackets): ``logits`` in f32 within
``F32_TOL`` x max(1, |ref|max), the SSG and DGCNN bound (the contraction and
the GroupNorm statistics sum in other orders) [at most 9.8e-7]; in bf16
within ``BF16_TOL`` x max(1, |ref|max), the SSG, BGA and DGCNN bf16 bound
(bf16 rounds at other points in the two frameworks) [6.4e-3 fused, 3.2e-3
unfused]; the predicted classes equal.  On every case 98.8-99.2% of the
rows cleared the margin.  Fused against unfused in the port: rtol 1e-4 /
atol 1e-5 x max(1, |ref|max), the bound of ``test_torch_dgcnn.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu import models as jzoo
from scanobjectnn_tpu import ops as jops
from scanobjectnn_torch.convert import init_params, load_jax_variables
from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
from scanobjectnn_torch.models import MODEL_REGISTRY, get_model, spidercnn

from tests.test_torch_dgcnn import clear_share

B, N = 2, 128
F32_TOL, BF16_TOL = 1e-4, 0.05  # module doc
MARGIN, CLEAR_SHARE = 1e-4, 0.9
DTYPES = {"f32": (jnp.float32, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def points():
    data, _ = make_synthetic_dataset(num_per_class=1, num_classes=B, num_points=N, seed=6)
    return data.astype(np.float32)


def jax_variables(points, nsample, seed=0):
    """JAX variables of ``spidercnn_cls_xyz`` at ``nsample`` (the conv
    kernels' rows depend on it): the reference init, random positive BN
    running stats, random GroupNorm scales and biases."""
    model = jzoo.get_model("spidercnn_cls_xyz", nsample=nsample)[0]
    key = jax.random.PRNGKey(seed)
    v = jax.jit(lambda x: model.init({"params": key, "dropout": key}, x, train=False))(jnp.asarray(points[:, :32]))
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.RandomState(seed + 1)
    for bn in v["batch_stats"].values():
        bn["mean"] = (0.05 * np.abs(rng.randn(*bn["mean"].shape))).astype(np.float32)
        bn["var"] = (0.1 + 0.1 * np.abs(rng.randn(*bn["var"].shape))).astype(np.float32)
    for i in range(1, 5):
        gn = v["params"][f"conv{i}"]["GroupNorm_0"]
        gn["scale"] = (1.0 + 0.3 * rng.randn(*gn["scale"].shape)).astype(np.float32)
        gn["bias"] = (0.2 * rng.randn(*gn["bias"].shape)).astype(np.float32)
    return v


@pytest.fixture(scope="module")
def variables(points):
    return {k: jax_variables(points, k) for k in (8, 20)}


def port_forward(model, points, monkeypatch):
    """The port's outputs on ``points`` and the kNN graph it took."""
    graphs = []
    gather = spidercnn.edge_gather_knn

    def recorded(feats, vals, k):
        out = gather(feats, vals, k)
        graphs.append(out[1].numpy())
        return out

    with monkeypatch.context() as mp, torch.no_grad():
        mp.setattr(spidercnn, "edge_gather_knn", recorded)
        out = model(torch.from_numpy(points))
    assert len(graphs) == 1
    return out, graphs[0]


def jax_forward(points, variables, graph, k, monkeypatch, **kw):
    """The JAX model's outputs on the port's ``graph`` (module doc), and the
    share of its rows checked against JAX's own kNN."""
    shares = []

    def given(feats, kk):
        assert kk == k
        if not isinstance(feats, jax.core.Tracer):
            shares.append(clear_share(feats, graph, k, MARGIN))
        return jnp.asarray(graph)

    with monkeypatch.context() as mp:
        mp.setattr(jops, "knn_graph", given)
        out = jzoo.get_model("spidercnn_cls_xyz", nsample=k, **kw)[0].apply(variables, jnp.asarray(points), train=False)
    assert len(shares) == 1
    return out, shares[0]


# (dtype, fused, nsample)
CASES = {
    "f32_fused_k8": ("f32", True, 8),
    "f32_unfused_k8": ("f32", False, 8),
    "bf16_fused_k8": ("bf16", True, 8),
    "bf16_unfused_k8": ("bf16", False, 8),
    "f32_fused_k20": ("f32", True, 20),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_match_jax_on_the_ports_graph(monkeypatch, points, variables, case):
    dtype, fused, k = CASES[case]
    jdtype, tdtype = DTYPES[dtype]
    model = load_jax_variables(
        get_model("spidercnn_cls_xyz", device="cpu", nsample=k, fused=fused, dtype=tdtype), variables[k]
    ).eval()
    got, graph = port_forward(model, points, monkeypatch)
    assert graph.shape == (B, N, k) and (graph[..., 0] == np.arange(N)).all()  # the self edge first
    ref, share = jax_forward(points, variables[k], graph, k, monkeypatch, fused=fused, dtype=jdtype)
    print(f"{case}: share of rows checked against JAX's kNN {share:.4f}")
    assert share >= CLEAR_SHARE
    assert sorted(got) == sorted(ref) == ["end_points", "logits"]
    out, want = got["logits"], np.asarray(ref["logits"], np.float32)
    assert out.shape == want.shape == (B, 15) and out.dtype == (tdtype or torch.float32)
    out = out.float().numpy()
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(want).max()) > 0.1  # the activations did not vanish
    err = float(np.abs(out - want).max()) / scale
    print(f"{case}: logits max err / scale {err:.3e}")
    assert err <= (BF16_TOL if dtype == "bf16" else F32_TOL)
    assert (out.argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_fused_matches_unfused(points, variables, train):
    # In training the GroupNorm'd layer outputs are compared, and the
    # logits only in eval: a training BN over the B=2 clouds normalises the
    # difference of two rows, which amplifies rounding without bound.
    outs = {}
    for fused in (True, False):
        model = load_jax_variables(get_model("spidercnn_cls_xyz", device="cpu", nsample=8, fused=fused), variables[8])
        model.train(train)
        feats = []
        hooks = [getattr(model, f"conv{i}").register_forward_hook(lambda m, a, o: feats.append(o)) for i in range(1, 5)]
        with torch.no_grad():
            out = model(torch.from_numpy(points), 0.9, torch.Generator().manual_seed(0))
        for h in hooks:
            h.remove()
        outs[fused] = feats if train else feats + [out["logits"]]
    assert len(outs[True]) == len(outs[False]) == (4 if train else 5)
    for got, want in zip(outs[True], outs[False]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * max(1.0, float(want.abs().max())))


def test_state_dict_names_match_jax_tree(points, variables):
    for k in (8, 20):
        model = get_model("spidercnn_cls_xyz", device="cpu", nsample=k)
        load_jax_variables(model, variables[k])  # strict: every name and shape matches
        params = dict(model.named_parameters())
        assert params["conv1.conv.kernel"].shape == (k * 3 * 5, 32)
        assert params["conv4.conv.kernel"].shape == (k * 128 * 5, 256)
        assert params["conv2.taylor_weights"].shape == (20, 5)
        assert params["conv3.GroupNorm_0.scale"].shape == (128,)
        assert params["fc1.kernel"].shape == (960, 1024)
        assert params["fc3.kernel"].shape == (512, 15)
        assert sorted(n for n, _ in model.named_buffers()) == ["bn1.mean", "bn1.var", "bn2.mean", "bn2.var"]
    default = get_model("spidercnn_cls_xyz", device="cpu")
    assert default.nsample == 20 and default.dropout_keep == 0.3 and default.conv1.fused
    assert next(default.parameters()).device.type == "cpu"
    init_params(default, torch.Generator().manual_seed(3))
    w = default.conv2.taylor_weights.detach()
    limit = float(np.sqrt(6.0 / 25))
    assert bool(w.any()) and float(w.abs().max()) <= limit  # Glorot-uniform over (20, 5)
    assert bool((default.conv2.GroupNorm_0.scale == 1).all()) and not bool(default.conv2.GroupNorm_0.bias.any())


def test_registry_and_loss():
    assert MODEL_REGISTRY["spidercnn_cls_xyz"].kind == jzoo.MODEL_REGISTRY["spidercnn_cls_xyz"].kind == "cls"
    rng = np.random.RandomState(0)
    logits, labels = rng.randn(6, 15).astype(np.float32), rng.randint(0, 15, 6)
    got = MODEL_REGISTRY["spidercnn_cls_xyz"].loss({"logits": torch.from_numpy(logits)},
                                                   {"labels": torch.from_numpy(labels)})[1]
    want = jzoo.get_model("spidercnn_cls_xyz")[1]({"logits": jnp.asarray(logits)}, {"labels": jnp.asarray(labels)})[1]
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-6, err_msg=key)
