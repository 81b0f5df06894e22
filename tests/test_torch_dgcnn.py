"""PyTorch port, the DGCNN slice: full-width ``dgcnn`` and ``dgcnn_bga``
forwards on the CPU at B=2, N=128 (k=8, 20 and 40) against the JAX models on
the same weights, in f32 and bf16; the port's fused EdgeConv path against
its unfused one; and the weights carried across.

The JAX side runs ``model.apply(train=False)`` eagerly, taking the lax
paths (the CPU default).  Random positive BN running stats (the edge BNs'
included) make every BN matter.

Neighbours.  JAX's d² comes from an einsum at HIGHEST precision, the
port's from sums in ascending channel order, and from EdgeConv 2 on the
layer inputs themselves differ by rounding: a query whose k-th and
(k+1)-th distances lie within that difference may pick another k-th
neighbour, and the rest of the model would then differ by far more than
rounding.  So the JAX model is fed the port's neighbour indices
(``scanobjectnn_tpu.models.dgcnn.edge_reduce`` and
``scanobjectnn_tpu.ops.knn_graph`` patched in the test only), and each of
the five graphs (T-Net, EdgeConv 1-4) is checked against JAX's own
``knn_graph_lax`` on the JAX layer input, on every row whose float64 gap
between the k-th and (k+1)-th distance exceeds ``MARGIN[dtype]`` x (1 +
d²_(k+1)): 1e-4 in f32 (the layer inputs agree to about 1e-6 of their
scale), 5e-2 in bf16 (an input may differ by a bf16 ulp, 2^-8).  In f32 at
least ``CLEAR_SHARE`` of the rows must clear it (printed).

Tolerances: ``logits`` and ``seg_logits`` in f32 within 1e-4 x max(1,
|ref|max) (the SSG bound; the edge BN statistics and the T-Net's transform
reassociate sums); in bf16 within 0.05 x max(1, |ref|max), the SSG and BGA
bf16 bound (bf16 rounds at other points in the two frameworks).  The
predicted classes must be equal, and at least 99% of the per-point argmaxes
of ``seg_logits``.  Fused against unfused in the port: rtol 1e-4 / atol
1e-5 x max(1, |ref|max), the JAX package's bound for that comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu import models as jzoo
from scanobjectnn_tpu import ops as jops
from scanobjectnn_tpu.models import dgcnn as jdgcnn
from scanobjectnn_tpu.ops import grouping as jgrouping
from scanobjectnn_tpu.ops.pallas import edge_kernel as jedge
from scanobjectnn_torch.convert import init_params, load_jax_variables
from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
from scanobjectnn_torch.models import MODEL_REGISTRY, dgcnn, get_model

DTYPES = {"f32": (jnp.float32, None), "bf16": (jnp.bfloat16, torch.bfloat16)}
MODELS = ("dgcnn", "dgcnn_bga")
B, N, CLASSES = 2, 128, 15
F32_TOL, BF16_TOL, SEG_AGREEMENT = 1e-4, 0.05, 0.99
MARGIN = {"f32": 1e-4, "bf16": 5e-2}
CLEAR_SHARE = 0.9


@pytest.fixture(scope="module")
def points():
    data, _ = make_synthetic_dataset(num_per_class=1, num_classes=B, num_points=N, seed=5)
    return data.astype(np.float32)


def jax_variables(name, points, seed=0):
    """JAX variables of ``name`` (their shapes do not depend on k or N): the
    reference init with random positive BN running stats."""
    model = jzoo.get_model(name, k=8)[0]
    key = jax.random.PRNGKey(seed)
    v = jax.jit(lambda x: model.init({"params": key, "dropout": key}, x, train=False))(jnp.asarray(points[:, :32]))
    rng = np.random.RandomState(seed + 1)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(
            0.1 + 0.1 * np.abs(rng.randn(*a.shape)) if p[-1].key == "var" else 0.05 * np.abs(rng.randn(*a.shape)),
            jnp.float32,
        ),
        v["batch_stats"],
    )
    return {**v, "batch_stats": stats}


@pytest.fixture(scope="module")
def variables(points):
    return {name: jax_variables(name, points) for name in MODELS}


class PortGraphs:
    """Records the neighbour indices of the port's five graphs, in call
    order (T-Net, EdgeConv 1-4), by wrapping the two functions the model
    calls them through."""

    def __init__(self, monkeypatch):
        self.idx = []
        gather, reduce = dgcnn.edge_gather_knn, dgcnn.edge_reduce

        def gather_rec(feats, vals, k):
            out = gather(feats, vals, k)
            self.idx.append(out[1].numpy())
            return out

        def reduce_rec(feats, vals, k):
            out = reduce(feats, vals, k)
            self.idx.append(out["idx"].numpy())
            return out

        monkeypatch.setattr(dgcnn, "edge_gather_knn", gather_rec)
        monkeypatch.setattr(dgcnn, "edge_reduce", reduce_rec)


def clear_share(feats, port_idx, k, margin):
    """Check ``port_idx`` against JAX's own kNN of the JAX layer input
    ``feats`` on the rows that clear the margin (module doc); returns the
    share of rows checked."""
    x = np.asarray(jnp.asarray(feats).astype(jnp.float32)).astype(np.float64)
    d = ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)
    ds = np.sort(d, axis=-1)
    clear = ds[..., k] - ds[..., k - 1] > margin * (1.0 + ds[..., k])
    own = np.asarray(jgrouping.knn_graph_lax(jnp.asarray(feats), k))
    same = (np.sort(own, -1) == np.sort(port_idx, -1)).all(-1)
    assert same[clear].all(), f"{int((~same & clear).sum())} clear rows pick other neighbours"
    return float(clear.mean())


def feed_jax(monkeypatch, graphs, margin, shares, checked=True):
    """Patch the JAX model to use the port's ``graphs`` in call order,
    appending each graph's checked share to ``shares`` when its layer input
    is concrete and ``checked``."""
    calls = iter(range(len(graphs)))

    def given(feats, k):
        idx = graphs[next(calls)]
        if checked and not isinstance(feats, jax.core.Tracer):
            shares.append(clear_share(feats, idx, k, margin))
        return jnp.asarray(idx)

    def edge_reduce(feats, vals, k):
        idx = given(feats, k)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jgrouping, "knn_graph_lax", lambda f, kk: idx)
            return jedge.edge_reduce_lax(feats, vals, k)

    monkeypatch.setattr(jdgcnn, "edge_reduce", edge_reduce)
    monkeypatch.setattr(jops, "knn_graph", given)


@pytest.mark.parametrize("k", [8, 20, 40])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", MODELS)
def test_matches_jax_on_the_ports_graphs(monkeypatch, points, variables, name, dtype, k):
    jdtype, tdtype = DTYPES[dtype]
    tmodel = load_jax_variables(get_model(name, device="cpu", dtype=tdtype, k=k), variables[name]).eval()
    with monkeypatch.context() as mp:
        rec = PortGraphs(mp)
        with torch.no_grad():
            got = tmodel(torch.from_numpy(points))
    assert len(rec.idx) == 5 and all(i.shape == (B, N, k) for i in rec.idx)
    shares = []
    feed_jax(monkeypatch, rec.idx, MARGIN[dtype], shares)
    ref = jzoo.get_model(name, dtype=jdtype, k=k)[0].apply(variables[name], jnp.asarray(points), train=False)
    print(f"{name} {dtype} k={k}: shares of rows checked per graph {[round(s, 4) for s in shares]}")
    assert len(shares) == 5
    if dtype == "f32":
        assert min(shares) >= CLEAR_SHARE
    assert sorted(got) == sorted(ref)
    for key in ("logits", "seg_logits"):
        if key not in ref:
            continue
        want = np.asarray(ref[key], np.float32)
        out = got[key]
        assert out.shape == want.shape and out.dtype == (tdtype or torch.float32), key
        out = out.float().numpy()
        scale = max(1.0, float(np.abs(want).max()))
        assert float(np.abs(want).max()) > 0.1  # the activations did not vanish
        err = float(np.abs(out - want).max()) / scale
        print(f"{name} {dtype} k={k} {key}: max err / scale {err:.3e}")
        assert err <= (BF16_TOL if dtype == "bf16" else F32_TOL)
        agree = float((out.argmax(-1) == want.argmax(-1)).mean())
        assert agree >= (1.0 if key == "logits" else SEG_AGREEMENT), (key, agree)


def _unfuse(model):
    for mod in model.modules():
        if isinstance(mod, (dgcnn.EdgeConv, dgcnn.EdgeTransformNet)):
            mod.fused = False
    return model


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", MODELS)
def test_fused_matches_unfused(points, variables, name, train):
    # In training the trunk's output and the BN running stats are compared,
    # but not the logits: a training BN over the B=2 clouds (the head's bn1,
    # the T-Net's fc.bn_0) normalises the difference of two rows, which
    # amplifies rounding without bound, and so moves the layer after it
    # (the head, the T-Net's fc.bn_1 statistics; its transform output is the
    # identity at init, so the trunk does not see it).
    outs, stats = {}, {}
    for fused in (True, False):
        model = load_jax_variables(get_model(name, device="cpu", k=20), variables[name])
        if not fused:
            _unfuse(model)
        model.train(train)
        with torch.no_grad():
            x = torch.from_numpy(points)
            outs[fused] = {"agg": model.trunk(x, 0.9)[0]} if train else model(x)
        stats[fused] = {n: b.clone() for n, b in model.named_buffers()}
    for key, want in outs[False].items():
        if torch.is_tensor(want):
            scale = max(1.0, float(want.abs().max()))
            torch.testing.assert_close(outs[True][key], want, rtol=1e-4, atol=1e-5 * scale)
    for key, want in stats[False].items():
        if not key.startswith("trunk.tnet.fc.bn_1."):
            torch.testing.assert_close(stats[True][key], want, rtol=1e-4, atol=1e-6, msg=key)


@pytest.mark.parametrize("name", MODELS)
def test_state_dict_names_match_jax_tree(points, variables, name):
    tmodel = get_model(name, device="cpu")
    load_jax_variables(tmodel, variables[name])  # strict: every name and shape matches
    params = dict(tmodel.named_parameters())
    assert params["trunk.edgeconv1.mlp.dense_0.kernel"].shape == (6, 64)
    assert params["trunk.edgeconv4.mlp.dense_0.kernel"].shape == (128, 128)
    assert params["trunk.tnet.mlp1.dense_1.kernel"].shape == (64, 128)
    assert params["trunk.agg.dense_0.kernel"].shape == (320, 1024)
    assert isinstance(tmodel.trunk.edgeconv2.mlp.bn_0, dgcnn._PairBN)
    assert "trunk.edgeconv2.mlp.bn_0.mean" in dict(tmodel.named_buffers())
    if name == "dgcnn_bga":
        assert params["seg_mlp.dense_0.kernel"].shape == (256 + 1024 + 320, 512)
        assert params["seg_out.kernel"].shape == (256, 2)
    # The T-Net's transform starts at zero, so the transform is the identity,
    # in JAX's init and in the port's.
    assert not jnp.any(variables[name]["params"]["trunk"]["tnet"]["transform"]["kernel"])
    init_params(tmodel, torch.Generator().manual_seed(3))
    assert not bool(tmodel.trunk.tnet.transform.kernel.any())
    assert bool(tmodel.trunk.tnet.fc.dense_0.kernel.any())
    with torch.no_grad():
        t = tmodel.trunk.tnet.eval()(torch.from_numpy(points))
    assert torch.equal(t, torch.eye(3).expand(B, 3, 3))


def test_registry_and_losses():
    assert MODEL_REGISTRY["dgcnn"].kind == jzoo.MODEL_REGISTRY["dgcnn"].kind == "cls"
    assert MODEL_REGISTRY["dgcnn_bga"].kind == jzoo.MODEL_REGISTRY["dgcnn_bga"].kind == "seg"
    rng = np.random.RandomState(0)
    logits, labels = rng.randn(6, 15).astype(np.float32), rng.randint(0, 15, 6)
    masks, seg = rng.randint(0, 2, (6, 32)), rng.randn(6, 32, 2).astype(np.float32)
    outs = {"logits": logits, "seg_logits": seg}
    batch = {"labels": labels, "masks": masks}
    for name in MODELS:
        got = MODEL_REGISTRY[name].loss({k: torch.from_numpy(v) for k, v in outs.items()},
                                        {k: torch.from_numpy(v) for k, v in batch.items()})[1]
        want = jzoo.get_model(name)[1]({k: jnp.asarray(v) for k, v in outs.items()},
                                       {k: jnp.asarray(v) for k, v in batch.items()})[1]
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-6, err_msg=f"{name} {key}")
