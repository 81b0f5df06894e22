"""PyTorch port, the bucketed SA layer (#4) and its dispatch.

``sa_ball_mlp_pool_bucketed_plain`` (the CUDA kernel's plain version, which
the wrapper runs for CPU tensors) against the JAX ``sa_ball_mlp_pool(...,
interpret=True, need_idx=False)`` with ``SCANOBJECTNN_SA_BUCKET`` set, which
runs the interpreted ``sa_ball_mlp_pool_bucketed``, at
``tests/test_sabucket.py``'s shapes and clouds (B=2, N=1024, M=256, K=16,
(W, T, G) = (640, 32, 128); with features N=512, M=128), in the sparse
(every ball holds at most K hits), dense (some hold more) and overflow (a
tile's key range spans more than W points) regimes, f32 and bf16.
Tolerances are ``tests/test_torch_safused.py``'s: f32 rtol 2e-4 / atol
2e-5; bf16 0.035 x max(1, |ref|max).  The port's bucketed output must also
equal its own #3 plain version (``sa_ball_mlp_pool_plain``) bit for bit,
and its per-tile overflow flags the host replica of ``test_sabucket.py``'s
``_gate`` taken per tile.

The dispatch: ``bucket_eligible`` and ``resolve_bucket_config`` against
JAX's; ``sa_bucket`` per model ("auto" by default, "off"); the SSG logits at
B=2, N=2048 equal under both settings, SA1 through #4 under "auto", and
within the f32 tolerance of the JAX model's lax path (inputs pinned off the
ball boundaries, as ``tests/test_torch_pointnet2_ssg.py`` does).  The
kernel itself is held to the plain version by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu import models as jzoo
from scanobjectnn_tpu.ops.pallas import sabucket_kernel as jsab
from scanobjectnn_tpu.ops.pallas.safused_kernel import sa_ball_mlp_pool as jax_sa
from scanobjectnn_torch.convert import load_jax_variables
from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
from scanobjectnn_torch.models import PointNet2ClsSSG, get_model
from scanobjectnn_torch.nn import pointnet_modules
from scanobjectnn_torch.nn.pointnet_modules import configure_eval
from scanobjectnn_torch.ops.cuda import sabucket_kernel as sab
from scanobjectnn_torch.ops.cuda.safused_kernel import sa_ball_mlp_pool_plain
from tests.test_sabucket import B, CFG, FEATS, K, M, RADIUS, _cloud, _gate

WTG = tuple(int(v) for v in CFG.split(","))
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# regime -> (tiles overflow?, some ball holds more than K?)
REGIMES = {"sparse": (False, False), "dense": (False, True), "overflow": (True, None), "mixed_axes": (False, True)}


def _gate_tiles(xyz, q, radius, wlen, qtile, gblk):
    """``test_sabucket._gate``'s host replica, per tile: [B, M/T] bool."""
    b, n, _ = xyz.shape
    m = q.shape[1]
    ext = xyz.max(1) - xyz.min(1)
    flags = np.zeros((b, m // qtile), bool)
    for i in range(b):
        ax = int(np.argmax(ext[i]))
        key, qk = np.sort(xyz[i, :, ax]), np.sort(q[i, :, ax])
        pad = radius * (1 + 1e-5) + 1e-6
        for t in range(m // qtile):
            s = np.searchsorted(key, qk[t * qtile] - pad, "left")
            e = np.searchsorted(key, qk[(t + 1) * qtile - 1] + pad, "right")
            flags[i, t] = e - min(s // gblk, n // gblk - wlen // gblk) * gblk > wlen
    return flags


def _weights(rng, widths):
    ws = [(rng.normal(size=(a, c)) * 0.1).astype(np.float32) for a, c in zip(widths, widths[1:])]
    bs = [(rng.normal(size=(c,)) * 0.1).astype(np.float32) for c in widths[1:]]
    return ws, bs


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _jax_bucketed(cfg, radius, k, pts, q, src, ws, bs, dtype, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCANOBJECTNN_SA_BUCKET", cfg)
        out, idx = jax_sa(
            radius, k, jnp.asarray(pts), jnp.asarray(q), None if src is None else jnp.asarray(src),
            [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs], dtype=dtype, interpret=True,
            need_idx=False, **kw,
        )
    assert idx is None  # the bucketed kernel ran
    return np.asarray(out, np.float32)


def _check(got, ref, dtype):
    g = got.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(g, ref, rtol=2e-4, atol=2e-5)
    else:
        assert np.abs(g - ref).max() < 0.035 * max(1.0, float(np.abs(ref).max()))


@pytest.fixture(scope="module")
def no_src_weights():
    return _weights(np.random.default_rng(7), (3,) + FEATS)


@pytest.fixture(scope="module", params=sorted(REGIMES))
def regime(request, no_src_weights):
    """(name, points, queries, JAX's outputs by dtype)."""
    pts = np.asarray(_cloud(request.param))
    q = pts[:, :M]
    ws, bs = no_src_weights
    refs = {d: _jax_bucketed(CFG, RADIUS, K, pts, q, None, ws, bs, jd) for d, (jd, _) in DTYPES.items()}
    return request.param, pts, q, refs


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_jax_interpreted_and_port_full_layer(regime, no_src_weights, dtype):
    name, pts, q, refs = regime
    ws, bs = [[_t(a) for a in group] for group in no_src_weights]
    tdtype = DTYPES[dtype][1]
    got, idx = sab.sa_ball_mlp_pool_bucketed_plain(RADIUS, K, _t(pts), _t(q), None, ws, bs, dtype=tdtype,
                                                   window=WTG[0], qtile=WTG[1], gblk=WTG[2])
    assert idx is None and got.dtype == tdtype
    _check(got, refs[dtype], dtype)
    full, _ = sa_ball_mlp_pool_plain(RADIUS, K, _t(pts), _t(q), None, ws, bs, dtype=tdtype)
    assert torch.equal(got, full)


def test_overflow_flags_are_the_host_gate_per_tile(regime):
    name, pts, q, _ = regime
    want_ov, want_dense = REGIMES[name]
    ov, dmax = _gate(pts, q, RADIUS, *WTG)
    assert ov == want_ov and (want_dense is None or (dmax > K) == want_dense), "fixture drifted"
    axis, key, qkey = sab.sort_keys(_t(pts), _t(q))
    xyz_s = sab.rank_sort_points_plain(key, _t(pts))[0]
    q_s = sab.rank_sort_points_plain(qkey, _t(q))[0]
    _, flags = sab.bucket_gate_plain(RADIUS, xyz_s, q_s, axis, *WTG)
    want = _gate_tiles(pts, q, RADIUS, *WTG)
    np.testing.assert_array_equal(flags.numpy(), want)
    assert bool(want.any()) == ov


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("cloud", ["sparse", "dense"])
def test_with_features_matches_jax(cloud, dtype):
    # test_sabucket.py's has_src case: N=512, M=128, K=16, C=8.
    rng = np.random.default_rng(5)
    n2, m2, k2, c2 = 512, 128, 16, 8
    cfg = "384,32,128" if cloud == "sparse" else "384,16,128"
    if cloud == "sparse":
        pts = rng.normal(size=(B, n2, 3)).astype(np.float32)
    else:
        centers = rng.normal(size=(B, 8, 3)) * np.array([4.0, 0.3, 0.3])
        assign = rng.integers(0, 8, size=(B, n2))
        pts = (centers[np.arange(B)[:, None], assign] + rng.normal(size=(B, n2, 3)) * 0.05).astype(np.float32)
    src = rng.normal(size=(B, n2, c2)).astype(np.float32)
    q = pts[:, :m2]
    ws, bs = _weights(rng, (3 + c2, 16, 16, 32))
    wtg = tuple(int(v) for v in cfg.split(","))
    assert not _gate(pts, q, RADIUS, *wtg)[0]
    jdtype, tdtype = DTYPES[dtype]
    ref = _jax_bucketed(cfg, RADIUS, k2, pts, q, src, ws, bs, jdtype, use_xyz=True, xyz_first=True)
    args = (RADIUS, k2, _t(pts), _t(q), _t(src), [_t(w) for w in ws], [_t(b) for b in bs])
    got, _ = sab.sa_ball_mlp_pool_bucketed_plain(*args, dtype=tdtype, window=wtg[0], qtile=wtg[1], gblk=wtg[2])
    _check(got, ref, dtype)
    assert torch.equal(got, sa_ball_mlp_pool_plain(*args, dtype=tdtype)[0])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_prelifted_features_match_jax(dtype):
    # C > feats[0]: the features arrive multiplied by W0f (test_sabucket.py).
    rng = np.random.default_rng(9)
    n2, m2, k2, c2 = 512, 128, 16, 24
    pts = rng.normal(size=(B, n2, 3)).astype(np.float32)
    src = rng.normal(size=(B, n2, c2)).astype(np.float32)
    q = pts[:, :m2]
    ws, bs = _weights(rng, (3 + c2, 16, 32))
    jdtype, tdtype = DTYPES[dtype]
    ref = _jax_bucketed("384,32,128", RADIUS, k2, pts, q, src, ws, bs, jdtype, use_xyz=True, xyz_first=True)
    args = (RADIUS, k2, _t(pts), _t(q), _t(src), [_t(w) for w in ws], [_t(b) for b in bs])
    got, _ = sab.sa_ball_mlp_pool_bucketed_plain(*args, dtype=tdtype, window=384, qtile=32, gblk=128)
    _check(got, ref, dtype)
    assert torch.equal(got, sa_ball_mlp_pool_plain(*args, dtype=tdtype)[0])


def test_boundary_points_stay_exact(no_src_weights):
    # Points at key distance r from a query and just inside it (test_sabucket.py).
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(B, 1024, 3)).astype(np.float32)
    q0 = pts[:, :M, :].copy()
    pts[:, M : M + 64, :] = q0[:, :64, :] + np.array([RADIUS, 0.0, 0.0])
    pts[:, M + 64 : M + 128, :] = q0[:, 64:128, :] + np.array([RADIUS * (1.0 - 1e-6), 0.0, 0.0])
    ws, bs = [[_t(a) for a in group] for group in no_src_weights]
    args = (RADIUS, K, _t(pts), _t(pts[:, :M]), None, ws, bs)
    got, _ = sab.sa_ball_mlp_pool_bucketed_plain(*args, window=WTG[0], qtile=WTG[1], gblk=WTG[2])
    assert torch.equal(got, sa_ball_mlp_pool_plain(*args)[0])


def test_cpu_tensor_takes_plain_version_without_launch(no_src_weights):
    pts = np.asarray(_cloud("dense"))
    ws, bs = [[_t(a) for a in group] for group in no_src_weights]
    args = (RADIUS, K, _t(pts), _t(pts[:, :M]), None, ws, bs)
    before = sab.sa_ball_mlp_pool_bucketed.launches
    got, idx = sab.sa_ball_mlp_pool_bucketed(*args, window=WTG[0], qtile=WTG[1], gblk=WTG[2])
    ref, _ = sab.sa_ball_mlp_pool_bucketed_plain(*args, window=WTG[0], qtile=WTG[1], gblk=WTG[2])
    assert idx is None and torch.equal(got, ref)
    assert sab.sa_ball_mlp_pool_bucketed.launches == before
    assert sab.sa_ball_mlp_pool_bucketed.last_overflow.shape == (B, M // WTG[1])


def test_wrapper_refuses_other_devices():
    z = torch.zeros(1, 256, 3, device="meta")
    with pytest.raises(ValueError):
        sab.sa_ball_mlp_pool_bucketed(0.2, 4, z, z, None, [torch.zeros(3, 4)], [torch.zeros(4)],
                                      window=128, qtile=32, gblk=128)


def test_eligibility_and_resolution_are_jax_rules():
    assert sab.AUTO_BUCKET == jsab._AUTO_BUCKET
    for cfg in ("auto", "off", None, (896, 64, 128), (640, 32, 128), (1152, 128, 128), (900, 64, 128)):
        jcfg = None if cfg == "off" else cfg
        for n, m in ((2048, 512), (1024, 256), (2048, 500), (2050, 512), (512, 128), (1024, 512)):
            assert sab.resolve_bucket_config(cfg, n, m) == jsab.resolve_bucket_config(jcfg, n, m)
            for nsample in (16, 32, 64, 128):
                for has_src in (False, True):
                    for use_xyz in (False, True):
                        for need_idx in (False, True):
                            args = (n, m, nsample, has_src, use_xyz, need_idx)
                            assert sab.bucket_eligible(cfg, *args) == jsab.bucket_eligible(jcfg, *args), (cfg, args)


def test_sa_bucket_is_a_per_model_setting():
    a = get_model("pointnet2_cls_ssg", device="cpu")
    b = get_model("pointnet2_cls_ssg", device="cpu")
    assert a.sa1.mlp.sa_bucket == "auto"  # JAX's default
    configure_eval(a, "off")
    assert {m.sa_bucket for m in a.modules() if isinstance(m, pointnet_modules._PooledMLP)} == {"off"}
    assert b.sa1.mlp.sa_bucket == "auto"
    with pytest.raises(ValueError):
        configure_eval(a, "896,64,128")  # (W, T, G) is a TPU knob, not a setting


@pytest.fixture(scope="module")
def ssg_2048():
    """(points [2, 2048, 3], JAX variables with random positive BN stats)."""
    data, _ = make_synthetic_dataset(num_per_class=1, num_classes=2, num_points=2048, seed=19)
    model, _, _ = jzoo.get_model("pointnet2_cls_ssg")
    key = jax.random.PRNGKey(0)
    v = model.init({"params": key, "dropout": key}, jnp.asarray(data[:, :128]), train=False)
    rng = np.random.RandomState(1)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(
            0.1 + 0.1 * np.abs(rng.randn(*a.shape)) if p[-1].key == "var" else 0.05 * np.abs(rng.randn(*a.shape)),
            jnp.float32,
        ),
        v["batch_stats"],
    )
    return data.astype(np.float32), {**v, "batch_stats": stats}


def test_ssg_logits_at_2048_points_equal_under_auto_and_off_and_match_jax(monkeypatch, ssg_2048):
    points, variables = ssg_2048
    model = load_jax_variables(get_model("pointnet2_cls_ssg", device="cpu"), variables).eval()
    calls = []
    bucketed = pointnet_modules.sa_ball_mlp_pool_bucketed
    monkeypatch.setattr(pointnet_modules, "sa_ball_mlp_pool_bucketed",
                        lambda *a, **kw: calls.append(a[1]) or bucketed(*a, **kw))
    x = torch.from_numpy(points)
    logits = {}
    with torch.no_grad():
        for setting in ("auto", "off"):
            configure_eval(model, setting)
            logits[setting] = model(x)["logits"]
        xyz1, feats1 = model.sa1(x, None)
        xyz2, _ = model.sa2(xyz1, feats1)
    assert calls == [32]  # SA1 (K = 32) under "auto" only
    assert torch.equal(logits["auto"], logits["off"])
    # The JAX model's lax path: pin the inputs off the ball boundaries first.
    for (_, radius, *_), pts, queries in zip(PointNet2ClsSSG.SA_CONFIGS, (points, xyz1.numpy()),
                                              (xyz1.numpy(), xyz2.numpy())):
        d2 = ((queries[:, :, None, :].astype(np.float64) - pts[:, None, :, :]) ** 2).sum(-1)
        assert np.abs(d2 - radius * radius).min() > 1e-6
    monkeypatch.setenv("SCANOBJECTNN_FUSED_SA_EVAL", "off")
    jmodel = jzoo.get_model("pointnet2_cls_ssg")[0]
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(points), train=False)["logits"], np.float32)
    got = logits["auto"].numpy()
    assert float(np.abs(ref).max()) > 0.1
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5 * max(1.0, float(np.abs(ref).max())))
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))


def test_msg_sa1_buckets_its_k16_and_k32_scales(monkeypatch):
    model = get_model("pointnet2_cls_msg", device="cpu").eval()
    calls = []
    bucketed = pointnet_modules.sa_ball_mlp_pool_bucketed
    monkeypatch.setattr(pointnet_modules, "sa_ball_mlp_pool_bucketed",
                        lambda *a, **kw: calls.append(a[1]) or bucketed(*a, **kw))
    x = torch.from_numpy(np.random.RandomState(2).randn(1, 2048, 3).astype(np.float32))
    with torch.no_grad():
        out = model(x)["logits"]
        configure_eval(model, "off")
        ref = model(x)["logits"]
    assert calls == [16, 32]  # the K = 128 scale keeps #3's chunked path
    assert torch.equal(out, ref)
