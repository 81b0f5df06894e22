"""PyTorch port, DGCNN in bf16 training on the CPU: the two kernels of its
path that have a backward, held in bf16 against the JAX functions, then one
bf16 ``Trainer`` step of ``dgcnn`` and of ``dgcnn_bga`` against the JAX
steps, and the wrappers' card route rehearsed in a bf16 step.

Layers.  ``edge_reduce`` (#11 and #14, backward #14's VJP) on bf16 values,
as EdgeConv 1-4 hand it their ``c2``: the forward against JAX's
``edge_reduce_lax`` and the interpreted ``edge_reduce_pallas`` on the same
bf16 values (both cast them to f32: ``idx``, max, min and the tie counts
equal; ``s`` and ``q2`` within the f32 bound of summation order,
``2·k·2^-24·Σ|terms|``).  ``edge_gather_knn`` (#15, backward the
scatter-add #7) on bf16 rows, as the T-Net hands it: rows and ``idx``
equal to JAX's lax gather and to its Pallas kernel's f32 rows cast to bf16
(both exact copies).  The VJPs.  Each side takes the cotangent a bf16 step
hands it: f32 for the reductions (``_PairBN`` normalises in f32), bf16 for
the T-Net's rows (its ``a + bj`` is bf16).  The conventions differ:
  * the port sums each point's incoming edge coefficients in f32 and casts
    the sum to bf16 once, as JAX's Pallas VJPs do (``_er_bwd``,
    ``_egk_bwd``: an f32 scatter, then ``astype(vals.dtype)``);
  * JAX's lax path rounds each edge's cotangent to bf16 (the VJP of the
    f32 cast of the gathered rows) and scatter-adds in bf16.
So the port is held to the exact VJP (float64 from the same bf16 values and
cotangents): every element within one bf16 ulp of its exact value plus the
f32 summation bound above (one rounding of an f32 sum).  Neither JAX VJP
meets that on the CPU: the lax one rounds before it sums, and the
interpreted Pallas one, whose one-hot scatter sums a bf16 split of the
coefficients, read 11% of its elements beyond the bound at EdgeConv 2's
shape (an element whose exact value is -2.7e-4 reads 0).  Their largest
distances from the exact VJP, and the share of their elements beyond the
bound, are printed beside the port's, whose largest distance must be no
larger than either.

Steps (set-up of ``tests/test_torch_dgcnn_train.py``: its batch of B=4
clouds of N=128 points with masks, its JAX variables, k=20, full width, no
augmentation, dropout the identity).  The port's bf16 step runs its own
bf16 BatchNorms and ``_PairBN`` (statistics in f32, as JAX's).  The three
sides, the port's bf16 step, JAX's bf16 step (its CPU path: lax) and JAX's
step in float64, all take the port's five graphs of the bf16 step: each
EdgeConv's kNN runs on bf16 features, whose rounding moves a neighbour on
rows whose k/(k+1) gap is within it.  Each graph is checked against the
float64 layer input: every neighbour it picks lies within ``BF16_MARGIN``
= 0.2 x (1 + d²_(k+1)) of the exact k-th distance (EdgeConv 2-4's inputs
carry the bf16 roundings of one to three layers, a few 2^-8 of features up
to 6 in magnitude, in both distances compared: read up to 0.09 on this
batch), and the share of rows whose neighbours are exactly float64's own
is printed: all of them at the T-Net and EdgeConv 1, whose input is f32;
0.90, 0.84 and 0.78 at EdgeConv 2-4.  The rule is
``tests/test_torch_mixed_train.py``'s: for every gradient, BN running stat
and the loss, the ratio ``|port - f64| / max(|jax_bf16 - f64|, one bf16 ulp
of max(1, |f64|max))``, their mean at most 1 and each at most 3.

The card route.  On the CPU every wrapper takes its plain version; here a
bf16 ``dgcnn`` step (B=2, N=64) runs with each wrapper on its card route
and each kernel replaced by its plain version in the kernel's order
(``KernelRoute``), which records what the wrapper hands it: every
cotangent reaching ``edge_reduce_bwd_kernel`` and ``scatter_add_rows``, and
every value reaching a forward kernel, must be f32 and contiguous.  The
step is held to the plain step by ``chip_smoke.py``'s bound for a bf16 step
against the plain path (``BF16_STEP_GRAD_TOL`` = 2e-2 x max(1, |ref|max)
per tensor; the loss to 1e-6 relative): the two differ by the scatter's
summation order, which moves bf16 roundings of the cotangents.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu import models as jzoo
from scanobjectnn_tpu.ops.grouping import batched_index_gather, knn_graph_lax
from scanobjectnn_tpu.ops.pallas import edge_kernel as jedge
from scanobjectnn_torch import convert
from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
from scanobjectnn_torch.ops.cuda import edge_kernel, gather_kernel, spider_kernel
from scanobjectnn_torch.ops.cuda.edge_kernel import REDUCTIONS, edge_gather_knn, edge_reduce
from scanobjectnn_torch.ops.cuda.knn_kernel import knn_graph_plain
from scanobjectnn_torch.train import trainer as trainer_module
from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

from tests import test_torch_dgcnn
from tests.test_torch_dgcnn import PortGraphs, feed_jax
from tests.test_torch_dgcnn_train import B, CLASSES, MODELS, MOMENTUM, _jax_step_f64, batch, variables  # noqa: F401
from tests.test_torch_knn_graph import clear_rows
from tests.test_torch_mixed_train import _hold_bf16_step

BF16_MARGIN = 0.2  # module doc
BF16_STEP_GRAD_TOL, ROUTE_LOSS_RTOL = 2e-2, 1e-6  # chip_smoke.py's bf16 step bounds
DIFF = ("mmax", "mmin", "s", "q2")


def bf16(a) -> np.ndarray:
    """``a`` rounded to bf16, as f32."""
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp of |x| elementwise (of the smallest normal at 0)."""
    mag = np.maximum(np.abs(x), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def scatter_exact(idx: np.ndarray, coef: np.ndarray, n: int) -> np.ndarray:
    """float64 scatter-add of per-edge coefficients [B, M, k, C] onto the
    rows ``idx`` [B, M, k]: (the sums, the sums of their magnitudes)."""
    b = idx.shape[0]
    rows = np.broadcast_to(np.arange(b)[:, None, None], idx.shape)
    out = np.zeros((b, n, coef.shape[-1]))
    mag = np.zeros_like(out)
    np.add.at(out, (rows, idx), coef.astype(np.float64))
    np.add.at(mag, (rows, idx), np.abs(coef.astype(np.float64)))
    return out, mag


def hold_bf16_vjp(port, exact, mag, k, pallas=None, lax=None, what="") -> None:
    """The module doc's VJP holds: ``port`` (bf16, as f32) against the
    float64 ``exact`` sums (``mag`` their magnitudes' sums, ``k`` the terms
    an f32 sum may have), and no farther from them than the JAX VJPs
    given."""
    slack = 2 * k * 2.0 ** -24 * mag
    err = np.abs(port - exact)
    bound = bf16_ulp(exact) + slack
    assert (err <= bound).all(), f"{what}: {int((err > bound).sum())} elements beyond a bf16 ulp of the exact VJP"
    line = (f"{what}: port's VJP max |err| against float64 {err.max():.3e} "
            f"({float((err / bound).max()):.2f} of its bound)")
    for name, ref in (("Pallas", pallas), ("lax", lax)):
        if ref is not None:
            ref_err = np.abs(ref - exact)
            line += (f"; the {name} VJP's max |err| {ref_err.max():.3e}, "
                     f"{float((ref_err > bound).mean()):.4f} of its elements beyond that bound")
            assert err.max() <= ref_err.max(), (what, name)
    print(line)


def _clouds(seed, b, n, cf, cv):
    rng = np.random.RandomState(seed)
    return rng.randn(b, n, cf).astype(np.float32), bf16(rng.randn(b, n, cv))


def _to_bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)


def test_edge_reduce_bf16_matches_jax():
    # EdgeConv 2's shape: bf16 values (its c2); the graph's features reach
    # the kNN as f32 on both sides, so random f32 features whose rows clear
    # the graph's margin stand for them.
    b, n, cf, cv, k = 2, 128, 64, 64, 20
    feats, vals = _clouds(200, b, n, cf, cv)
    assert clear_rows(feats, k).all()
    v = _to_bf16(vals).requires_grad_()
    got = edge_reduce(torch.from_numpy(feats), v, k)
    jv = jnp.asarray(vals, jnp.bfloat16)
    refs = {fn.__name__: fn(jnp.asarray(feats), jv, k) for fn in (jedge.edge_reduce_lax, jedge.edge_reduce_pallas)}
    idx = got["idx"].numpy()
    g = np.abs(vals[np.arange(b)[:, None, None], idx]).astype(np.float64)
    for ref in refs.values():
        np.testing.assert_array_equal(idx, np.asarray(ref["idx"]))
        for key in ("mmax", "mmin", "cntmax", "cntmin"):
            assert got[key].dtype == torch.float32
            np.testing.assert_array_equal(got[key].detach().numpy(), np.asarray(ref[key]), err_msg=key)
        for key, mag in (("s", g.sum(2)), ("q2", (g * g).sum(2))):
            err = np.abs(got[key].detach().numpy() - np.asarray(ref[key]))
            assert (err <= 2 * k * 2.0 ** -24 * mag).all(), key
    rng = np.random.RandomState(1)
    cot = {key: rng.randn(b, n, cv).astype(np.float32) for key in DIFF}
    (grad,) = torch.autograd.grad([got[key] for key in DIFF], v, [torch.from_numpy(cot[key]) for key in DIFF])
    assert grad.dtype == torch.bfloat16

    def jax_vjp(fn):
        _, pull = jax.vjp(lambda x: tuple(fn(jnp.asarray(feats), x, k)[key] for key in DIFF), jv)
        out = pull(tuple(jnp.asarray(cot[key]) for key in DIFF))[0]
        assert out.dtype == jnp.bfloat16
        return np.asarray(out.astype(jnp.float32))

    gath = vals[np.arange(b)[:, None, None], idx].astype(np.float64)  # [B, N, k, Cv]
    red = {key: got[key].detach().numpy()[:, :, None].astype(np.float64) for key in REDUCTIONS if key != "s"}
    coef = (cot["s"][:, :, None] + 2.0 * gath * cot["q2"][:, :, None]
            + np.where(gath == red["mmax"], cot["mmax"][:, :, None] / np.maximum(red["cntmax"], 1.0), 0.0)
            + np.where(gath == red["mmin"], cot["mmin"][:, :, None] / np.maximum(red["cntmin"], 1.0), 0.0))
    exact, mag = scatter_exact(idx, coef, n)
    hold_bf16_vjp(grad.float().numpy(), exact, mag, 4 * k, jax_vjp(jedge.edge_reduce_pallas),
                  jax_vjp(jedge.edge_reduce_lax), f"edge_reduce bf16 (Cf, Cv)=({cf}, {cv})")


def test_edge_gather_knn_bf16_matches_jax():
    b, n, cv, k = 2, 128, 64, 20
    feats, vals = _clouds(3, b, n, 3, cv)
    assert clear_rows(feats, k).all()
    v = _to_bf16(vals).requires_grad_()
    rows, idx = edge_gather_knn(torch.from_numpy(feats), v, k)
    assert rows.dtype == torch.bfloat16
    jv = jnp.asarray(vals, jnp.bfloat16)
    lax_idx = knn_graph_lax(jnp.asarray(feats), k)
    jrows, jidx = jedge.edge_gather_knn(jnp.asarray(feats), jv, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(lax_idx))
    lax_rows = batched_index_gather(jv, lax_idx)
    assert lax_rows.dtype == jnp.bfloat16 and jrows.dtype == jnp.float32
    np.testing.assert_array_equal(rows.detach().float().numpy(), np.asarray(lax_rows.astype(jnp.float32)))
    np.testing.assert_array_equal(rows.detach().float().numpy(), np.asarray(jrows))
    cot = bf16(np.random.RandomState(4).randn(b, n, k, cv))
    (grad,) = torch.autograd.grad(rows, v, _to_bf16(cot))
    assert grad.dtype == torch.bfloat16
    _, pull = jax.vjp(lambda x: jedge.edge_gather_knn(jnp.asarray(feats), x, k)[0], jv)
    pallas = pull(jnp.asarray(cot))[0]  # the Pallas rows are f32: an f32 cotangent, as the step's sum gives it
    _, pull = jax.vjp(lambda x: batched_index_gather(x, lax_idx), jv)
    lax = pull(jnp.asarray(cot, jnp.bfloat16))[0]
    assert pallas.dtype == lax.dtype == jnp.bfloat16
    exact, mag = scatter_exact(idx.numpy(), cot, n)
    hold_bf16_vjp(grad.float().numpy(), exact, mag, k, np.asarray(pallas.astype(jnp.float32)),
                  np.asarray(lax.astype(jnp.float32)), "edge_gather_knn bf16 (T-Net, Cv=64)")


# ---------------------------------------------------------------- steps


def near_ties(feats, port_idx, k, margin) -> float:
    """Every neighbour of ``port_idx`` lies within ``margin`` x (1 +
    d²_(k+1)) of the k-th float64 distance of the layer input ``feats``
    (module doc); returns the share of rows whose neighbours are float64's
    own k nearest."""
    x = np.asarray(feats).astype(np.float64)
    d = ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)
    ds = np.sort(d, axis=-1)
    picked = np.take_along_axis(d, port_idx.astype(np.int64), axis=-1).max(-1)
    excess = float(((picked - ds[..., k - 1]) / (1.0 + ds[..., k])).max())
    assert excess <= margin, excess
    return float((picked <= ds[..., k - 1]).mean())


def _port_bf16_step(mp, name, batch, variables):
    mp.setattr(trainer_module, "standard_train_augment", lambda points, generator: points)
    trainer = Trainer(TrainerConfig(model=name, num_classes=CLASSES, batch_size=B, dtype="bfloat16", device="cpu"))
    assert trainer.bn_schedule(0) == MOMENTUM
    state = trainer.init_state()
    convert.load_jax_variables(state.model, variables)
    state.model.dropout_keep = state.model.seg_dropout_keep = 1.0
    with mp.context() as inner:
        rec = PortGraphs(inner)
        state, metrics = trainer.train_step(state, batch)
    assert len(rec.idx) == 5
    grads = {n: p.grad.float().numpy() for n, p in state.model.named_parameters()}
    stats = {n: b.numpy() for n, b in state.model.named_buffers()}
    return (float(metrics["loss"]), grads, stats), rec.idx


def _jax_bf16_step(mp, name, batch, variables, graphs):
    """JAX loss, gradients and updated BN stats of one bf16 training
    forward (its CPU path, the lax one) on the port's ``graphs``."""
    mp.setattr(fnn, "Dropout", lambda rate, deterministic: (lambda h: h))
    feed_jax(mp, graphs, BF16_MARGIN, [], checked=False)
    model = jzoo.get_model(name, num_classes=CLASSES, dtype=jnp.bfloat16)[0]
    targets = {k: jnp.asarray(batch[k], jnp.int32) for k in ("labels", "masks")}

    def loss_fn(params):
        out, mut = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                               jnp.asarray(batch["points"]), train=True, bn_momentum=MOMENTUM,
                               mutable=["batch_stats"])
        return model.loss(out, targets)[0], mut["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return float(loss), *({k: np.asarray(jnp.asarray(v, jnp.float32)) for k, v in convert._flatten(t)}
                          for t in (grads, stats))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bf16_step_no_farther_from_f64_than_jax_bf16(monkeypatch, batch, variables, name):
    port, graphs = _port_bf16_step(monkeypatch, name, batch, variables[name])
    with pytest.MonkeyPatch.context() as mp:
        jax_bf16 = _jax_bf16_step(mp, name, batch, variables[name], graphs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(test_torch_dgcnn, "clear_share", near_ties)
        metrics, grads, stats, shares = _jax_step_f64(mp, name, batch, variables[name], graphs, margin=BF16_MARGIN)
    print(f"{name} bf16: shares of rows whose neighbours are float64's own, per graph {[round(s, 4) for s in shares]}")
    assert len(shares) == 5 and shares[:2] == [1.0, 1.0]  # the T-Net's and EdgeConv 1's f32 inputs
    _hold_bf16_step(port, jax_bf16, (metrics["loss"], grads, stats))


# ------------------------------------------------------------ the card route


class KernelRoute:
    """Every wrapper on its card route with CPU tensors, each kernel
    replaced by its plain version (the backward of #14 in the kernel's
    order), recording the dtype and contiguity of each tensor it is handed
    (module doc).  ``calls`` counts the kernels, ``need_feat`` lists the
    SpiderConv backward's flags in call order."""

    def __init__(self, mp):
        self.bad, self.calls, self.need_feat = [], {}, []
        ek, gk, sk = edge_kernel, gather_kernel, spider_kernel

        def seen(kernel, *tensors):
            self.calls[kernel] = self.calls.get(kernel, 0) + 1
            for t in tensors:
                if t.is_floating_point() and t.dtype != torch.float32 or not t.is_contiguous():
                    self.bad.append((kernel, t.dtype, t.is_contiguous()))

        def fwd(vals, idx):
            seen("edge_reduce_fwd_kernel", vals, idx)
            red = ek.reduce_neighbors_plain(vals, idx)
            return tuple(red[key] for key in REDUCTIONS)

        def bwd(*args):
            seen("edge_reduce_bwd_kernel", *args)
            return ek.edge_reduce_bwd_ordered(*args)

        def graph_gather(feats, vals, k):
            seen("edge_gather_knn", feats)
            return ek.edge_gather_knn_plain(feats, vals, k)

        def scatter(idx, upd, n):
            seen("scatter_add_rows", idx, upd)
            return gk.scatter_add_rows_plain(idx, upd, n)

        def gather(vals, idx):
            seen("gather_rows", vals, idx)
            return gk.gather_rows_plain(vals, idx)

        def spider_fwd(feat, idx, g, kernel):
            seen("spider_conv_fwd_kernel", feat, idx, g, kernel)
            return sk.spider_conv_plain(feat, idx, g, kernel)

        def spider_bwd(feat, idx, g, kernel, dout, need_feat=True):
            seen("spider_conv_bwd_kernel", feat, idx, g, kernel, dout)
            self.need_feat.append(need_feat)
            leaves = [t.clone().requires_grad_() for t in (feat, g, kernel)]
            with torch.enable_grad():
                out = sk.spider_conv_plain(leaves[0], idx, leaves[1], leaves[2])
                dfeat, dg, dkernel = torch.autograd.grad(out, leaves, dout)
            return (dfeat if need_feat else None), dg, dkernel

        plain = lambda t: False  # noqa: E731
        for module, attr, fn in (
            (ek, "takes_plain", plain), (ek, "knn_graph_kernel", lambda f, k: seen("knn_graph_kernel", f)
                                         or knn_graph_plain(f, k)),
            (ek, "edge_reduce_fwd_kernel", fwd), (ek, "edge_reduce_bwd_kernel", bwd),
            (ek, "_graph_gather_kernel", graph_gather), (ek, "scatter_add_rows", scatter),
            (gk, "scatter_add_rows", scatter), (gk, "gather_rows", gather), (sk, "takes_plain", plain),
            (sk, "spider_conv_fwd_kernel", spider_fwd), (sk, "spider_conv_bwd_kernel", spider_bwd),
            (sk, "scatter_add_rows", scatter),
        ):
            mp.setattr(module, attr, fn)


def route_step(name: str, batch: dict, **config) -> tuple:
    """One bf16 ``Trainer`` step of ``name`` on the CPU, no augmentation and
    dropout the identity, on the plain path and on the card route
    (``KernelRoute``), from the same weights: ((loss, grads, stats) of
    each, the route's ``KernelRoute``)."""
    steps = []
    for route in (False, True):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(trainer_module, "standard_train_augment", lambda points, generator: points)
            mp.setattr(trainer_module, "pointcnn_augment", lambda points, *a: points)
            trainer = Trainer(TrainerConfig(model=name, dtype="bfloat16", device="cpu", **config))
            state = trainer.init_state(seed=1)
            for module in state.model.modules():
                for attr in ("dropout_keep", "seg_dropout_keep"):
                    if hasattr(module, attr):
                        setattr(module, attr, 1.0)
            rec = KernelRoute(mp) if route else None
            state, metrics = trainer.train_step(state, batch)
        steps.append((float(metrics["loss"]), {n: p.grad.float() for n, p in state.model.named_parameters()},
                      {n: b.clone() for n, b in state.model.named_buffers()}))
    assert not rec.bad, rec.bad
    (loss_r, grads_r, stats_r), (loss_p, grads_p, stats_p) = steps[1], steps[0]
    assert abs(loss_r / loss_p - 1) <= ROUTE_LOSS_RTOL, (loss_r, loss_p)
    worst = 0.0
    for got, want in ((grads_r, grads_p), (stats_r, stats_p)):
        for key, ref in want.items():
            scale = max(1.0, float(ref.abs().max()))
            err = float((got[key] - ref).abs().max()) / scale
            assert err <= BF16_STEP_GRAD_TOL, (key, err)
            worst = max(worst, err)
    print(f"{name} bf16 step on the card route (plain kernels): kernel calls {rec.calls}; largest error / scale "
          f"against the plain step {worst:.3e} (bound {BF16_STEP_GRAD_TOL})")
    return rec


def test_dgcnn_bf16_step_on_the_card_route_hands_its_kernels_f32():
    data, labels = make_synthetic_dataset(num_per_class=1, num_classes=2, num_points=64, seed=6)
    calls = route_step("dgcnn", {"points": data, "labels": labels}, num_classes=2, batch_size=2).calls
    assert calls["edge_reduce_bwd_kernel"] == 4 and calls["edge_gather_knn"] == 1
    assert calls["scatter_add_rows"] == 1  # the T-Net's rows' backward
