"""PyTorch port, SpiderCNN in bf16 training on the CPU: the SpiderConv
contraction (#16, backward: its data and weight products and the
scatter-add #7) as a bf16 step runs it, held against JAX's; one bf16
``Trainer`` step of ``spidercnn_cls_xyz`` against the JAX steps; and the
wrappers' card route rehearsed in a bf16 step.

The contraction.  Here and in JAX the fused SpiderConv runs in f32 whatever
the compute dtype (``models/spidercnn.py`` in both packages): the bf16
layer input is cast to f32 before the contraction, ``g`` is f32, and the
f32 output (plus the bias) is cast to bf16.  So a bf16 step hands the
contraction bf16 values in f32, and its output's cotangent is bf16 values
in f32 (the VJP of that last cast).  Both sides: the forward against
``spider_conv_lax`` (the JAX function's CPU path) and a float64 einsum,
within ``test_torch_spider.py``'s ``FWD_TOL`` x max(1, |ref|max); ``dg``
and ``dkernel`` f32 within its ``VJP_TOL``; ``dfeat`` comes back in bf16,
the dtype of the layer input, through the cast on each side (one rounding
of an f32 sum): within one bf16 ulp of the float64 VJP plus the f32
summation bound ``2·(T·O + K)·2^-24·Σ|terms|``, and of JAX's within one
ulp of the larger of the two plus that bound (two single roundings of f32
sums in other orders).

The step (set-up of ``tests/test_torch_spidercnn_train.py``: its batch of
B=4 clouds of N=128 points, its JAX variables, k=20, full width, no
augmentation, dropout the identity): the port's bf16 step, with its own
bf16 BatchNorms and its GroupNorms (statistics in f32, as flax's), against
JAX's bf16 step and its step in float64, by ``tests/
test_torch_mixed_train.py``'s rule (mean ratio at most 1, each at most 3).
All three take the port's kNN graph, which is of the f32 points (the same
as in f32, so it is checked as the f32 step test checks it).

The card route (``KernelRoute`` of ``tests/test_torch_mixed_dgcnn_train
.py``): a bf16 step at B=2, N=64 hands #16's kernels f32 contiguous
tensors, skips the first layer's data backward (``need_feat`` False: its
input is the points) and takes the others', and is held to the plain step
by ``chip_smoke.py``'s bf16 step bound.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu import models as jzoo
from scanobjectnn_tpu import ops as jops
from scanobjectnn_tpu.ops.pallas import spider_kernel as jsk
from scanobjectnn_torch import convert
from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
from scanobjectnn_torch.models import spidercnn
from scanobjectnn_torch.ops.cuda.spider_kernel import spider_conv
from scanobjectnn_torch.train import trainer as trainer_module
from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

from tests.test_torch_mixed_dgcnn_train import bf16, bf16_ulp, route_step, scatter_exact
from tests.test_torch_mixed_train import _hold_bf16_step
from tests.test_torch_spider import CASES, FWD_TOL, VJP_TOL, spider_inputs
from tests.test_torch_spidercnn_train import B, CLASSES, MOMENTUM, _jax_step_f64, batch, variables  # noqa: F401


def _scaled_err(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max()) / max(
        1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("case", ["conv2_k8", "conv3_k20"])
def test_spider_conv_in_a_bf16_layer_matches_jax(case):
    feat, idx, g, kernel = spider_inputs(case, seed=5)
    feat = bf16(feat)
    b, n, k, c, t, o = CASES[case]
    cot = bf16(np.random.RandomState(6).randn(b, n, o))
    fb = torch.from_numpy(feat).to(torch.bfloat16).requires_grad_()
    gl, kl = (torch.from_numpy(a).requires_grad_() for a in (g, kernel))
    out = spider_conv(fb.float(), torch.from_numpy(idx), gl, kl)  # as SpiderConv.forward hands it
    dfeat, dg, dkernel = torch.autograd.grad(out, (fb, gl, kl), torch.from_numpy(cot))
    assert out.dtype == dg.dtype == dkernel.dtype == torch.float32 and dfeat.dtype == torch.bfloat16

    def jax_fn(f, gg, w):
        return jsk.spider_conv_lax(f.astype(jnp.float32), jnp.asarray(idx), gg, w)

    jargs = (jnp.asarray(feat, jnp.bfloat16), jnp.asarray(g), jnp.asarray(kernel))
    ref, pull = jax.vjp(jax_fn, *jargs)
    jdfeat, jdg, jdkernel = pull(jnp.asarray(cot))
    assert jdfeat.dtype == jnp.bfloat16
    grouped = feat.astype(np.float64)[np.arange(b)[:, None, None], idx]
    w64 = kernel.astype(np.float64).reshape(k, c, t, o)
    exact_out = np.einsum("bnkc,bnkt,kcto->bno", grouped, g.astype(np.float64), w64)
    errs = {"forward vs lax": _scaled_err(out.detach().numpy(), np.asarray(ref)),
            "forward vs float64": _scaled_err(out.detach().numpy(), exact_out),
            "dg vs lax": _scaled_err(dg.numpy(), np.asarray(jdg)),
            "dkernel vs lax": _scaled_err(dkernel.numpy(), np.asarray(jdkernel))}
    print(f"{case} bf16 layer: " + ", ".join(f"{key} {v:.3e}" for key, v in errs.items()))
    assert max(errs["forward vs lax"], errs["forward vs float64"]) <= FWD_TOL
    assert max(errs["dg vs lax"], errs["dkernel vs lax"]) <= VJP_TOL

    terms = np.einsum("bnkt,kcto,bno->bnkc", g.astype(np.float64), w64, cot.astype(np.float64))
    mags = np.einsum("bnkt,kcto,bno->bnkc", np.abs(g.astype(np.float64)), np.abs(w64), np.abs(cot.astype(np.float64)))
    exact, _ = scatter_exact(idx, terms, n)
    mag, _ = scatter_exact(idx, mags, n)
    slack = 2 * (t * o + k) * 2.0 ** -24 * mag
    port, theirs = dfeat.float().numpy(), np.asarray(jdfeat.astype(jnp.float32))
    err = np.abs(port - exact)
    assert (err <= bf16_ulp(exact) + slack).all(), "dfeat beyond a bf16 ulp of the float64 VJP"
    gap = np.abs(port - theirs)
    assert (gap <= bf16_ulp(np.maximum(np.abs(port), np.abs(theirs))) + slack).all(), "dfeat vs JAX's"
    print(f"{case} bf16 dfeat: max |err| against float64 {err.max():.3e} (JAX's {np.abs(theirs - exact).max():.3e}); "
          f"{float((gap != 0).mean()):.4f} of the elements differ from JAX's by an ulp")


def _port_bf16_step(mp, batch, variables):
    mp.setattr(trainer_module, "standard_train_augment", lambda points, generator: points)
    trainer = Trainer(TrainerConfig(model="spidercnn_cls_xyz", num_classes=CLASSES, batch_size=B, dtype="bfloat16",
                                    device="cpu"))
    assert trainer.bn_schedule(0) == MOMENTUM
    state = trainer.init_state()
    convert.load_jax_variables(state.model, variables)
    state.model.dropout_keep = 1.0
    graphs = []
    gather = spidercnn.edge_gather_knn

    def recorded(feats, vals, k):
        out = gather(feats, vals, k)
        graphs.append(out[1].numpy())
        return out

    with mp.context() as inner:
        inner.setattr(spidercnn, "edge_gather_knn", recorded)
        state, metrics = trainer.train_step(state, batch)
    assert len(graphs) == 1
    grads = {n: p.grad.float().numpy() for n, p in state.model.named_parameters()}
    stats = {n: b.numpy() for n, b in state.model.named_buffers()}
    return (float(metrics["loss"]), grads, stats), graphs[0]


def _jax_bf16_step(mp, batch, variables, graph):
    mp.setattr(fnn, "Dropout", lambda rate, deterministic: (lambda h: h))
    mp.setattr(jops, "knn_graph", lambda feats, k: jnp.asarray(graph))
    model = jzoo.get_model("spidercnn_cls_xyz", num_classes=CLASSES, dtype=jnp.bfloat16)[0]
    labels = {"labels": jnp.asarray(batch["labels"], jnp.int32)}

    def loss_fn(params):
        out, mut = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                               jnp.asarray(batch["points"]), train=True, bn_momentum=MOMENTUM,
                               mutable=["batch_stats"])
        return model.loss(out, labels)[0], mut["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return float(loss), *({k: np.asarray(jnp.asarray(v, jnp.float32)) for k, v in convert._flatten(t)}
                          for t in (grads, stats))


def test_bf16_step_no_farther_from_f64_than_jax_bf16(monkeypatch, batch, variables):
    port, graph = _port_bf16_step(monkeypatch, batch, variables)
    with pytest.MonkeyPatch.context() as mp:
        jax_bf16 = _jax_bf16_step(mp, batch, variables, graph)
    with pytest.MonkeyPatch.context() as mp:
        metrics, grads, stats, shares = _jax_step_f64(mp, batch, variables, graph)
    print(f"spidercnn bf16: share of rows checked {[round(s, 4) for s in shares]}")
    _hold_bf16_step(port, jax_bf16, (metrics["loss"], grads, stats))


def test_spidercnn_bf16_step_on_the_card_route_hands_its_kernels_f32():
    data, labels = make_synthetic_dataset(num_per_class=1, num_classes=2, num_points=64, seed=6)
    rec = route_step("spidercnn_cls_xyz", {"points": data, "labels": labels}, num_classes=2, batch_size=2)
    assert rec.calls["spider_conv_fwd_kernel"] == rec.calls["spider_conv_bwd_kernel"] == 4
    assert rec.need_feat == [True, True, True, False]  # conv4 first; conv1's input is the points
