"""PyTorch port, the training pieces below the model, against the JAX
package on the same inputs (numpy seeds):

  * training-mode ``BatchNorm``: output, gradients and the updated running
    stats, at momentum 0.5 and 0.99 (f32: rtol 1e-5 / atol 1e-6 for values
    and stats; each gradient to 1e-4 x max(1, |ref|max), the bound of the
    whole step in ``test_torch_train_step.py``.  The readings are at most
    4.4e-5 against gradients up to 31: the sums run in another order, and
    a Dense bias before a training BN has a true gradient of 0, so both
    sides hold rounding noise of about 1e-5 there);
  * ``GroupMLPPool`` in training mode: pooled output, every parameter's
    gradient and the input gradient, with exact max ties (duplicated
    neighbour slots, as ball-query padding makes them): ``torch.amax`` must
    split the gradient evenly, as ``jnp.max`` does (same bounds);
  * the LR and BN-momentum schedules: equal, at several steps;
  * the augmentation, given the JAX draws (angles, normals): within 1e-6;
  * ``EpochSampler``: the same order under the same seed, equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_tpu import augment as jaug
from scanobjectnn_tpu.data.pipeline import Batches as JBatches
from scanobjectnn_tpu.data.pipeline import EpochSampler as JEpochSampler
from scanobjectnn_tpu.nn import layers as jlayers
from scanobjectnn_tpu.nn.pointnet_modules import GroupMLPPool as JGroupMLPPool
from scanobjectnn_tpu.train import schedules as jschedules
from scanobjectnn_torch import convert
from scanobjectnn_torch.augment import transforms
from scanobjectnn_torch.data.pipeline import Batches, EpochSampler
from scanobjectnn_torch.nn import layers as tlayers
from scanobjectnn_torch.nn.pointnet_modules import GroupMLPPool
from scanobjectnn_torch.train import schedules


def _grad_close(got, ref, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= 1e-4 * scale, f"{what}: {err} > {1e-4 * scale}"


def _random_stats(stats, rng):
    return jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.asarray(
            0.5 + np.abs(rng.randn(*v.shape)) if p[-1].key == "var" else 0.3 * rng.randn(*v.shape),
            jnp.float32,
        ),
        stats,
    )


def _torch_grads(module):
    return {name: p.grad.numpy() for name, p in module.named_parameters()}


def _flat(tree):
    return dict(convert._flatten(tree))


@pytest.mark.parametrize("momentum", [0.5, 0.99])
def test_batchnorm_train_matches_flax(rng, momentum):
    x = (rng.randn(3, 5, 7, 16) * 2.0 + 0.5).astype(np.float32)
    cot = rng.randn(*x.shape).astype(np.float32)
    jm = jlayers.BatchNorm()
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), use_running_average=True)
    v = {"params": {"scale": jnp.asarray(rng.rand(16) + 0.5, jnp.float32),
                    "bias": jnp.asarray(rng.randn(16), jnp.float32)},
         "batch_stats": _random_stats(v["batch_stats"], rng)}

    def f(params, xx):
        y, mut = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, xx,
                          use_running_average=False, momentum=momentum, mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, mut["batch_stats"])

    (gp, gx), (ref, stats) = jax.grad(f, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))

    tm = convert.load_jax_variables(tlayers.BatchNorm(16), v).train()
    xt = torch.from_numpy(x).requires_grad_()
    y = tm(xt, momentum)
    (y * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    for key in ("mean", "var"):
        np.testing.assert_allclose(getattr(tm, key).numpy(), np.asarray(stats[key]), rtol=1e-5, atol=1e-6)
    _grad_close(xt.grad.numpy(), gx, "dx")
    _grad_close(tm.scale.grad.numpy(), gp["scale"], "dscale")
    _grad_close(tm.bias.grad.numpy(), gp["bias"], "dbias")


def test_batchnorm_var_is_biased_and_clamped():
    bn = tlayers.BatchNorm(2).train()
    x = torch.tensor([[1.0, 3.0], [1.0, 5.0]])
    bn(x, 0.0)  # momentum 0: the running stats become the batch stats
    assert torch.equal(bn.mean, torch.tensor([1.0, 4.0]))
    assert torch.equal(bn.var, torch.tensor([0.0, 1.0]))  # biased: /2, not /1


@pytest.mark.parametrize("momentum", [0.5, 0.99])
def test_group_mlp_pool_train_grad_matches_flax(rng, momentum):
    b, m, k, c, feats = 2, 6, 8, 7, (16, 12, 24)
    x = rng.randn(b, m, k, c).astype(np.float32)
    x[:, :, 5:] = x[:, :, :1]  # slots 5..7 repeat slot 0: exact ties in the max
    cot = rng.randn(b, m, feats[-1]).astype(np.float32)
    jm = JGroupMLPPool(feats)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    v = {**v, "batch_stats": _random_stats(v["batch_stats"], rng)}

    def f(params, xx):
        y, mut = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, xx,
                          train=True, bn_momentum=momentum, mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, mut["batch_stats"])

    (gp, gx), (ref, stats) = jax.grad(f, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))

    tm = convert.load_jax_variables(GroupMLPPool(c, feats), v).train()
    xt = torch.from_numpy(x).requires_grad_()
    y = tm(xt, momentum)
    (y * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    got = _torch_grads(tm)
    want = _flat(gp)
    assert sorted(got) == sorted(want)
    for name in want:
        _grad_close(got[name], want[name], name)
    _grad_close(xt.grad.numpy(), gx, "dx")
    for name, ref_stat in _flat(stats).items():
        np.testing.assert_allclose(dict(tm.named_buffers())[name].numpy(), np.asarray(ref_stat), rtol=1e-5, atol=1e-6)
    # The even split: the four tied slots of a row share one gradient, and
    # together take what slot 0 alone would (at least one channel pools them).
    g = xt.grad.numpy()
    for s in range(5, 8):
        np.testing.assert_allclose(g[:, :, s], g[:, :, 0], rtol=1e-6, atol=1e-7)
    assert np.abs(g[:, :, 0]).max() > 0


@pytest.mark.parametrize("batch_size,decay_step", [(16, 200_000), (32, 100), (8, 20_000)])
def test_schedules_equal_jax(batch_size, decay_step):
    lr = schedules.exponential_decay_lr(1e-3, batch_size, decay_step, 0.7)
    bn = schedules.bn_momentum_schedule(batch_size, decay_step)
    jlr = jschedules.exponential_decay_lr(1e-3, batch_size, decay_step, 0.7)
    jbn = jschedules.bn_momentum_schedule(batch_size, decay_step)
    steps = [0, 1, 2, 3, 12_499, 12_500, 12_501, 50_000, 10**6, 2**24 + 3]
    assert [lr(s) for s in steps] == [float(jlr(s)) for s in steps]
    assert [bn(s) for s in steps] == [float(jbn(s)) for s in steps]
    assert min(lr(s) for s in steps) == float(np.float32(1e-5)) and max(bn(s) for s in steps) == float(np.float32(0.99))


def test_augmentation_matches_jax_given_the_draws(rng):
    points = rng.randn(4, 64, 3).astype(np.float32)
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    # The draws the JAX transforms make from these keys.
    angles = np.array(jax.random.uniform(k1, (4,)))
    normal = np.array(jax.random.normal(k2, points.shape, jnp.float32))

    t = torch.from_numpy(points)
    rot = transforms.rotate_point_cloud(t, angles=torch.from_numpy(angles) * 2.0 * np.pi)
    np.testing.assert_allclose(rot.numpy(), np.asarray(jaug.rotate_point_cloud(k1, jnp.asarray(points))), atol=1e-6)
    jit = transforms.jitter_point_cloud(t, normal=torch.from_numpy(normal))
    np.testing.assert_array_equal(jit.numpy(), np.asarray(jaug.jitter_point_cloud(k2, jnp.asarray(points))))
    both = transforms.standard_train_augment(t, angles=torch.from_numpy(angles) * 2.0 * np.pi,
                                             normal=torch.from_numpy(normal))
    np.testing.assert_allclose(both.numpy(), np.asarray(jaug.standard_train_augment(key, jnp.asarray(points))), atol=1e-6)
    np.testing.assert_allclose(
        transforms.rotation_matrix_y(torch.from_numpy(angles)).numpy(),
        np.asarray(jaug.rotation_matrix_y(jnp.asarray(angles))), atol=1e-7,
    )


def test_augmentation_draws_from_the_generator(rng):
    t = torch.from_numpy(rng.randn(3, 32, 3).astype(np.float32))
    a = transforms.standard_train_augment(t, torch.Generator().manual_seed(5))
    b = transforms.standard_train_augment(t, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    # A rotation about y keeps each point's y and its distance from the axis.
    r = transforms.rotate_point_cloud(t, torch.Generator().manual_seed(1))
    assert torch.equal(r[..., 1], t[..., 1])
    np.testing.assert_allclose(r[..., [0, 2]].norm(dim=-1).numpy(), t[..., [0, 2]].norm(dim=-1).numpy(), rtol=1e-5)
    noise = transforms.jitter_point_cloud(t, torch.Generator().manual_seed(2)) - t
    assert float(noise.abs().max()) <= 0.05 + 1e-6 and float(noise.std()) > 0.005


@pytest.mark.parametrize("seed", [0, 3])
def test_epoch_sampler_order_equals_jax(rng, seed):
    data = rng.randn(10, 40, 3).astype(np.float32)
    labels = np.arange(10) % 3
    ours = EpochSampler(data, labels, num_points=32, seed=seed)
    theirs = JEpochSampler(data, labels, num_points=32, seed=seed)
    for _ in range(3):  # successive epochs draw new permutations from one stream
        a, b = ours.epoch(), theirs.epoch()
        np.testing.assert_array_equal(a["points"], b["points"])
        np.testing.assert_array_equal(a["labels"], b["labels"])
        got = [batch["labels"].tolist() for batch in Batches(a, 4)]
        assert got == [batch["labels"].tolist() for batch in JBatches(b, 4)] and len(got) == 2
