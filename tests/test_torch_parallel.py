"""PyTorch port, data parallelism on the CPU: the mesh helpers, the
cross-replica BatchNorms and whole training steps and evaluations on two
gloo ranks, against one process and against JAX.

Two ranks are spawned once for the module (``ranks``: one ``spawn``
process each, joined with ``JOIN_TIMEOUT`` so a hang fails the tests
instead of eating the suite's time; the group meets through a file under
``tmp_path``, never a fixed port).  Each rank runs every case on its
contiguous half of a seeded global batch, then joins a group of its own of
world one and runs the world-one cases.  The one-process references run in
the test process.

  (a) ``make_mesh`` without a group is a world of one; the row split, an
      uneven batch and a world that is not one device a rank raise;
      ``draw_rows`` gives each rank its rows of the global batch's dropout
      mask and "ids" sampling, bit for bit.
  (b) ``BatchNorm`` and DGCNN's ``_PairBN.pair`` on 2 ranks of B/2: the
      outputs, running statistics and the gradients of the input within
      ``BN_TOL`` x max(1, |ref|max) of one process over B (the same f32
      sums split in two), the parameters' gradients summed over the ranks
      likewise; and JAX's ``BatchNorm(axis_name="data")`` and ``_PairBN``
      under ``shard_map`` over 2 devices, as ``tests/test_multichip.py``
      holds JAX's (rtol 1e-4, atol 1e-5).
  (c) Whole steps with the momentum optimizer (its update is linear in the
      gradient, so rounding stays at f32 scale; Adam's first step is about
      lr·sign(g)).  ``pointnet_cls_basic``, 3 steps at B=8, N=32, no
      augmentation, dropout the identity: the loss (the mean of the ranks')
      and every parameter against one process and against JAX's ``Trainer``
      on a 2-device mesh at ``tests/test_multichip.py``'s bounds (rtol 1e-4
      on the loss, rtol 1e-3 / atol 1e-5 on the parameters; the port reads
      are printed).  One step each of ``pointnet2_cls_ssg`` (f32 with the
      fused SA tail, #17's op; bf16 with exact-key pooling, #18's op),
      ``dgcnn_bga`` and ``pointnet_cls`` (dropout and the T-Net penalty) at
      B=4, N=128, augmentation and dropout on.  The fused ops take the
      group and run on both sides as often (counted).  f32: both sides'
      training statistics in float64, with their cross-replica mean
      (``_bn_forward_f64``, ``_pair_f64``, and the fused tail's
      ``_satrain_stats_f64``, rounded to f32 once): BNs over 2 and 4 clouds
      amplify f32 rounding of the moments (``E[x²] - E[x]²`` cancels; with
      f32 BNs ``dgcnn_bga``'s T-Net transform gradient read 1e-3 of its
      scale apart); the mean loss within ``LOSS_RTOL``, every gradient
      (each rank's after the average; the two ranks' states bit-equal)
      within ``GRAD_TOL`` x max(1, |ref|max), the Dense biases that feed a
      training BN (true gradient 0) within ``ZERO_GRAD_TOL``, the BN
      running statistics within ``STATS_TOL`` x max(1, |ref|max).  bf16
      (its statistics as they are): the ranks' moments, and a CPU matmul
      over half the rows, round otherwise than one process's, which moves
      bf16 roundings, and at B=4 either bf16 step lies 0.1-0.9 of a
      tensor's scale from the f32 step, 0.5 of it from each other; so both
      are held against the f32 step (float64 statistics), the two ranks'
      loss and every gradient no farther than ``BF16_RATIO`` times the one
      process's, or within ``BF16_LOSS_RTOL`` and ``BF16_GRAD_TOL`` of the
      scale (the mixed-train rule).  Controls (``CONTROLS``): the
      same two ranks with the BatchNorms' group taken away (local moments,
      ``configure_parallel(model, None)``), without the gradient average,
      or with each rank's own draws (no ``global_batch``) must each fail
      the same comparison; each reading is printed beside its limit.  On a
      group of world one the steps equal the no-group steps bit for bit
      (one thread a rank: the CPU's multithreaded scatter-add sums in no
      fixed order).
  (d) ``Trainer.evaluate`` on 2 ranks (SSG and BGA, 10 clouds at batch 4,
      the last batch padded, 2 votes) equals one process: predictions,
      every tally and accuracy exactly, the mean loss within 1e-6
      relative (each rank's outputs are gathered and the loss taken as one
      process takes it, but a CPU matmul over half the rows may round
      otherwise).
"""

import contextlib
import multiprocessing
from unittest import mock

import numpy as np
import pytest
import torch

from scanobjectnn_torch import convert
from scanobjectnn_torch.data.synthetic import make_synthetic_dataset
from scanobjectnn_torch.nn import layers, pointnet_modules
from scanobjectnn_torch.ops import exactpool
from scanobjectnn_torch.ops.cuda import satrain_kernel
from scanobjectnn_torch.parallel import mesh as mesh_lib
from scanobjectnn_torch.train import trainer as trainer_lib
from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig

WORLD = 2
JOIN_TIMEOUT = 240.0  # seconds for the two ranks' whole job
BN_TOL = 1e-5
LOSS_RTOL, GRAD_TOL, ZERO_GRAD_TOL, STATS_TOL = 1e-5, 1e-4, 2e-4, 1e-5
BF16_LOSS_RTOL, BF16_GRAD_TOL, BF16_RATIO = 2e-2, 2e-2, 3.0
JAX_LOSS_RTOL, JAX_RTOL, JAX_ATOL = 1e-4, 1e-3, 1e-5  # tests/test_multichip.py:73-78
SEED = 3


# ------------------------------------------------------------------ inputs


def _batch(kind: str, b: int, n: int, classes: int, seed: int) -> dict:
    per_class = -(-b // classes)
    data, labels, masks = make_synthetic_dataset(num_per_class=per_class, num_classes=classes, num_points=n,
                                                 seed=seed, with_mask=True)
    order = np.random.RandomState(seed).permutation(len(data))[:b]
    batch = {"points": data[order], "labels": labels[order]}
    if kind == "seg":
        batch["masks"] = (masks[order] >= 0).astype(np.int64)
    return batch


STEP_CASES = {
    # name: (TrainerConfig fields, kind, B, N, steps)
    "ssg_f32": (dict(model="pointnet2_cls_ssg", fused_sa_train=True), "cls", 4, 128, 1),
    "ssg_bf16": (dict(model="pointnet2_cls_ssg", dtype="bfloat16"), "cls", 4, 128, 1),
    "dgcnn_bga": (dict(model="dgcnn_bga"), "seg", 4, 128, 1),
    "pointnet_cls": (dict(model="pointnet_cls"), "cls", 4, 128, 1),
}
BASIC = dict(model="pointnet_cls_basic", num_classes=3, num_point=32, batch_size=8, optimizer="momentum",
             augment_rotate=False, augment_jitter=False)
EVAL_CASES = {"ssg": ("pointnet2_cls_ssg", "cls"), "bga": ("pointnet2_cls_bga", "seg")}
FUSED_OP = {"ssg_f32": "grouped_bn_mlp_pool", "ssg_bf16": "dense_bn_exactkey_pool"}  # the op a case must run
# control: the step cases it runs on (module doc)
CONTROLS = {"local_bn": ("dgcnn_bga", "ssg_bf16", "ssg_f32"), "no_average": ("dgcnn_bga", "pointnet_cls"),
            "local_draws": ("pointnet_cls", "ssg_f32")}


def _step_spec(name: str) -> dict:
    fields, kind, b, n, steps = STEP_CASES[name]
    config = dict(fields, num_classes=3, num_point=n, batch_size=b, optimizer="momentum", seed=SEED)
    return {"config": config, "batches": [_batch(kind, b, n, 3, SEED + i) for i in range(steps)],
            "f64_bn": config.get("dtype") != "bfloat16"}


def _eval_spec(name: str) -> dict:
    model, kind = EVAL_CASES[name]
    data = _batch(kind, 10, 64, 3, SEED + 10)
    return {"config": dict(model=model, num_classes=3, num_point=64, batch_size=4, seed=SEED), "data": data}


def _bn_inputs():
    rng = np.random.RandomState(SEED)
    x = (rng.randn(8, 5, 6) * 3.0 + 1.5).astype(np.float32)
    a = rng.randn(4, 6, 5).astype(np.float32)
    s = rng.randn(4, 6, 5).astype(np.float32)
    red = {"s": s, "q2": (s * s / 3 + np.abs(rng.randn(4, 6, 5))).astype(np.float32),
           "mmax": np.abs(rng.randn(4, 6, 5)).astype(np.float32),
           "mmin": -np.abs(rng.randn(4, 6, 5)).astype(np.float32)}
    return {"x": x, "wx": rng.randn(8, 5, 6).astype(np.float32), "a": a, "red": red,
            "wa": rng.randn(4, 6, 5).astype(np.float32), "scale": (1 + 0.3 * rng.randn(5)).astype(np.float32),
            "scale6": (1 + 0.3 * rng.randn(6)).astype(np.float32)}


# ------------------------------------------------------- shared by both sides


@contextlib.contextmanager
def _counting():
    """Count calls of the two fused ops that take a BN's statistics."""
    counts = {"dense_bn_exactkey_pool": 0, "grouped_bn_mlp_pool": 0}
    originals = (exactpool.dense_bn_exactkey_pool, pointnet_modules.grouped_bn_mlp_pool)

    def counted(name, fn):
        def run(*args, **kw):
            counts[name] += 1
            return fn(*args, **kw)
        return run

    exactpool.dense_bn_exactkey_pool = counted("dense_bn_exactkey_pool", originals[0])
    pointnet_modules.grouped_bn_mlp_pool = counted("grouped_bn_mlp_pool", originals[1])
    try:
        yield counts
    finally:
        exactpool.dense_bn_exactkey_pool, pointnet_modules.grouped_bn_mlp_pool = originals


def _bn_forward_f64(self, x, bn_momentum=None, f32_key_input=None, dtype=None):
    """``BatchNorm.forward`` in training with its statistics, their
    cross-replica mean and the normalisation in float64, returning f32
    (module doc)."""
    assert self.training and f32_key_input is None and dtype is None
    xf = x.double()
    axes = tuple(range(x.dim() - 1))
    mean, mean2 = self.global_moments(xf.mean(dim=axes), torch.square(xf).mean(dim=axes))
    var = torch.clamp(mean2 - torch.square(mean), min=0.0)
    self.update_running(mean.float(), var.float(), bn_momentum)
    y = (xf - mean) * torch.rsqrt(var + self.epsilon)
    return (y * self.scale.double() + self.bias.double()).float()


def _pair_f64(self, a, red, k, bn_momentum=None):
    """``_PairBN.pair`` in training, in float64 as ``_bn_forward_f64``."""
    af, s = a.double(), red["s"].double()
    count = af.shape[0] * af.shape[1] * k
    mean = (k * af.sum(dim=(0, 1)) + s.sum(dim=(0, 1))) / count
    mean2 = (k * torch.square(af) + 2.0 * af * s + red["q2"].double()).sum(dim=(0, 1)) / count
    mean, mean2 = self.global_moments(mean, mean2)
    var = torch.clamp(mean2 - torch.square(mean), min=0.0)
    self.update_running(mean.float(), var.float(), bn_momentum)
    m_sel = torch.where(self.scale >= 0, red["mmax"], red["mmin"]).double()
    y = (af + m_sel - mean) * torch.rsqrt(var + self.epsilon)
    return (y * self.scale.double() + self.bias.double()).float()


def _satrain_stats_f64(h, group=None):
    """The fused tail's training statistics in float64, with their
    cross-replica mean, rounded to f32 once (module doc)."""
    import torch.distributed as dist

    hf = h.double()
    axes = tuple(range(h.dim() - 1))
    both = torch.cat([hf.mean(dim=axes), torch.square(hf).mean(dim=axes)])
    if group is not None:
        dist.all_reduce(both, group=group)
        both /= dist.get_world_size(group)
    mean, mean2 = both.split(h.shape[-1])
    return mean.float(), torch.clamp(mean2 - torch.square(mean), min=0.0).float()


@contextlib.contextmanager
def _f64_bn(on: bool):
    """The f32 steps' training statistics in float64 (module doc)."""
    from scanobjectnn_torch.models.dgcnn import _PairBN

    with contextlib.ExitStack() as stack:
        if on:
            stack.enter_context(mock.patch.object(layers.BatchNorm, "forward", _bn_forward_f64))
            stack.enter_context(mock.patch.object(_PairBN, "pair", _pair_f64))
            stack.enter_context(mock.patch.object(satrain_kernel, "_stats", _satrain_stats_f64))
        yield


@contextlib.contextmanager
def _control(name: str | None):
    """A planted fault of the two-rank step (module doc); None: none."""
    with contextlib.ExitStack() as stack:
        if name == "no_average":
            stack.enter_context(mock.patch.object(Trainer, "_average_gradients", lambda self, model: None))
        elif name == "local_draws":
            stack.enter_context(mock.patch.object(trainer_lib, "global_batch", lambda mesh: contextlib.nullcontext()))
        yield


def _run_steps(spec: dict, mesh=None, variables=None, no_dropout: bool = False, control: str | None = None) -> dict:
    """The spec's steps through a ``Trainer`` (on ``mesh``; with a
    ``control``'s fault): each step's metrics, the last step's gradients,
    the parameters and buffers after, and the fused-op calls."""
    trainer = Trainer(TrainerConfig(**spec["config"], device="cpu"), mesh=mesh)
    state = trainer.init_state()
    if variables is not None:
        convert.load_jax_variables(state.model, variables)
    if no_dropout:
        for module in state.model.modules():
            if hasattr(module, "dropout_keep"):
                module.dropout_keep = 1.0
    if control == "local_bn":
        layers.configure_parallel(state.model, None)
    metrics = []
    with _counting() as counts, _f64_bn(spec.get("f64_bn", False)), _control(control):
        for batch in spec["batches"]:
            state, m = trainer.train_step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
    grads = {n: None if p.grad is None else p.grad.float().clone() for n, p in state.model.named_parameters()}
    return {"metrics": metrics, "grads": grads, "state": {k: v.clone() for k, v in state.model.state_dict().items()},
            "counts": dict(counts)}


def _bn_run(inp: dict, sharding, group) -> dict:
    """``BatchNorm`` and ``_PairBN.pair`` in training on ``sharding``'s rows
    of the inputs, with ``group``: outputs, running stats, gradients."""
    from scanobjectnn_torch.models.dgcnn import _PairBN

    out = {}
    bn = layers.BatchNorm(6)
    bn.group = group
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(inp["scale6"]))
    rows = sharding.rows(len(inp["x"]))
    x = torch.from_numpy(inp["x"][rows]).requires_grad_()
    y = bn.train()(x, 0.9)
    (y * torch.from_numpy(inp["wx"][rows])).sum().backward()
    out["bn"] = {"y": y.detach(), "dx": x.grad, "dscale": bn.scale.grad, "dbias": bn.bias.grad,
                 "mean": bn.mean.clone(), "var": bn.var.clone()}
    pair = _PairBN(5)
    pair.group = group
    with torch.no_grad():
        pair.scale.copy_(torch.from_numpy(inp["scale"]))  # some negative: mmin picked there
    k = 3
    rows = sharding.rows(len(inp["a"]))
    a = torch.from_numpy(inp["a"][rows]).requires_grad_()
    red = {key: torch.from_numpy(v[rows]).requires_grad_() for key, v in inp["red"].items()}
    y = pair.train().pair(a, red, k, 0.9)
    (y * torch.from_numpy(inp["wa"][rows])).sum().backward()
    out["pair"] = {"y": y.detach(), "da": a.grad, "ds": red["s"].grad, "dq2": red["q2"].grad,
                   "dscale": pair.scale.grad, "dbias": pair.bias.grad, "mean": pair.mean.clone(),
                   "var": pair.var.clone()}
    return out


def _rank_job(rank: int, init_file: str, spec_path: str, out_path: str) -> None:
    """One rank's cases (module doc)."""
    import torch.distributed as dist

    torch.set_num_threads(1)  # the CPU's multithreaded scatter-add sums in no fixed order
    spec = torch.load(spec_path, weights_only=False)
    out = {}
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=WORLD)
    try:
        mesh = mesh_lib.make_mesh("cpu")
        assert (mesh.rank, mesh.size) == (rank, WORLD)
        out["bn"] = _bn_run(spec["bn"], mesh_lib.batch_sharding(mesh), mesh.group)
        out["basic"] = _run_steps(spec["basic"], mesh, spec["basic_variables"], no_dropout=True)
        out["steps"] = {name: _run_steps(s, mesh) for name, s in spec["steps"].items()}
        out["controls"] = {(control, name): _run_steps(spec["steps"][name], mesh, control=control)
                           for control, names in CONTROLS.items() for name in names}
        out["eval"] = {}
        for name, s in spec["eval"].items():
            trainer = Trainer(TrainerConfig(**s["config"], device="cpu"), mesh=mesh)
            d = s["data"]
            out["eval"][name] = trainer.evaluate(trainer.init_state(), d["points"], d["labels"],
                                                 masks=d.get("masks"), num_votes=2)
    finally:
        dist.destroy_process_group()
    # A group of its own of world one: the steps of the no-group trainer.
    dist.init_process_group("gloo", init_method=f"file://{init_file}.{rank}", rank=0, world_size=1)
    try:
        solo = {}
        for name in sorted(spec["steps"])[rank::WORLD]:
            solo[name] = (_run_steps(spec["steps"][name], mesh_lib.make_mesh("cpu")),
                          _run_steps(spec["steps"][name]))
        out["solo"] = solo
    finally:
        dist.destroy_process_group()
    torch.save(out, out_path)


# ---------------------------------------------------------------- fixtures


def _basic_batch() -> dict:
    data, labels = make_synthetic_dataset(num_per_class=3, num_classes=3, num_points=BASIC["num_point"], seed=SEED)
    order = np.random.RandomState(SEED).permutation(len(data))[: BASIC["batch_size"]]
    return {"points": data[order], "labels": labels[order]}


@pytest.fixture(scope="module")
def jax_basic():
    """JAX's ``Trainer`` on a 2-device mesh: ``pointnet_cls_basic``'s
    variables at init and after 3 momentum steps, dropout the identity."""
    import flax.linen as fnn
    import jax

    from scanobjectnn_tpu.parallel import mesh as jmesh
    from scanobjectnn_tpu.train import Trainer as JaxTrainer
    from scanobjectnn_tpu.train import TrainerConfig as JaxTrainerConfig

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn, "Dropout", lambda rate, deterministic: (lambda h: h))
        trainer = JaxTrainer(JaxTrainerConfig(**BASIC), mesh=jmesh.make_mesh(devices=jax.devices()[:WORLD]))
        state = trainer.init_state(0)
        init = jax.tree_util.tree_map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
        batch, losses = _basic_batch(), []
        for _ in range(3):
            state, metrics = trainer.train_step(state, batch, jax.random.PRNGKey(0))
            losses.append(float(metrics["loss"]))
    after = jax.tree_util.tree_map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    return init, losses, convert.jax_to_state_dict(after)


@pytest.fixture(scope="module")
def specs(jax_basic):
    return {
        "bn": _bn_inputs(),
        "basic": {"config": dict(BASIC, seed=SEED), "batches": [_basic_batch()] * 3},
        "basic_variables": jax_basic[0],
        "steps": {name: _step_spec(name) for name in STEP_CASES},
        "eval": {name: _eval_spec(name) for name in EVAL_CASES},
    }


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, specs):
    """Every rank's results (module doc)."""
    import time

    tmp = tmp_path_factory.mktemp("ranks")
    spec_path = str(tmp / "spec.pt")
    torch.save(specs, spec_path)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_job, args=(r, str(tmp / "init"), spec_path, str(tmp / f"out{r}.pt")))
             for r in range(WORLD)]
    t0 = time.monotonic()
    for p in procs:
        p.start()
    for p in procs:
        p.join(max(0.0, JOIN_TIMEOUT - (time.monotonic() - t0)))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    assert not hung, f"{len(hung)} rank(s) still running after {JOIN_TIMEOUT} s: killed"
    assert [p.exitcode for p in procs] == [0] * WORLD, f"rank exit codes {[p.exitcode for p in procs]}"
    print(f"two ranks: {time.monotonic() - t0:.1f} s")
    return [torch.load(str(tmp / f"out{r}.pt"), weights_only=False) for r in range(WORLD)]


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, bound = float(np.abs(got - want).max(initial=0.0)), tol * max(1.0, float(np.abs(want).max(initial=0.0)))
    assert err <= bound, f"{what}: {err:.3e} > {bound:.3e}"
    return err / max(1.0, float(np.abs(want).max(initial=0.0)))


# ------------------------------------------------------------- (a) helpers


def test_make_mesh_without_a_group_is_a_world_of_one():
    mesh = mesh_lib.make_mesh("cpu")
    assert (mesh.size, mesh.rank, mesh.group, mesh.axis_name) == (1, 0, None, "data")
    assert mesh_lib.batch_sharding(mesh).rows(6) == slice(0, 6)
    assert mesh_lib.replicated_sharding(mesh).rows(5) == slice(0, 5)
    batch = {"points": np.arange(12, dtype=np.float32).reshape(6, 2), "labels": np.arange(6)}
    shard = mesh_lib.shard_batch(batch, mesh)
    assert shard["points"].device.type == "cpu"
    np.testing.assert_array_equal(shard["points"].numpy(), batch["points"])
    trainer = Trainer(TrainerConfig(model="pointnet_cls_basic", num_classes=3, device="cpu"), mesh=mesh)
    assert trainer.world == 1 and trainer.is_main
    with mesh_lib.global_batch(mesh):  # no group: this process's draws
        assert mesh_lib.draw_rows(lambda n, mine: torch.arange(n), 3).tolist() == [0, 1, 2]


def test_rows_split_contiguously_and_an_uneven_batch_raises():
    mesh = mesh_lib.Mesh("data", 4, 2, torch.device("cpu"), None)
    assert mesh_lib.batch_sharding(mesh).rows(8) == slice(4, 6)
    shard = mesh_lib.shard_batch({"points": np.arange(8)}, mesh)
    assert shard["points"].tolist() == [4, 5]
    with pytest.raises(ValueError, match="does not split evenly"):
        mesh_lib.batch_sharding(mesh).rows(6)
    with pytest.raises(ValueError, match="does not split evenly"):
        mesh_lib.shard_batch({"points": np.arange(10)}, mesh)
    with pytest.raises(ValueError, match="not 'model'"):
        mesh_lib.batch_sharding(mesh, "model")


def test_make_mesh_refuses_what_it_cannot_be():
    with pytest.raises(ValueError, match="one device"):
        mesh_lib.make_mesh(["cpu", "cpu"])
    with pytest.raises(ValueError, match="one axis"):
        mesh_lib.make_mesh("cpu", axes=("data", "model"), shape=(1, 1))
    assert mesh_lib.make_mesh("cpu", axes=("batch",), shape=(1,)).axis_name == "batch"
    with pytest.raises(ValueError, match="does not hold"):
        mesh_lib.make_mesh("cpu", shape=(2,))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            mesh_lib.make_mesh()  # cuda:LOCAL_RANK, the default
    two = mesh_lib.Mesh("data", 2, 0, torch.device("cpu"), object())
    with pytest.raises(ValueError, match="does not split"):
        Trainer(TrainerConfig(model="pointnet_cls_basic", batch_size=5, device="cpu"), mesh=two)
    with pytest.raises(ValueError, match="not config.device"):
        Trainer(TrainerConfig(model="pointnet_cls_basic", batch_size=4), mesh=two)


def test_draws_are_the_global_batchs_rows():
    """Each rank's dropout mask and "ids" sample are its rows of the one
    process's draw on the global batch (no collective: a sentinel group)."""
    from scanobjectnn_torch.models.pointnet2 import dropout
    from scanobjectnn_torch.nn.xconv import inverse_density_sample

    rng = np.random.RandomState(SEED)
    h = torch.from_numpy(rng.randn(6, 5, 7).astype(np.float32))
    pts = torch.from_numpy(rng.rand(6, 40, 3).astype(np.float32))
    want_h = dropout(h, 0.7, True, torch.Generator().manual_seed(1))
    want_i = inverse_density_sample(torch.Generator().manual_seed(1), pts, 4, 9)
    for rank in range(3):
        mesh = mesh_lib.Mesh("data", 3, rank, torch.device("cpu"), object())
        rows = mesh_lib.batch_sharding(mesh).rows(6)
        with mesh_lib.global_batch(mesh):
            got_h = dropout(h[rows], 0.7, True, torch.Generator().manual_seed(1))
            got_i = inverse_density_sample(torch.Generator().manual_seed(1), pts[rows], 4, 9)
        assert torch.equal(got_h, want_h[rows]) and torch.equal(got_i, want_i[rows])


# ------------------------------------------------------------- (b) BatchNorm


def test_cross_replica_bn_on_two_ranks_equals_one_process(ranks, specs):
    want = _bn_run(specs["bn"], mesh_lib.RowSharding(0, 1), None)
    for layer, grads, summed in (("bn", ("dx",), ("dscale", "dbias")),
                                 ("pair", ("da", "ds", "dq2"), ("dscale", "dbias"))):
        w = want[layer]
        for key in ("y", *grads):
            _close(torch.cat([r["bn"][layer][key] for r in ranks]), w[key], BN_TOL, f"{layer} {key}")
        for key in summed:
            _close(sum(r["bn"][layer][key] for r in ranks), w[key], BN_TOL, f"{layer} {key} summed over ranks")
        for key in ("mean", "var"):
            for r in ranks:
                _close(r["bn"][layer][key], w[key], BN_TOL, f"{layer} running {key}")
            assert torch.equal(ranks[0]["bn"][layer][key], ranks[1]["bn"][layer][key])


def test_cross_replica_bn_on_two_ranks_equals_jax_shard_map(ranks, specs):
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from scanobjectnn_tpu.models.dgcnn import _PairBN as JaxPairBN
    from scanobjectnn_tpu.nn.layers import BatchNorm as JaxBatchNorm
    from scanobjectnn_tpu.parallel import mesh as jmesh

    inp = specs["bn"]
    mesh = jmesh.make_mesh(devices=jax.devices()[:WORLD])
    bn = JaxBatchNorm(axis_name="data")
    v = JaxBatchNorm().init(jax.random.PRNGKey(0), jnp.asarray(inp["x"]), False)  # the same tree
    v = {"params": {"scale": jnp.asarray(inp["scale6"]), "bias": v["params"]["bias"]}, "batch_stats": v["batch_stats"]}

    @partial(jax.shard_map, mesh=mesh, in_specs=P("data"), out_specs=(P("data"), P(), P()))
    def sharded_bn(xs):
        y, mut = bn.apply(v, xs, False, 0.9, mutable=["batch_stats"])
        return y, mut["batch_stats"]["mean"], mut["batch_stats"]["var"]

    pair = JaxPairBN(k=3, axis_name="data")
    red = {k: jnp.asarray(a) for k, a in inp["red"].items()}
    pv = JaxPairBN(k=3).init(jax.random.PRNGKey(0), jnp.asarray(inp["a"]), red, False)
    pv = {"params": {"scale": jnp.asarray(inp["scale"]), "bias": pv["params"]["bias"]},
          "batch_stats": pv["batch_stats"]}

    @partial(jax.shard_map, mesh=mesh, in_specs=(P("data"), P("data")), out_specs=(P("data"), P(), P()))
    def sharded_pair(a, r):
        y, mut = pair.apply(pv, a, r, False, 0.9, mutable=["batch_stats"])
        return y, mut["batch_stats"]["mean"], mut["batch_stats"]["var"]

    for layer, (y, mean, var) in (("bn", sharded_bn(jnp.asarray(inp["x"]))),
                                  ("pair", sharded_pair(jnp.asarray(inp["a"]), red))):
        got = torch.cat([r["bn"][layer]["y"] for r in ranks]).numpy()
        np.testing.assert_allclose(got, np.asarray(y), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(ranks[0]["bn"][layer]["mean"].numpy(), np.asarray(mean), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(ranks[0]["bn"][layer]["var"].numpy(), np.asarray(var), rtol=1e-4)


# ---------------------------------------------------------------- (c) steps


def _reading(got: dict, want: dict, f32: dict | None = None) -> tuple[float, str]:
    """A two-rank step (``got``: the ranks' mean loss, rank 0's gradients
    and state) against one process (module doc; with ``f32``, the f32 step,
    the bf16 rule): the largest of each reading over its limit, so at most
    1 passes, and where it is."""
    worst = [0.0, "nothing"]

    def read(err: float, limit: float, what: str) -> None:
        if err / limit > worst[0]:
            worst[:] = [err / limit, f"{what}: {err:.3e} against {limit:.3e}"]

    loss, ref = got["loss"], want["metrics"][-1]["loss"]
    if f32 is None:
        read(abs(loss - ref), LOSS_RTOL * abs(ref), "loss")
    else:
        truth = f32["metrics"][-1]["loss"]
        read(abs(loss - truth), max(BF16_RATIO * abs(ref - truth), BF16_LOSS_RTOL * abs(truth)), "loss from f32")
    for pname, g in want["grads"].items():
        mine = got["grads"][pname]
        if g is None or mine is None:
            read(0.0 if g is None and mine is None else np.inf, 1.0, f"grad {pname} (None on one side)")
            continue
        leaf, layer = pname.split(".")[-1], pname.split(".")[-2]
        if f32 is not None:
            truth = f32["grads"][pname]
            scale = max(1.0, float(truth.abs().max()))
            e2, e1 = (float((t - truth).abs().max()) / scale for t in (mine, g))
            read(e2, max(BF16_RATIO * e1, BF16_GRAD_TOL), f"grad {pname} from f32, of its scale")
        elif leaf == "bias" and (layer.startswith("dense_") or layer in ("fc1", "fc2")):
            read(float(mine.abs().max()), ZERO_GRAD_TOL, f"grad {pname} (true gradient 0)")
        else:
            read(float((mine - g).abs().max()), GRAD_TOL * max(1.0, float(g.abs().max())), f"grad {pname}")
    if f32 is None:
        for key, value in want["state"].items():
            if key.endswith((".mean", ".var")):
                scale = max(1.0, float(value.abs().max()))
                read(float((got["state"][key] - value).abs().max()), STATS_TOL * scale, key)
    return worst[0], worst[1]


def _two_ranks(per_rank: list) -> dict:
    return {"loss": float(np.mean([r["metrics"][-1]["loss"] for r in per_rank])), "grads": per_rank[0]["grads"],
            "state": per_rank[0]["state"]}


def _f32_spec(spec: dict) -> dict | None:
    """A bf16 case's f32 step (float64 statistics); None for an f32 case."""
    if spec["config"].get("dtype") != "bfloat16":
        return None
    return dict(spec, config=dict(spec["config"], dtype="float32"), f64_bn=True)


@pytest.fixture(scope="module")
def one_process(specs):
    """The one-process step of every case and, for a bf16 case, its f32
    step (``(name, "f32")``)."""
    out = {name: _run_steps(specs["steps"][name]) for name in STEP_CASES}
    out.update({(name, "f32"): _run_steps(_f32_spec(specs["steps"][name]))
                for name in STEP_CASES if _f32_spec(specs["steps"][name])})
    return out


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_two_rank_step_equals_one_process(ranks, specs, one_process, name):
    want = one_process[name]
    per_rank = [r["steps"][name] for r in ranks]
    fused = want["counts"]
    if name in FUSED_OP:
        assert fused[FUSED_OP[name]] > 0, fused
    for r in per_rank:  # the fused ops run on two ranks as in one process
        assert r["counts"] == fused, (r["counts"], fused)
    for key, value in per_rank[0]["state"].items():  # the replicas stay equal
        assert torch.equal(value, per_rank[1]["state"][key]), key
    ratio, where = _reading(_two_ranks(per_rank), want, one_process.get((name, "f32")))
    print(f"{name}: two ranks against one process, largest reading over its limit {ratio:.3e} ({where})")
    assert ratio <= 1.0, where


@pytest.mark.parametrize("control,name", [(c, n) for c, names in sorted(CONTROLS.items()) for n in names])
def test_two_rank_step_controls_fail_the_comparison(ranks, specs, one_process, control, name):
    """Each planted fault moves the two-rank step past the limits that the
    real step keeps (module doc)."""
    ratio, where = _reading(_two_ranks([r["controls"][(control, name)] for r in ranks]), one_process[name],
                            one_process.get((name, "f32")))
    print(f"{control} on {name}: largest reading over its limit {ratio:.3e} ({where})")
    assert ratio > 1.0, f"the {control} control passes the comparison: {where}"


def test_basic_momentum_steps_equal_one_process_and_jax_on_two_devices(ranks, specs, jax_basic):
    _, jax_losses, jax_after = jax_basic
    want = _run_steps(specs["basic"], variables=specs["basic_variables"], no_dropout=True)
    got = [r["basic"] for r in ranks]
    losses = [float(np.mean([g["metrics"][i]["loss"] for g in got])) for i in range(3)]
    np.testing.assert_allclose(losses, [m["loss"] for m in want["metrics"]], rtol=JAX_LOSS_RTOL)
    np.testing.assert_allclose(losses, jax_losses, rtol=JAX_LOSS_RTOL)
    worst = {"one process": 0.0, "jax": 0.0}
    for key, value in got[0]["state"].items():
        assert torch.equal(value, got[1]["state"][key]), key
        for ref_name, ref in (("one process", want["state"][key].numpy()), ("jax", jax_after[key].numpy())):
            np.testing.assert_allclose(value.numpy(), ref, rtol=JAX_RTOL, atol=JAX_ATOL, err_msg=f"{ref_name} {key}")
            worst[ref_name] = max(worst[ref_name], float(np.abs(value.numpy() - ref).max()))
    print(f"pointnet_cls_basic 3 momentum steps: losses {losses}; largest parameter difference {worst}")


def test_fused_ops_run_at_world_one_and_its_steps_are_the_no_group_steps_bit_for_bit(ranks):
    solo = {name: pair for r in ranks for name, pair in r["solo"].items()}
    assert sorted(solo) == sorted(STEP_CASES)
    assert solo["ssg_f32"][0]["counts"]["grouped_bn_mlp_pool"] > 0
    assert solo["ssg_bf16"][0]["counts"]["dense_bn_exactkey_pool"] > 0
    for name, (grouped, alone) in solo.items():
        assert grouped["counts"] == alone["counts"], name
        assert grouped["metrics"] == alone["metrics"], name
        for key, value in alone["state"].items():
            assert torch.equal(grouped["state"][key], value), f"{name} {key}"
        for key, value in alone["grads"].items():
            assert (value is None and grouped["grads"][key] is None) or torch.equal(grouped["grads"][key], value), key


# ------------------------------------------------------------- (d) evaluate


@pytest.mark.parametrize("name", sorted(EVAL_CASES))
def test_evaluate_on_two_ranks_equals_one_process(ranks, specs, name):
    s = specs["eval"][name]
    trainer = Trainer(TrainerConfig(**s["config"], device="cpu"))
    d = s["data"]
    want = trainer.evaluate(trainer.init_state(), d["points"], d["labels"], masks=d.get("masks"), num_votes=2)
    assert want["total_seen"] == 10
    for r in ranks:
        got = r["eval"][name]
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            if key == "mean_loss":
                np.testing.assert_allclose(got[key], value, rtol=1e-6)
            elif isinstance(value, np.ndarray):
                np.testing.assert_array_equal(got[key], value, err_msg=key)
            else:
                assert got[key] == value, key
