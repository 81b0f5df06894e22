"""PyTorch port, the synthetic-hard quality harness
(``scanobjectnn_torch/train/synth_hard.py``) against the JAX package's
``scripts/synthetic_hard_bench.py`` (loaded by path), on the CPU.

Held equal: ``ROWS``; the flags (the port adds ``--device`` and takes
``--pool_f32 0``, the counterpart of JAX's ``SCANOBJECTNN_SA_POOL_F32=0``);
``build_data``, array for array; the ``TrainerConfig`` each ``run_row``
builds (both trainers replaced by recorders: every shared field, the pool
mode each trainer resolves, what ``fit`` and ``evaluate`` are given and the
row dict), under no ``--pool_f32``, ``0``, ``1`` and ``keys``; and the
markdown and json each ``main`` writes with ``run_row`` stubbed alike, with
and without ``--merge``, but for the port's device line.  The port on its
own: one real row on the CPU end to end.

The harness's shapes: at ``--num_point 128`` SA1 of the PointNet++ family
asks FPS for 512 centroids from 128 points.  The port's plain FPS is held
there to JAX's lax and interpreted Pallas FPS exactly, and a full-width
SSG forward at B=2, N=128 to the JAX model's unfused path on the same
weights (``tests/test_torch_pointnet2_ssg.py``'s tolerance and pinning).

The results: ``synth_hard_torch.json`` (the 21 rows trained on the H100)
against ``synth_hard.json`` (the JAX package's, trained on the TPU): every
f32, ``+poolf32`` and ``+poolkeys`` accuracy within 0.10 of its JAX row,
every seg and part accuracy within 0.03; JAX's floors.  The native bf16
rows are not banded.  The rows in ``PLATFORM_ROWS`` are held, under the
same bands, to JAX's own CPU rows (``synth_hard_jax_cpu.json``) instead.
"""

import contextlib
import importlib.util
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanobjectnn_torch.convert import load_jax_variables
from scanobjectnn_torch.models import get_model
from scanobjectnn_torch.ops.cuda.fps_kernel import fps_plain
from scanobjectnn_torch.train import synth_hard
from scanobjectnn_torch.train import trainer as torch_trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POOL_ENV = "SCANOBJECTNN_SA_POOL_F32"
# The keys of the JAX script's row dict.
ROW_KEYS = {"model", "dtype", "bga", "accuracy", "seg_accuracy", "avg_part_accuracy", "wall_sec"}
# A cls row, a BGA row, a parts row and a bf16 row.
SAMPLE_ROWS = [r for r in synth_hard.ROWS if r in {
    ("pointnet_cls_basic", False, "float32"), ("pointnet2_cls_bga", True, "float32"),
    ("pointnet_partseg", "parts", "float32"), ("pointnet2_cls_ssg", False, "bfloat16")}]
POOLS = [None, "0", "1", "keys"]


@pytest.fixture(scope="module")
def jax_harness():
    spec = importlib.util.spec_from_file_location("synthetic_hard_bench", os.path.join(REPO, "scripts",
                                                                                       "synthetic_hard_bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def pool_env(monkeypatch):
    """JAX's ``main`` writes the pool variable into ``os.environ``: restore
    it after the test (set to "", which JAX reads as unset)."""
    from scanobjectnn_tpu import kernelconfig

    monkeypatch.setenv(POOL_ENV, "")
    monkeypatch.setattr(kernelconfig, "_active", kernelconfig.active())  # a JAX Trainer writes it
    return monkeypatch


def test_rows_equal_jaxs(jax_harness):
    assert synth_hard.ROWS == jax_harness.ROWS and len(synth_hard.ROWS) == 17


def _options(main) -> set:
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        main(["--help"])
    return {word.rstrip(",") for word in out.getvalue().split() if word.startswith("--")}


def test_flags_are_jaxs_plus_device(jax_harness):
    assert _options(synth_hard.main) == _options(jax_harness.main) | {"--device"}
    args = synth_hard.build_parser().parse_args([])
    assert (args.epochs, args.num_point, args.models, args.merge, args.pool_f32) == (150, 128, None, False, None)
    assert (args.device, args.output, args.json_out) == ("cuda", "SYNTH_HARD_TORCH.md", "synth_hard_torch.json")
    for flag, want in (([], None), (["--pool_f32"], "1"), (["--pool_f32", "keys"], "keys"),
                       (["--pool_f32", "0"], "0")):
        assert synth_hard.build_parser().parse_args(flag).pool_f32 == want


def test_build_data_equals_jaxs(jax_harness):
    got, want = synth_hard.build_data(64), jax_harness.build_data(64)
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"points", "labels", "masks", "parts"}
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    assert got[0]["points"].shape == (600, 64, 3) and got[1]["points"].shape == (360, 64, 3)


def _evaluation(supervision) -> dict:
    if supervision == "parts":
        return {"seg_accuracy": 0.91234, "avg_part_accuracy": 0.87654, "total_seen": 360}
    out = {"accuracy": 0.456789, "avg_class_accuracy": 0.4, "total_seen": 360}
    return {**out, "seg_accuracy": 0.95678} if supervision is True else out


def _recorders(jax_trainer_cls, supervision, record):
    """The two trainers with ``fit`` and ``evaluate`` recorded, the rest
    (config checks, the pool mode's resolution) their own."""
    from scanobjectnn_tpu import kernelconfig

    def recorded(side, base, pool_mode):
        class Recorder(base):
            def __init__(self, cfg, *a, **kw):
                super().__init__(cfg, *a, **kw)
                record[side] = {"config": cfg, "pool_mode": pool_mode(self)}

            def fit(self, data, *a, **kw):
                record[side]["fit"] = ({k: v for k, v in data.items()}, a, kw)
                return "state"

            def evaluate(self, state, points, labels, **kw):
                record[side]["evaluate"] = (state, points, labels, kw)
                return _evaluation(supervision)

        return Recorder

    return (recorded("jax", jax_trainer_cls, lambda _: kernelconfig.pool_mode()),
            recorded("port", torch_trainer.Trainer, lambda t: t.pool_mode))


@pytest.mark.parametrize("pool", POOLS, ids=["none", "0", "1", "keys"])
@pytest.mark.parametrize("row", SAMPLE_ROWS, ids=[f"{m}-{d}" for m, _, d in SAMPLE_ROWS])
def test_run_row_builds_jaxs_config(jax_harness, pool_env, row, pool):
    import argparse

    import scanobjectnn_tpu.train as jax_train

    model, supervision, dtype = row
    record = {}
    jax_rec, port_rec = _recorders(jax_train.Trainer, supervision, record)
    pool_env.setattr(jax_train, "Trainer", jax_rec)
    pool_env.setattr(torch_trainer, "Trainer", port_rec)
    if pool is not None:
        pool_env.setenv(POOL_ENV, pool)  # what JAX's main sets (and "0" by hand: its flag refuses it)
    train, test = synth_hard.build_data(16)
    args = argparse.Namespace(epochs=3, num_point=8, pool_f32=pool, device="cpu")
    rows = {"jax": jax_harness.run_row(model, supervision, dtype, train, test, args),
            "port": synth_hard.run_row(model, supervision, dtype, train, test, args)}

    jcfg, pcfg = record["jax"]["config"], record["port"]["config"]
    shared = set(vars(jcfg)) & set(vars(pcfg))
    assert shared >= {"model", "num_classes", "num_point", "batch_size", "max_epoch", "learning_rate", "seed",
                      "dtype", "augment_rotate", "pool_precision"}
    for field in sorted(shared - {"pool_precision"}):
        assert getattr(pcfg, field) == getattr(jcfg, field), field
    assert pcfg.device == "cpu" and (pcfg.max_epoch, pcfg.num_point, pcfg.batch_size) == (3, 8, 24)
    # JAX sets the pool through the environment, the port through its config.
    assert jcfg.pool_precision == "auto"
    assert pcfg.pool_precision == {None: "auto", "0": "native", "1": "f32", "keys": "keys"}[pool]
    assert record["port"]["pool_mode"] == record["jax"]["pool_mode"]
    assert record["jax"]["pool_mode"] == (pool or ("keys" if dtype == "bfloat16" else "0"))

    (jdata, ja, jkw), (pdata, pa, pkw) = record["jax"]["fit"], record["port"]["fit"]
    assert (pa, pkw) == (ja, jkw) == ((), {})  # no test set: fit's device-resident path
    assert pdata.keys() == jdata.keys()
    assert all(pdata[k] is jdata[k] for k in jdata)
    (_, jp, jl, jev), (_, pp, pl, pev) = record["jax"]["evaluate"], record["port"]["evaluate"]
    assert pp is jp and pl is jl and pev.keys() == jev.keys() == {"masks", "parts", "num_votes"}
    assert all(pev[k] is jev[k] for k in jev) and pev["num_votes"] == 1

    assert set(rows["jax"]) == ROW_KEYS
    rows["port"].pop("wall_sec"), rows["jax"].pop("wall_sec")
    assert rows["port"] == rows["jax"]


def _stub_row(model, supervision, dtype, train, test, args):
    n = len(model) + len(dtype) + args.epochs
    return {
        "model": model, "dtype": dtype, "bga": supervision is True,
        "accuracy": None if supervision == "parts" else round(n / 50.0, 4),
        "seg_accuracy": round(n / 60.0, 4) if supervision else -1.0,
        "avg_part_accuracy": round(n / 70.0, 4) if supervision == "parts" else None,
        "wall_sec": float(n),
    }


def _run_both(jax_harness, monkeypatch, tmp_path, argv, pool) -> dict:
    out = {}
    for side, module in (("port", synth_hard), ("jax", jax_harness)):
        monkeypatch.setattr(module, "run_row", _stub_row)
        monkeypatch.setattr(module, "build_data", lambda n: ({}, {}))
        monkeypatch.setenv(POOL_ENV, "")
        flags = list(argv) + (["--device", "cpu"] if side == "port" else [])
        if pool == "0":  # JAX's counterpart of --pool_f32 0 is its variable
            if side == "port":
                flags += ["--pool_f32", "0"]
            else:
                monkeypatch.setenv(POOL_ENV, "0")
        elif pool is not None:
            flags += ["--pool_f32", pool]
        md, js = str(tmp_path / f"{side}.md"), str(tmp_path / f"{side}.json")
        with contextlib.redirect_stdout(io.StringIO()):
            module.main(flags + ["--output", md, "--json", js])
        with open(md) as f, open(js) as g:
            out[side] = (f.read(), json.load(g))
    return out


@pytest.mark.parametrize("merge", [False, True], ids=["fresh", "merge"])
@pytest.mark.parametrize("pool", POOLS, ids=["none", "0", "1", "keys"])
def test_markdown_and_json_equal_jaxs_on_stubbed_rows(jax_harness, pool_env, tmp_path, merge, pool):
    models = "pointnet_cls_basic,pointnet2_cls_bga,pointnet_partseg:float32,pointnet2_cls_ssg:bfloat16"
    if merge:
        _run_both(jax_harness, pool_env, tmp_path, ["--models", "dgcnn,pointcnn_cls", "--epochs", "2"], None)
        for side in ("port", "jax"):  # an analysis section, kept across rewrites
            with open(tmp_path / f"{side}.md", "a") as f:
                f.write("\n## Analysis\n\nkept\n")
    got = _run_both(jax_harness, pool_env, tmp_path, ["--models", models] + (["--merge"] if merge else []), pool)
    (port_md, port_json), (jax_md, jax_json) = got["port"], got["jax"]
    assert port_json == jax_json
    lines = port_md.split("\n")
    assert lines[1].startswith("Device: CPU, ") and "plain versions" in lines[1]
    assert "\n".join(lines[:1] + lines[2:]) == jax_md
    tag = {None: "", "0": "", "1": "+poolf32", "keys": "+poolkeys"}[pool]
    assert {(r["model"], r["dtype"]) for r in port_json} >= {("pointnet_cls_basic", "float32" + tag),
                                                             ("pointnet2_cls_ssg", "bfloat16" + tag),
                                                             ("pointnet_cls_basic", "bfloat16" + tag)}
    assert len(port_json) == (8 if merge else 5)
    assert port_md.endswith("## Analysis\n\nkept\n") == merge


def test_one_row_end_to_end_on_cpu(tmp_path, capsys):
    md, js = str(tmp_path / "t.md"), str(tmp_path / "t.json")
    synth_hard.main(["--epochs", "1", "--num_point", "32", "--device", "cpu", "--models",
                     "pointnet_cls_basic:float32", "--output", md, "--json", js])
    with open(js) as f:
        rows = json.load(f)
    assert len(rows) == 1 and set(rows[0]) == ROW_KEYS
    row = rows[0]
    assert (row["model"], row["dtype"], row["bga"]) == ("pointnet_cls_basic", "float32", False)
    assert 0.0 <= row["accuracy"] <= 1.0 and row["seg_accuracy"] == -1.0 and row["avg_part_accuracy"] is None
    with open(md) as f:
        lines = f.read().splitlines()
    assert lines[1].startswith("Device: CPU") and "64→32 pts" in lines[3] and "1 epochs" in lines[3]
    assert len(lines) == 8 and lines[7].startswith("| pointnet_cls_basic | float32 | no | ")
    assert "ops_backend=auto device=cpu" in capsys.readouterr().err


@pytest.mark.parametrize("n", [128, 100, 1])
def test_fps_plain_above_n_equals_jax(n):
    """512 centroids from n points: once every point is taken each step
    takes index 0 (all distances 0, the first maximum)."""
    from scanobjectnn_tpu.ops.fps import farthest_point_sample_lax
    from scanobjectnn_tpu.ops.pallas.fps_kernel import fps_pallas_with_coords

    xyz = np.random.RandomState(n).randn(2, n, 3).astype(np.float32)
    idx, new_xyz = fps_plain(torch.from_numpy(xyz), 512)
    ref = np.asarray(farthest_point_sample_lax(jnp.asarray(xyz), 512))
    np.testing.assert_array_equal(idx.numpy(), ref)
    assert sorted(set(idx[0, :n].tolist())) == list(range(n)) and not idx[:, n:].any()
    np.testing.assert_array_equal(new_xyz.numpy(), np.take_along_axis(xyz, ref[..., None].astype(np.int64), 1))
    p_idx, p_xyz = fps_pallas_with_coords(jnp.asarray(xyz), 512, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(p_idx))
    np.testing.assert_array_equal(new_xyz.numpy(), np.asarray(p_xyz))


def harness_points(b: int = 2) -> np.ndarray:
    """``b`` training clouds of the harness's data at N=128."""
    return synth_hard.build_data(256)[0]["points"][:b, :128].astype(np.float32)


def draw_variables(jmodel, points):
    """JAX variables of ``jmodel``'s init shapes drawn with numpy: kernels
    uniform with unit-variance outputs; BN shifts and scales near their init;
    random positive running stats (``tests/test_torch_pointnet2_ssg.py``'s)."""
    key = jax.random.PRNGKey(0)
    tree = jax.eval_shape(lambda: jmodel.init({"params": key, "dropout": key}, jnp.asarray(points), train=False))
    rng = np.random.RandomState(1)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if path[0].key == "batch_stats":
            value = 0.1 + 0.1 * np.abs(rng.randn(*shape)) if name == "var" else 0.05 * np.abs(rng.randn(*shape))
        elif name == "kernel":
            limit = np.sqrt(3.0 / np.prod(shape[:-1]))
            value = rng.uniform(-limit, limit, shape)
        else:
            value = (1.0 if name == "scale" else 0.0) + 0.1 * rng.randn(*shape)
        return jnp.asarray(value, jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def assert_pinned(sa_configs, levels):
    """No (centroid, point) pair of SA1 or SA2 within 1e-6 of a radius²:
    ``levels`` are the coordinates of the input, SA1 and SA2 [B, n, 3]."""
    for (_, radius, *_), pts, queries in zip(sa_configs[:2], levels[:2], levels[1:3]):
        d2 = ((queries[:, :, None, :].astype(np.float64) - pts[:, None, :, :]) ** 2).sum(-1)
        assert np.abs(d2 - radius * radius).min() > 1e-6


def test_ssg_forward_at_harness_shape_matches_jax(monkeypatch):
    """B=2 clouds of the harness's data at N=128: SA1 takes 512 centroids,
    every point once and then the first point 384 times more.  The JAX side
    is its unfused path (``SCANOBJECTNN_FUSED_SA_EVAL=off``), as the second
    leg of ``tests/test_torch_pointnet2_ssg.py``, with its inputs pinned the
    same way (``assert_pinned``)."""
    from scanobjectnn_tpu import models as jzoo
    from scanobjectnn_torch.models import PointNet2ClsSSG

    monkeypatch.setenv("SCANOBJECTNN_FUSED_SA_EVAL", "off")
    points = harness_points()
    jmodel = jzoo.get_model("pointnet2_cls_ssg", num_classes=6)[0]
    v = draw_variables(jmodel, points)
    forward = jax.jit(lambda variables, x: jmodel.apply(variables, x, train=False)["logits"])
    ref = np.asarray(forward(v, jnp.asarray(points)), np.float32)
    tmodel = load_jax_variables(get_model("pointnet2_cls_ssg", device="cpu", num_classes=6), v).eval()
    with torch.no_grad():
        xyz1, feats1 = tmodel.sa1(torch.from_numpy(points), None)
        xyz2, _ = tmodel.sa2(xyz1, feats1)
        got = tmodel(torch.from_numpy(points))["logits"].numpy()
    assert xyz1.shape == (2, 512, 3) and len(torch.unique(xyz1[0], dim=0)) == 128
    assert_pinned(PointNet2ClsSSG.SA_CONFIGS, (points, xyz1.numpy(), xyz2.numpy()))
    scale = max(1.0, float(np.abs(ref).max()))
    assert got.shape == (2, 6) and float(np.abs(ref).max()) > 0.1
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5 * scale)
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))


# ----------------------------------------------------------------- results

def _load(name: str) -> list:
    with open(os.path.join(REPO, name)) as f:
        return json.load(f)


JAX_RESULTS = _load("synth_hard.json")
ACC_BAND, SEG_BAND = 0.10, 0.03
# JAX's own rows trained on the CPU by the unedited scripts/synthetic_hard_bench.py
# (true f32 products; SYNTH_HARD_JAX_CPU.md).  They are the reference of the rows in
# PLATFORM_ROWS: rows the port does not bring within their band of JAX's TPU row while
# no port fault shows over the run (tests/test_torch_synth_hard_run.py) or step by step
# (studies/synth_hard_lockstep.py), and JAX's CPU run lies within the port's band: a
# platform difference.  The TPU figures stay in SYNTH_HARD_TORCH.md beside them.
JAX_CPU_RESULTS = {(r["model"], r["dtype"]): r for r in _load("synth_hard_jax_cpu.json")}
PLATFORM_ROWS = {("dgcnn_bga", "float32"), ("pointcnn_cls", "float32")}
# Rows of synth_hard_torch.json outside their band: open faults (ROADMAP.md
# queue 3), each with its figures (H100; seeds 0-3 by
# studies/synth_hard_seeds.py, the row itself seed 0 as the harness runs it;
# "plain" the same script's seed 0 with every kernel's plain version on the
# card, --ops_backend lax) and what was ruled out.
OUT_OF_BAND = {
    ("pointnet2_cls_bga", "float32"): "seg accuracy 0.9213 against JAX's 0.9823 (-0.0610, band 0.03); seeds 1-3 "
                                      "read 0.9244, 0.9244, 0.9266, plain 0.9228, TPU-rounded products 0.9224, "
                                      "0.9230; ruled out: the kernels, the schedules, optimizer, epochs, "
                                      "augmentation and dropout over all 3750 steps, and 25 steps held to JAX f32 "
                                      "and float64 on the CPU (no port fault); at 20 epochs JAX on the CPU reads seg "
                                      "0.8730 against the port's seeds 0-3 0.8660-0.8735; JAX's full row on the CPU "
                                      "not run (about 13 h)",
}


def _band_case(ref):
    key = (ref["model"], ref["dtype"])
    marks = [pytest.mark.xfail(strict=True, reason=OUT_OF_BAND[key])] if key in OUT_OF_BAND else []
    return pytest.param(JAX_CPU_RESULTS[key] if key in PLATFORM_ROWS else ref, marks=marks,
                        id=f"{ref['model']}-{ref['dtype']}")


def test_jax_cpu_rows_are_the_jax_scripts():
    """synth_hard_jax_cpu.json: the JAX script's rows, one per platform row."""
    assert set(JAX_CPU_RESULTS) == PLATFORM_ROWS
    tpu = {(r["model"], r["dtype"]): r for r in JAX_RESULTS}
    for key, r in JAX_CPU_RESULTS.items():
        assert set(r) == ROW_KEYS and r["wall_sec"] > 0, key
        assert (r["bga"], r["avg_part_accuracy"]) == (tpu[key]["bga"], tpu[key].get("avg_part_accuracy")), key
        assert (r["seg_accuracy"] >= 0) == (tpu[key]["seg_accuracy"] >= 0), key


def _port_results() -> dict:
    return {(r["model"], r["dtype"]): r for r in _load("synth_hard_torch.json")}


def test_results_hold_jaxs_rows_and_floors():
    port = _port_results()
    assert len(port) == 21 and set(port) == {(r["model"], r["dtype"]) for r in JAX_RESULTS}
    for (model, dtype), r in port.items():
        assert set(r) == ROW_KEYS and r["wall_sec"] > 0, (model, dtype)
        if dtype == "float32" and r["accuracy"] is not None:
            assert r["accuracy"] > 2.0 / 6.0, f"{model} f32 near chance: {r['accuracy']}"
        if r["avg_part_accuracy"] is not None:
            assert r["avg_part_accuracy"] > 0.5, r


@pytest.mark.parametrize("ref", [_band_case(r) for r in JAX_RESULTS])
def test_results_within_band_of_jax(ref):
    r = _port_results()[(ref["model"], ref["dtype"])]
    if ref["accuracy"] is not None:
        assert 0.0 <= r["accuracy"] <= 1.0
        if ref["dtype"] != "bfloat16":  # the native bf16 rows are reported, not banded
            assert abs(r["accuracy"] - ref["accuracy"]) <= ACC_BAND, (r, ref)
    else:
        assert r["accuracy"] is None
    if ref["seg_accuracy"] >= 0:
        assert abs(r["seg_accuracy"] - ref["seg_accuracy"]) <= SEG_BAND, (r, ref)
    else:
        assert r["seg_accuracy"] == -1.0
    if ref.get("avg_part_accuracy") is not None:
        assert abs(r["avg_part_accuracy"] - ref["avg_part_accuracy"]) <= SEG_BAND, (r, ref)
