"""PyTorch port, the command line (``train/cli.py``), the ``--visu`` dumps
and ``viz/``, on the CPU, against the JAX package.

Held equal to the JAX CLI:
  * each of the eight subcommands' parser actions (option strings, dest,
    default, type, choices, nargs, const, required) to a parser built with
    JAX's ``_add_common_flags`` and the two subcommand flags, plus
    ``--device``;
  * ``_make_trainer``'s config on every shared field, for several argv
    lists;
  * ``_load`` and ``_prepare`` on h5 files (cls, seg, partseg) and on a
    pickled listing of raw ``.bin`` clouds, resolved against the working
    directory (JAX's ``_prepare`` raises on the listing's object array: the
    port's prepares each cloud as JAX's list path does, and the test pins
    JAX's error);
  * ``_evaluate`` (cls, seg, partseg, with ``--visu``),
    ``_evaluate_cross_domain`` (both directions) and ``_draw_cmat`` fed one
    scripted results dict through a stubbed ``_restore_for_eval`` (both
    trainers' ``evaluate_auto`` stubbed alike, their arguments held equal): the logged lines, the bytes of
    ``pred_label.txt``, of the dumps and, with ``matplotlib`` hidden, of
    the text confusion matrix;
  * ``point_cloud_three_views`` and the PNG bytes of ``save_image``;
    ``dump_error_cases`` and ``dump_seg_masks``' file names and bytes.

The port on its own: one real CPU run of ``cli.main`` (``--device cpu``,
SSG at N=1024, B=4, 8 clouds) through ``train`` (2 epochs), ``train
--resume``, ``evaluate`` and ``draw_cmat`` leaves JAX
``tests/test_train_e2e.py:556-620``'s log-directory artifacts (the
confusion matrix as text, ``matplotlib`` hidden); BGA through
``train_seg`` (1 epoch) and ``evaluate_seg`` from an h5 file with masks,
and part segmentation through ``evaluate_partseg`` (fresh init) from an h5
file with parts; ``--device cuda`` on a machine without a card raises.
"""

import argparse
import json
import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from scanobjectnn_tpu import kernelconfig
from scanobjectnn_tpu.train import cli as jcli
from scanobjectnn_tpu.train import evaluate as jevaluate
from scanobjectnn_tpu.utils import logging as jlogging
from scanobjectnn_tpu.viz import render as jrender
from scanobjectnn_torch.data.synthetic import write_synthetic_h5
from scanobjectnn_torch.train import cli
from scanobjectnn_torch.train import evaluate
from scanobjectnn_torch.utils import logging as tlogging
from scanobjectnn_torch.viz import render

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _restore_kernelconfig(monkeypatch):
    """A JAX ``Trainer`` writes the process-global kernelconfig."""
    monkeypatch.setattr(kernelconfig, "_active", kernelconfig.active())


def _jax_parser(cmd: str) -> argparse.ArgumentParser:
    """JAX ``main``'s subparser for ``cmd`` (``cli.py:303-312``)."""
    p = argparse.ArgumentParser()
    jcli._add_common_flags(p)
    if cmd == "evaluate_cross_domain":
        p.add_argument("--direction", choices=["real_on_synthetic", "synthetic_on_real"], required=True)
    if cmd == "draw_cmat":
        p.add_argument("--output", default=None)
    return p


def _port_parser(cmd: str) -> argparse.ArgumentParser:
    sub = next(a for a in cli.build_parser()._actions if isinstance(a, argparse._SubParsersAction))
    return sub.choices[cmd]


def _actions(parser):
    return {
        tuple(a.option_strings): (a.dest, a.default, a.type, a.choices, a.nargs, a.const, a.required)
        for a in parser._actions if not isinstance(a, argparse._HelpAction)
    }


@pytest.mark.parametrize("cmd", cli.COMMANDS)
def test_parser_flags_are_jaxs_plus_device(cmd):
    want, got = _actions(_jax_parser(cmd)), _actions(_port_parser(cmd))
    assert got.pop(("--device",)) == ("device", "cuda", None, None, None, None, False)
    assert got == want


def test_help_lists_the_eight_commands():
    out = subprocess.run([sys.executable, "-m", "scanobjectnn_torch.train.cli", "--help"], cwd=REPO,
                         capture_output=True, text=True, check=True).stdout
    assert "{" + ",".join(cli.COMMANDS) + "}" in out
    assert len(cli.COMMANDS) == 8


ARGVS = [
    [],
    ["--model", "pointnet2_cls_bga", "--num_class", "2", "--seg_weight", "0.3", "--optimizer", "momentum",
     "--momentum", "0.8", "--no_augment", "--dtype", "bfloat16", "--pool_precision", "keys",
     "--fused_sa_eval", "off", "--sa_bucket", "off", "--ops_backend", "lax", "--seed", "3"],
    ["--model", "pointcnn_cls", "--no_recipe", "--max_epoch", "7", "--decay_step", "100", "--decay_rate", "0.5",
     "--learning_rate", "0.01", "--batch_size", "8", "--num_point", "2048", "--reg_weight", "0.01"],
    ["--model", "pointnet2_cls_msg", "--fused_sa_train", "--ops_backend", "pallas", "--log_dir", "elsewhere"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_make_trainer_config_matches_jax(argv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # both trainers' loggers make their log_dir
    jargs = _jax_parser("train").parse_args(argv)
    args = _port_parser("train").parse_args(argv + ["--device", "cpu"])
    jcfg = jcli._make_trainer(jargs, "cls").config
    cfg = cli._make_trainer(args, "cls").config
    shared = set(jcfg.__dict__) & set(cfg.__dict__)
    assert shared == set(cfg.__dict__) - {"device"}
    assert {k: getattr(cfg, k) for k in shared} == {k: getattr(jcfg, k) for k in shared}
    assert cfg.device == "cpu"


# ------------------------------------------------------------------ loaders


def _write_listing(root, rng, n_clouds=6):
    """Raw ``.bin`` clouds (11 floats a point, the semantic label last) in
    ``root`` and their pickled listing; two clouds below 128 points."""
    entries = []
    for i in range(n_clouds):
        n = (40, 150, 200, 90, 130, 170)[i % 6]
        rows = rng.randn(n, 11).astype(np.float32)
        rows[:, -1] = rng.choice([0.0, 1.0, 3.0, 5.0, -1.0], n, p=[0.1, 0.1, 0.5, 0.2, 0.1])
        name = f"scene{i:03d}_{i % 3}.bin"
        np.concatenate([np.float32([n]), rows.reshape(-1)]).tofile(os.path.join(root, name))
        entries.append({"filename": "objects_bin/" + name, "label": i % 3})
    path = os.path.join(root, "objects.pickle")
    with open(path, "wb") as f:
        pickle.dump(entries, f)
    return path


def _same(got, want):
    if isinstance(want, np.ndarray) and want.dtype == object:
        assert got.dtype == object and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("source", ["cls", "seg", "partseg", "bin", "bin_no_bg"])
def test_load_and_prepare_match_jax(source, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    if source.startswith("bin"):
        path = os.path.basename(_write_listing(str(tmp_path), np.random.RandomState(8)))
        mode, with_bg = "cls", source == "bin"
    else:
        path = "data.h5"
        write_synthetic_h5(path, num_per_class=2, num_classes=3, num_points=64, seed=2, with_mask=True,
                           with_parts=True)
        mode, with_bg = source, True
    num_point = 48 if source == "bin_no_bg" else 128  # the foreground is about half a cloud
    loaded = cli._load(path, with_bg, num_point, mode)
    want = jcli._load(path, with_bg, num_point, mode)
    for g, w in zip(loaded, want):
        _same(g, w)
    ragged = source.startswith("bin")
    if ragged:
        assert len({pc.shape for pc in want[0]}) == len(want[0]) >= 3
    for center, norm in ((True, True), (False, True), (True, False)):
        args = types.SimpleNamespace(center_data=center, norm=norm)
        if ragged:
            # JAX's _prepare raises on the object array its _load returns;
            # the port prepares each cloud as JAX's list path does.
            with pytest.raises(ValueError):  # AxisError (centre) or a broadcast error (norm)
                jcli._prepare(want[0], args)
            got = cli._prepare(loaded[0], args)
            assert got.dtype == object and got.shape == (len(want[0]),)
            for g, w in zip(got, jcli._prepare(list(want[0]), args)):
                _same(g, w)
        else:
            _same(cli._prepare(loaded[0], args), jcli._prepare(want[0], args))


# ------------------------------------------------------- evaluate-side output


def _scripted_results(data, labels, num_classes, masks=None, parts=None, keep_points=False, **_):
    """What an evaluation could return for these clouds: fixed predictions
    drawn from the sample count, the tallies of the JAX dict."""
    n = len(labels)
    rng = np.random.RandomState(n)
    labels = np.asarray(labels)
    preds = np.where(rng.rand(n) < 0.6, labels, rng.randint(0, num_classes, n))
    seen = np.bincount(labels, minlength=num_classes)
    hit = np.bincount(labels, weights=preds == labels, minlength=num_classes)
    with np.errstate(divide="ignore", invalid="ignore"):
        per_class = np.where(seen > 0, hit / np.maximum(seen, 1), np.nan)
    out = {"total_seen": n, "mean_loss": 0.75 + n / 1000, "accuracy": float((preds == labels).mean()),
           "avg_class_accuracy": float(np.nanmean(per_class)), "per_class_accuracy": per_class,
           "predictions": preds, "labels": labels}
    target = masks if masks is not None else parts
    if target is not None:
        target = np.asarray(target)
        seg = np.where(rng.rand(*target.shape) < 0.7, target, 1 - np.clip(target, 0, 1))
        out["seg_accuracy"] = float((seg == target).mean())
        if parts is not None:
            out["per_part_accuracy"] = np.array([0.5, 0.25, -1.0, 0.125])
            out["avg_part_accuracy"] = float(np.mean([0.5, 0.25, 0.125]))
        if keep_points:
            out["seg_predictions"] = seg
    if keep_points:
        out["points"] = np.asarray(data)
        if masks is not None:
            out["masks"] = np.asarray(masks)
    return out


def _stub_restore(module, logger_module, calls, num_classes):
    def evaluate_fn(state, data, labels, **kw):
        calls.append({k: v for k, v in kw.items() if k not in ("masks", "parts")}
                     | {"n": len(labels), "masks": kw.get("masks") is not None, "parts": kw.get("parts") is not None})
        return _scripted_results(data, labels, num_classes, **kw)

    def restore(args, mode):
        trainer = types.SimpleNamespace(logger=logger_module.Logger(args.log_dir))
        trainer.evaluate_auto = evaluate_fn
        return trainer, None

    return restore


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            full = os.path.join(dirpath, name)
            with open(full, "rb") as f:
                out[os.path.relpath(full, root)] = f.read()
    return out


EVALS = {
    "evaluate_visu": ("evaluate", ["--visu"]),
    "evaluate_seg_visu": ("evaluate_seg", ["--visu"]),
    "evaluate_partseg": ("evaluate_partseg", []),
    "real_on_synthetic": ("evaluate_cross_domain", ["--direction", "real_on_synthetic"]),
    "synthetic_on_real": ("evaluate_cross_domain", ["--direction", "synthetic_on_real"]),
    "draw_cmat": ("draw_cmat", ["--num_votes", "3"]),
}


@pytest.mark.parametrize("case", sorted(EVALS))
def test_evaluate_side_outputs_match_jax(case, tmp_path, monkeypatch):
    cmd, extra = EVALS[case]
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # the text confusion matrix
    num_classes = 15 if "cross" in cmd else 4
    write_synthetic_h5("test.h5", num_per_class=3, num_classes=num_classes, num_points=48, seed=4,
                       with_mask=True, with_parts=True)
    outputs, calls = {}, {}
    for side, module, logger_module in (("jax", jcli, jlogging), ("port", cli, tlogging)):
        calls[side] = []
        monkeypatch.setattr(module, "_restore_for_eval", _stub_restore(module, logger_module, calls[side],
                                                                        num_classes))
        argv = [cmd, "--test_file", "test.h5", "--num_class", str(num_classes), "--log_dir", f"log_{side}"] + extra
        parser = _jax_parser(cmd) if side == "jax" else _port_parser(cmd)
        args = parser.parse_args(argv[1:])
        args.command = cmd
        {"evaluate": lambda: module._evaluate(args, "cls"),
         "evaluate_seg": lambda: module._evaluate(args, "seg"),
         "evaluate_partseg": lambda: module._evaluate(args, "partseg"),
         "evaluate_cross_domain": lambda: module._evaluate_cross_domain(args),
         "draw_cmat": lambda: module._draw_cmat(args)}[cmd]()
        files = _files(f"log_{side}")
        text = files.pop("log_train.txt").decode()
        outputs[side] = (text.replace(f"log_{side}", "LOG").splitlines(), files)
    assert calls["port"] == calls["jax"]
    assert outputs["port"] == outputs["jax"]
    files = outputs["port"][1]
    if cmd in ("evaluate", "draw_cmat"):
        assert "pred_label.txt" in files
    if cmd == "draw_cmat":
        assert files["cmat.pdf.txt"].startswith(b"\tbag\tbin")
    if "visu" in case:
        assert any(k.startswith("dump" + os.sep) for k in files)


def test_three_views_and_png_bytes_match_jax(tmp_path):
    pts = np.random.RandomState(6).randn(40, 3).astype(np.float32)
    img, want = render.point_cloud_three_views(pts, canvas_size=96), jrender.point_cloud_three_views(pts, 96)
    np.testing.assert_array_equal(img, want)
    render.save_image(str(tmp_path / "a.png"), img)
    jrender.save_image(str(tmp_path / "b.png"), want)
    rgb = np.random.RandomState(7).rand(5, 6, 3)
    render.save_image_rgb(str(tmp_path / "c.png"), rgb)
    jrender.save_image_rgb(str(tmp_path / "d.png"), rgb)
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()
    assert (tmp_path / "c.png").read_bytes() == (tmp_path / "d.png").read_bytes()
    vol = render.point_cloud_to_volume(np.clip(pts, -1, 1), 8)
    np.testing.assert_array_equal(vol, jrender.point_cloud_to_volume(np.clip(pts, -1, 1), 8))
    np.testing.assert_array_equal(render.volume_to_point_cloud(vol), jrender.volume_to_point_cloud(vol))


def test_dumps_match_jax(tmp_path):
    rng = np.random.RandomState(9)
    points = rng.randn(5, 30, 3).astype(np.float32)
    labels, preds = np.array([0, 1, 2, 1, 0]), np.array([0, 2, 2, 0, 1])
    masks, seg = rng.randint(0, 2, (5, 30)), rng.randint(0, 2, (5, 30))
    names = ["bag", "bin", "box"]
    for side, module in (("port", evaluate), ("jax", jevaluate)):
        d = str(tmp_path / side)
        assert module.dump_error_cases(d, points, preds, labels, names, max_dumps=2) == 2
        assert module.dump_seg_masks(d, points, masks, seg, max_dumps=3) == 3
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    names = set(_files(tmp_path / "port"))
    assert {"0_gt_mask.ply", "2_pred_mask.ply", "0_label_bin_pred_box.png", "1_label_bin_pred_bag.ply"} <= names


# ------------------------------------------------------ the port on its own


def _records(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_trains_resumes_evaluates_and_draws_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # the text matrix: a PDF costs 3 s here
    write_synthetic_h5("cls.h5", num_per_class=2, num_classes=4, num_points=1024, seed=1)
    common = ["--device", "cpu", "--train_file", "cls.h5", "--test_file", "cls.h5", "--num_point", "1024",
              "--batch_size", "4", "--num_class", "4", "--log_dir", "log"]
    cli.main(["train", "--max_epoch", "2"] + common)
    records = _records("log")
    assert [r["epoch"] for r in records] == [0, 1]
    assert "train_mean_loss" in records[0] and "eval_accuracy" in records[0]
    assert records[1]["best_accuracy"] >= records[1]["eval_accuracy"] - 1e-9
    assert os.path.isdir("log/checkpoint_best") and os.path.isfile("log/checkpoint/state.pt")
    for name in ("trainer.py", "pointnet2.py"):
        assert os.path.isfile(os.path.join("log/src_snapshot", name))
    with open("log/best.json") as f:
        first_best = json.load(f)
    assert first_best["accuracy"] >= 0
    with open("log/last.json") as f:
        assert json.load(f) == {"step": 4, "epoch": 1}

    cli.main(["train", "--max_epoch", "3", "--resume"] + common)
    assert [r["epoch"] for r in _records("log")] == [0, 1, 2]
    with open("log/best.json") as f:
        assert json.load(f)["accuracy"] >= first_best["accuracy"]
    with open("log/last.json") as f:
        assert json.load(f) == {"step": 6, "epoch": 2}
    with open("log/log_train.txt") as f:
        log = f.read()
    assert log.count("epoch 00") == 3 and "resumed at epoch 2" in log

    cli.main(["evaluate", "--num_votes", "2"] + common)
    with open("log/pred_label.txt") as f:
        assert len(f.read().splitlines()) == 8
    cli.main(["draw_cmat"] + common)
    with open("log/cmat.pdf.txt") as f:
        assert len(f.read().splitlines()) == 5  # the header and a row a class


def test_cli_seg_and_partseg_commands_run_from_h5(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    write_synthetic_h5("seg.h5", num_per_class=2, num_classes=4, num_points=1024, seed=5, with_mask=True,
                       with_parts=True)
    common = ["--device", "cpu", "--train_file", "seg.h5", "--test_file", "seg.h5", "--num_point", "1024",
              "--batch_size", "4", "--num_class", "4"]
    cli.main(["train_seg", "--model", "pointnet2_cls_bga", "--max_epoch", "1", "--log_dir", "bga"] + common)
    record = _records("bga")[0]
    assert 0 <= record["eval_seg_accuracy"] <= 1 and "eval_accuracy" in record
    results = cli._evaluate(cli.build_parser().parse_args(
        ["evaluate_seg", "--model", "pointnet2_cls_bga", "--log_dir", "bga"] + common), "seg")
    assert results["total_seen"] == 8 and 0 <= results["seg_accuracy"] <= 1
    results = cli._evaluate(cli.build_parser().parse_args(
        ["evaluate_partseg", "--model", "pointnet2_cls_partseg", "--log_dir", "partseg"] + common), "partseg")
    assert results["per_part_accuracy"].shape == (4,) and "accuracy" not in results
    with open("partseg/log_train.txt") as f:
        assert "eval avg class acc" in f.read()


def test_device_cuda_without_a_card_raises(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where no CUDA device is present")
    monkeypatch.chdir(tmp_path)
    write_synthetic_h5("cls.h5", num_per_class=1, num_classes=2, num_points=64, seed=1)
    with pytest.raises((RuntimeError, AssertionError)):
        cli.main(["evaluate", "--test_file", "cls.h5", "--num_class", "2", "--log_dir", "log"])
