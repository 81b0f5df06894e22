"""PyTorch port, the Table-5 harness (``scanobjectnn_torch/train/table5.py``)
against the JAX package's ``scripts/reproduce_table5.py`` (loaded by path),
on the CPU.

Held equal: ``ROWS``; the flags (``--cpu`` is ``--device`` in the port);
the dry-run h5 tree, array for array; and the markdown each harness writes
with every row's ``run_row`` stubbed alike, with and without
``--dry_run``.  The port on its own: ``--dry_run --device cpu`` of one row
end to end (``load_row``, then ``train_and_evaluate``: ``fit``, the best
checkpoint restored, ``evaluate_auto``).
"""

import contextlib
import importlib.util
import io
import os
import tempfile

import h5py
import numpy as np
import pytest

from scanobjectnn_torch.train import table5

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_harness():
    spec = importlib.util.spec_from_file_location("reproduce_table5", os.path.join(REPO, "scripts",
                                                                                   "reproduce_table5.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_rows_equal_jaxs(jax_harness):
    assert table5.ROWS == jax_harness.ROWS


def _options(main) -> set:
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        main(["--help"])
    return {word.rstrip(",") for word in out.getvalue().split() if word.startswith("--")}


def test_flags_are_jaxs_with_device_for_cpu(jax_harness):
    assert _options(table5.main) == _options(jax_harness.main) - {"--cpu"} | {"--device"}
    args = table5.build_parser().parse_args([])
    assert (args.device, args.votes, args.num_point, args.log_root) == ("cuda", 12, 1024, "log/table5")


def _h5_tree(root) -> dict:
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            with h5py.File(os.path.join(dirpath, name), "r") as f:
                for key in f:
                    out[(os.path.relpath(os.path.join(dirpath, name), root), key)] = np.asarray(f[key])
    return out


def test_dry_tree_equals_jaxs(jax_harness, tmp_path):
    got = _h5_tree(table5.make_dry_tree(str(tmp_path / "port")))
    want = _h5_tree(jax_harness.make_dry_tree(str(tmp_path / "jax")))
    assert got.keys() == want.keys() and len(got) == 6  # two files of data, label and mask
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=str(key))


@pytest.mark.parametrize("dry_run", [False, True], ids=["real", "dry_run"])
def test_markdown_equals_jaxs_on_stubbed_rows(jax_harness, tmp_path, monkeypatch, dry_run):
    def stub(model, kind, h5_dir, args):
        n = len(model) + len(kind)
        return {"accuracy": n / 40.0, "avg_class_accuracy": n / 41.0, "seg_accuracy": 0.5 if kind == "seg" else None,
                "wall_sec": float(n)}

    tables = {}
    for side, module in (("port", table5), ("jax", jax_harness)):
        monkeypatch.setattr(module, "run_row", stub)
        monkeypatch.setattr(tempfile, "mkdtemp", lambda prefix="", _side=side: str(tmp_path / f"dry_{_side}"))
        out = str(tmp_path / f"{side}.md")
        argv = ["--output", out, "--models", "pointnet_cls,dgcnn_bga,3dmfv_net_cls"]
        argv += ["--dry_run"] if dry_run else ["--h5_dir", str(tmp_path)]
        module.main(argv)
        with open(out) as f:
            tables[side] = f.read()
    assert tables["port"] == tables["jax"]
    assert tables["port"].count("\n| ") == 4 and ("DRY RUN" in tables["port"]) == dry_run


def test_dry_run_of_one_row_end_to_end(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tempfile, "mkdtemp", lambda prefix="": str(tmp_path / "dry"))
    out = str(tmp_path / "table5.md")
    table5.main(["--dry_run", "--device", "cpu", "--models", "pointnet_cls", "--output", out])
    with open(out) as f:
        lines = f.read().splitlines()
    assert lines[0].endswith("DRY RUN (synthetic data; accuracies meaningless)")
    assert len(lines) == 5 and lines[4].startswith("| pointnet_cls | 68.2 | ")
    log = tmp_path / "dry" / "log" / "pointnet_cls"
    assert (log / "checkpoint_best" / "state.pt").is_file() and (log / "metrics.jsonl").is_file()
    assert "ops_backend=auto device=cpu" in capsys.readouterr().err
