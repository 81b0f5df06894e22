"""PyTorch port, the command line on two gloo ranks on the CPU:
``python -m torch.distributed.run --standalone --nproc_per_node 2 -m
scanobjectnn_torch.train.cli train --device cpu ...`` for one tiny epoch
(SSG, 4 clouds at a global batch of 4: one step, N=128, the momentum
optimizer), then ``evaluate`` the same way, against the same commands in
one process.

Held: the run exits 0 within ``RUN_TIMEOUT``; rank 0 alone writes
(``log_train.txt`` names ``devices=2`` once, ``metrics.jsonl`` holds one
record); the checkpoint's parameters and BN statistics equal the one
process's within ``tests/test_multichip.py``'s bounds (rtol 1e-3, atol
1e-5: a momentum step, whose update is linear in the gradient); the train
loss within rtol 1e-5; ``pred_label.txt`` of ``evaluate`` byte-equal.  One
step: BatchNorms over 2 and 4 clouds in f32 leave the first step's
gradients about 1e-3 of their scale apart, and a second step amplifies
that through the head's BNs (read on 8 clouds: the second step's losses
9e-4 relative apart, a kernel 2.6e-3); ``tests/test_torch_parallel.py``
holds whole steps with float64 BNs.
Without ``WORLD_SIZE`` the command line joins no group (``cli._mesh``).
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from scanobjectnn_torch.data.synthetic import write_synthetic_h5
from scanobjectnn_torch.train import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TIMEOUT = 180  # seconds for one two-rank command
COMMON = ["--device", "cpu", "--train_file", "cls.h5", "--test_file", "cls.h5", "--num_point", "128",
          "--batch_size", "4", "--num_class", "4", "--optimizer", "momentum", "--seed", "1"]


def _two_ranks(args, cwd):
    """The command on two ranks; the launcher and its workers in a session
    of their own, killed together past ``RUN_TIMEOUT``."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
           "-m", "scanobjectnn_torch.train.cli", *args]
    proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        _, err = proc.communicate(timeout=RUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"{' '.join(args[:1])} on two ranks still running after {RUN_TIMEOUT} s: killed")
    assert proc.returncode == 0, err[-4000:]


def _records(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_train_and_evaluate_on_two_ranks_equal_one_process(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    write_synthetic_h5("cls.h5", num_per_class=1, num_classes=4, num_points=256, seed=1)
    _two_ranks(["train", "--max_epoch", "1", "--log_dir", "two"] + COMMON, tmp_path)
    _two_ranks(["evaluate", "--num_votes", "2", "--log_dir", "two"] + COMMON, tmp_path)
    cli.main(["train", "--max_epoch", "1", "--log_dir", "one"] + COMMON)
    cli.main(["evaluate", "--num_votes", "2", "--log_dir", "one"] + COMMON)

    with open("two/log_train.txt") as f:
        log = f.read()
    assert log.count("devices=2") == 1 and log.count("epoch 000") == 1, log
    two, one = _records("two"), _records("one")
    assert [r["epoch"] for r in two] == [0]
    np.testing.assert_allclose(two[0]["train_mean_loss"], one[0]["train_mean_loss"], rtol=1e-5)
    assert two[0]["train_accuracy"] == one[0]["train_accuracy"]
    got = torch.load("two/checkpoint/state.pt", weights_only=True)
    want = torch.load("one/checkpoint/state.pt", weights_only=True)
    assert got["step"] == want["step"] == 1
    for key, value in want["model"].items():
        np.testing.assert_allclose(got["model"][key].numpy(), value.numpy(), rtol=1e-3, atol=1e-5, err_msg=key)
    with open("two/pred_label.txt", "rb") as f, open("one/pred_label.txt", "rb") as g:
        assert f.read() == g.read()


def test_cli_joins_no_group_without_world_size(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    args = cli.build_parser().parse_args(["train", "--device", "cpu"])
    assert cli._mesh(args) is None
    assert not torch.distributed.is_initialized()


def test_cli_refuses_cuda_ranks_without_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where no CUDA device is present")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cli._mesh(cli.build_parser().parse_args(["train", "--device", "cuda"]))
    assert not torch.distributed.is_initialized()
