"""The rank side of ``tests/test_torch_resident.py``'s two-rank test: what
each spawned rank runs, and the one process runs to compare.  A module of
its own, without JAX, so that a spawned rank imports little."""

import contextlib
from unittest import mock

import torch

from scanobjectnn_torch import convert
from scanobjectnn_torch.parallel import mesh as mesh_lib
from scanobjectnn_torch.train import trainer as trainer_lib
from scanobjectnn_torch.train.trainer import Trainer, TrainerConfig
from tests.test_torch_parallel import WORLD


def run_epochs(spec: dict, mesh=None, own_tag: bool = False) -> dict:
    """``spec["epochs"]`` resident epochs of ``spec["config"]`` from
    ``spec["variables"]``, dropout the identity; with ``own_tag``, drawn
    with an epoch seed of this rank's (the planted fault)."""
    trainer = Trainer(TrainerConfig(**spec["config"], device="cpu"), mesh=mesh)
    state = trainer.init_state()
    convert.load_jax_variables(state.model, spec["variables"])
    for module in state.model.modules():
        if hasattr(module, "dropout_keep"):
            module.dropout_keep = 1.0
    device_data = trainer.upload_dataset(spec["data"])
    summaries = []
    fault = mock.patch.object(trainer_lib, "EPOCH_TAG", trainer_lib.EPOCH_TAG + 1)
    with fault if own_tag else contextlib.nullcontext():
        for _ in range(spec["epochs"]):
            state, summary = trainer.train_epoch_device(state, device_data)
            summaries.append(summary)
    return {"summaries": summaries, "state": {k: v.clone() for k, v in state.model.state_dict().items()}}


def run_evaluation(spec: dict, mesh=None) -> dict:
    """``evaluate_device`` (shuffled, seed 0, 2 votes) of
    ``spec["eval_config"]``'s init on ``spec["eval_data"]``."""
    trainer = Trainer(TrainerConfig(**spec["eval_config"], device="cpu"), mesh=mesh)
    return trainer.evaluate_device(trainer.init_state(), trainer.upload_dataset(spec["eval_data"]), num_votes=2)


def rank_job(rank: int, init_file: str, spec_path: str, out_path: str) -> None:
    """One rank: the epochs, the faulted epochs and the evaluation."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=WORLD)
    try:
        mesh = mesh_lib.make_mesh("cpu")
        out = {"epochs": run_epochs(spec, mesh), "fault": run_epochs(spec, mesh, own_tag=rank == 1),
               "eval": run_evaluation(spec, mesh)}
    finally:
        dist.destroy_process_group()
    torch.save(out, out_path)
