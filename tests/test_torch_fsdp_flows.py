"""The GPT-2 flows of the port on the FSDP path (CPU, gloo): the JAX
flow runs its ``data`` x ``fsdp`` mesh in one process; the port's
``TorchGptTrain`` runs its train step as a gang of ``data_axis`` x
``fsdp_axis`` processes, so its defaults (2 x 2) take four.

The gang's run checkpoints as four processes (manifest fragments merged
into one step), a ``--from-run`` resume restores that state into one
process (1 x 1) and trains on, and ``TorchGptEval`` restores the result
at one process. Members are ``python -m tpuflow_torch.flow.gang_exec``
processes that import torch and the port only.
"""

import json
import os

import numpy as np
import pytest

from torch_parity import one_torch_thread  # noqa: F401
from tpuflow_torch.flow import Run, store
from tpuflow_torch.flows import gpt_eval_flow, gpt_flow


@pytest.fixture()
def home(tmp_path):
    path = store.set_home(str(tmp_path / "home"))
    yield path
    store.set_home(None)


def test_default_mesh_gang_then_one_process_resume_and_eval(home):
    """``TorchGptTrain`` at its default data 2 x fsdp 2: four members, the
    head's artifacts (finite losses, a 4-process checkpoint whose leaves
    are sharded); ``--from-run`` at 1 x 1 restores it and continues from
    its step; ``TorchGptEval`` on the result scores a finite test loss."""
    port = ["--device", "cpu", "--home", home]
    small = ["--preset", "test", "--epochs", "1", "--steps-per-epoch", "2",
             "--seq-len", "32"]
    first = Run(gpt_flow.main(["run", *small, "--dist-backend", "gloo",
                               *port]))
    tdir = os.path.join(home, "flows", first.pathspec, "train", "1")
    assert sorted(n for n in os.listdir(tdir) if n.startswith("joined_")) \
        == [f"joined_{i}" for i in range(4)]
    ckpt = first.data.result_checkpoint
    assert ckpt.metadata["process_count"] == 4
    assert np.isfinite(first.data.loss_history).all()
    with open(os.path.join(ckpt.path, "state", "manifest.json")) as f:
        manifest = json.load(f)
    assert any(len(e["shards"]) == 4 for e in manifest["leaves"])
    assert any(n.startswith("manifest.p00003")
               for n in os.listdir(os.path.join(ckpt.path, "state")))

    second = Run(gpt_flow.main([
        "run", *small, "--epochs", "2", "--data-axis", "1", "--fsdp-axis",
        "1", "--from-run", first.pathspec, *port]))
    assert second.data.result_checkpoint.metadata["process_count"] == 1
    assert second.data.result_checkpoint.metadata["step"] == 2 + 4
    assert np.isfinite(second.data.loss_history).all()

    ev = Run(gpt_eval_flow.main(["run", "--checkpoint-run-pathspec",
                                 second.pathspec, "--sample-tokens", "4",
                                 *port]))
    assert np.isfinite(ev.data.test_loss)
