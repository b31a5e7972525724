"""The image models through the port's main path and flows on the CPU, and
their checkpoints across the two packages.

- Cross-package checkpoints (ResNet-18, width 8, synthetic CIFAR-10 at
  64 / 32 rows, batch 32): a JAX ``train_model`` run warm-starts the
  port's ``train_model`` and the port's run warm-starts the JAX one. At
  lr 0 the warm-started run's checkpoint holds the source's params bit
  for bit; its ``batch_stats`` do not (the warm start restores params
  only, ``flows/my_tpu_module.py:76-81``, a quirk both keep). The full
  tree (``load_checkpoint_tree``) restores params and ``batch_stats``
  exactly. On each checkpoint ``TorchPredictor`` and the JAX
  ``TpuPredictor`` give the same argmax on every test row and logits
  within 1e-4 of the largest |logit| (f32; convolutions summed in
  another order).
- A checkpoint without ``batch_stats`` fails loudly in the port's
  predictor for a BatchNorm model.
- The flows: ``TorchTrain --model resnet18 --dataset cifar10`` (2 epochs
  at 64 / 32 rows), a ``--from-run`` warm start, and the triggered
  ``TorchEval``, which rebuilds the producing run's model on its
  dataset; its count equals the JAX ``TpuPredictor``'s on the same
  checkpoint and rows. ViT through ``train_model`` with the flash
  attention (the plain versions on the CPU) saves no ``batch_stats``.

The JAX side sizes its synthetic sets from its declared knobs.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "flows"))

import my_tpu_module as jmod  # noqa: E402
from tpuflow.ckpt import Checkpoint as JCheckpoint  # noqa: E402
from tpuflow.ckpt import restore_from_handle as j_restore  # noqa: E402
from tpuflow_torch.ckpt import Checkpoint, restore_from_handle  # noqa: E402
from tpuflow_torch.ckpt.tree import (  # noqa: E402
    checkpoint_tree,
    load_checkpoint_tree,
)
from tpuflow_torch.flow import Run, store  # noqa: E402
from tpuflow_torch.flows import eval_flow, train_flow  # noqa: E402
from tpuflow_torch.flows import my_torch_module as tmod  # noqa: E402
from tpuflow_torch.models.convert import resnet_params_to_jax  # noqa: E402
from tpuflow_torch.train.step import create_train_state  # noqa: E402

N_TRAIN, N_TEST = 64, 32
SMALL = {"width": 8}


@pytest.fixture
def sized(monkeypatch, tmp_path):
    monkeypatch.setenv("TPUFLOW_SYNTH_TRAIN_N", str(N_TRAIN))
    monkeypatch.setenv("TPUFLOW_SYNTH_TEST_N", str(N_TEST))
    monkeypatch.setenv("TPUFLOW_DATA_DIR", str(tmp_path / "data"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield tmp_path
    torch.set_num_threads(n)


def _jax_run(path, **kw):
    return jmod.train_model(
        model="resnet18", model_kwargs=SMALL, dataset="cifar10",
        global_batch_size=32, epochs=1, checkpoint_storage_path=str(path),
        **kw)


def _port_run(path, **kw):
    return tmod.train_model(
        device="cpu", model="resnet18", model_kwargs=SMALL,
        dataset="cifar10", n_train=N_TRAIN, n_test=N_TEST,
        global_batch_size=32, epochs=1, checkpoint_storage_path=str(path),
        **kw)


def _np(tree):
    return jax.tree_util.tree_map(
        lambda t: t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t),
        tree, is_leaf=lambda t: isinstance(t, torch.Tensor))


def _assert_equal_trees(a, b):
    fa = jax.tree_util.tree_flatten_with_path(_np(a))[0]
    fb = dict(jax.tree_util.tree_flatten_with_path(_np(b))[0])
    assert len(fa) == len(fb) > 0
    for path, x in fa:
        np.testing.assert_array_equal(x, fb[path], err_msg=str(path))


def _port_tree(handle):
    return restore_from_handle(Checkpoint.from_json(handle.to_json()))


def _jax_tree(handle):
    return j_restore(JCheckpoint.from_json(handle.to_json()))


def _same_predictions(handle):
    rows = tmod.get_dataloaders(32, dataset="cifar10", as_rows=True,
                                n_train=0, n_test=N_TEST)
    port = tmod.TorchPredictor(
        handle.to_json(), device="cpu",
        model=tmod.build_model("resnet18", dataset="cifar10",
                               num_classes=10, **SMALL))
    jax_p = jmod.TpuPredictor(
        handle.to_json(), sample_shape=(32, 32, 3),
        model=jmod.build_model("resnet18", dataset="cifar10",
                               num_classes=10, **SMALL))
    got = tmod.map_batches(rows, port, batch_size=32)
    want = jmod.map_batches(rows, jax_p, batch_size=32)
    assert len(got) == len(want) == N_TEST
    g = np.stack([o["logits"] for o in got])
    w = np.stack([o["logits"] for o in want])
    np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max())


def test_jax_resnet_checkpoint_warm_starts_the_port(sized):
    src = _jax_run(sized / "jax", lr=0.05)
    _same_predictions(src.checkpoint)
    warm = _port_run(sized / "port", lr=0.0, checkpoint=src.checkpoint
                     .to_json())
    got, want = _port_tree(warm.checkpoint), _jax_tree(src.checkpoint)
    _assert_equal_trees(got["params"], want["params"])
    with pytest.raises(AssertionError):  # params only: the stats restart
        _assert_equal_trees(got["batch_stats"], want["batch_stats"])
    # The full tree carries the statistics too.
    state = create_train_state(tmod.build_model(
        "resnet18", dataset="cifar10", **SMALL), 0.05)
    load_checkpoint_tree(state, restore_from_handle(
        Checkpoint.from_json(src.checkpoint.to_json()),
        abstract_state=checkpoint_tree(state, abstract=True)))
    params, stats = resnet_params_to_jax(state.model.state_dict())
    _assert_equal_trees(params, want["params"])
    _assert_equal_trees(stats, want["batch_stats"])


def test_port_resnet_checkpoint_warm_starts_jax(sized):
    src = _port_run(sized / "port", lr=0.05)
    tree = _port_tree(src.checkpoint)
    assert sorted(tree) == ["batch_stats", "opt_state", "params", "step"]
    _same_predictions(src.checkpoint)
    warm = _jax_run(sized / "jax", lr=0.0, checkpoint=src.checkpoint
                    .to_json())
    _assert_equal_trees(_jax_tree(warm.checkpoint)["params"], tree["params"])


def test_predictor_refuses_a_checkpoint_without_batch_stats(sized):
    from tpuflow_torch.ckpt import CheckpointManager

    state = create_train_state(tmod.build_model(
        "resnet18", dataset="cifar10", **SMALL), 0.05)
    tree = checkpoint_tree(state)
    del tree["batch_stats"]
    mgr = CheckpointManager(str(sized / "nostats"), async_save=False)
    mgr.save(1, tree)
    handle = Checkpoint.from_directory(str(sized / "nostats" / "step_1"))
    with pytest.raises(KeyError, match="no batch_stats subtree"):
        tmod.TorchPredictor(handle, device="cpu", model=tmod.build_model(
            "resnet18", dataset="cifar10", **SMALL))


def test_resnet_flows_and_eval_match_jax(sized, monkeypatch):
    home = store.set_home(str(sized / "home"))
    try:
        common = ["--device", "cpu", "--home", home, "--batch-size", "32",
                  "--n-train", str(N_TRAIN), "--n-test", str(N_TEST)]
        model = ["--model", "resnet18", "--dataset", "cifar10"]
        p1 = train_flow.main(["run", "--epochs", "2", *model, *common])
        r1 = Run(p1)
        assert r1.data.model_used == "resnet18"
        assert r1.data.dataset_used == "cifar10"
        p2 = train_flow.main(["run", "--epochs", "1", "--from-run", p1,
                              *model, *common])
        assert Run(p2).data.warm_started
        e = Run(eval_flow.main(["run", "--triggered", "--batch-size", "32",
                                "--device", "cpu", "--home", home]))
        assert e.meta["triggered_by"] == p2 and e.data.n_rows == N_TEST
        assert e.data.dataset_used == "cifar10"
        ckpt = Run(p2).data.result.best_checkpoint
        rows = tmod.get_dataloaders(32, dataset="cifar10", as_rows=True,
                                    n_train=0, n_test=N_TEST)
        jax_p = jmod.TpuPredictor(
            ckpt.to_json(), sample_shape=(32, 32, 3),
            model=jmod.build_model("resnet18", dataset="cifar10",
                                   num_classes=10))
        mis = sum(int(o["predicted_values"]) != r["labels"] for o, r in zip(
            jmod.map_batches(rows, jax_p, batch_size=32), rows))
        assert e.data.n_misclassified == mis
    finally:
        store.set_home(None)


def test_vit_on_flash_through_train_model(sized):
    res = tmod.train_model(
        device="cpu", model="vit", dataset="cifar10", n_train=N_TRAIN,
        n_test=N_TEST, global_batch_size=32, epochs=1,
        model_kwargs={"n_layer": 2, "n_embd": 32, "n_head": 2,
                      "attn_impl": "flash"},
        checkpoint_storage_path=str(sized / "vit"))
    assert np.isfinite(res.metrics["val_loss"])
    tree = _port_tree(res.checkpoint)
    assert sorted(tree) == ["opt_state", "params", "step"]
    assert tree["params"]["pos_embed"].shape == (1, 65, 32)
