"""Data parallelism in the port (tpuflow_torch.dist) over gloo: two
processes on the CPU, as tests/test_dist.py runs the JAX package's data
axis on virtual CPU devices.

- The averaged gradients (one all-reduce over a flat bucket, divided by
  the world) equal one process's gradients on the concatenated batch,
  within 1e-6 of the largest |gradient| (f32: two half-batch means
  averaged against one full-batch mean).
- One ``train_model`` epoch at ``num_workers=2`` ends with the same
  parameters on both ranks, bit for bit, and within atol 2e-6 of the
  one-process run over the same global batches (dropout off; 8 SGD steps
  whose gradients differ in the summation order only).
- BatchNorm statistics are global over the data axis, the twin of
  ``tests/test_train_step.py::test_batchnorm_stats_are_global``: two SGD
  steps of a ResNet-18 (width 4, CIFAR stem) over a 16-row batch split
  8 + 8 leave both ranks with the same running statistics and
  parameters, bit for bit, within atol 1e-6 of one process stepping on
  the whole batch (the same sums reduced in another order).

The workers are spawned processes that import torch and the port only.
The same epoch over NCCL, one process per card, runs where the machine
has two cards or more (marked ``cuda``; it skips here).
"""

import multiprocessing as mp
import queue
import socket

import numpy as np
import pytest
import torch

from tpuflow_torch import dist
from tpuflow_torch.flows import my_torch_module as tmod
from tpuflow_torch.models import NeuralNetwork
from tpuflow_torch.models.losses import cross_entropy_loss
from tpuflow_torch.train import trainer

WORLD = 2
TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _batch(n=32, seed=0):
    r = np.random.default_rng(seed)
    return (torch.from_numpy(r.standard_normal((n, 28, 28))
                             .astype(np.float32)),
            torch.from_numpy(r.integers(0, 10, n)))


def _grads(model, x, y):
    model.zero_grad()
    cross_entropy_loss(model(x), y).backward()
    return [p.grad.clone() for p in model.parameters()]


def _capture_params(into: dict):
    """Record the params of every state ``report`` saves (the last one
    wins), on this process."""
    original = trainer.TrainContext.report

    def report(self, metrics, *, state=None, **kw):
        into["params"] = [t.detach().clone() for _, t in
                          sorted(_flat(state["params"]).items())]
        into["metrics"] = dict(metrics)
        return original(self, metrics, state=state, **kw)

    trainer.TrainContext.report = report


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _train_kwargs(device="cpu"):
    return dict(device=device, epochs=1, global_batch_size=32, lr=0.05,
                n_train=256, n_test=64,
                model_kwargs={"dropout_rate": 0.0})


def _worker(rank, port, what, out, device="cpu"):
    torch.set_num_threads(1)
    try:
        dist.initialize(device, rank=rank, world_size=WORLD,
                        init_method=f"tcp://localhost:{port}", timeout_s=60)
        if what == "bn":
            out.put((rank, *_resnet_steps(dist.make_mesh(device), rank,
                                          WORLD)))
        elif what == "grads":
            mesh = dist.make_mesh("cpu")
            x, y = _batch()
            half = len(x) // WORLD
            model = NeuralNetwork(dropout_rate=0.0, seed=0)
            grads = _grads(model, x[rank * half:(rank + 1) * half],
                           y[rank * half:(rank + 1) * half])
            avg = dist.average_gradients(grads, mesh)
            out.put((rank, [g.numpy() for g in avg]))
        else:
            seen = {}
            _capture_params(seen)
            res = tmod.train_model(num_workers=WORLD, **_train_kwargs(device))
            out.put((rank, [p.cpu().numpy() for p in seen["params"]],
                     res.metrics, res.mesh_axes))
        dist.barrier(dist.make_mesh(device))
    except BaseException as e:  # reported to the parent
        out.put((rank, repr(e)))
        raise
    finally:
        dist.shutdown()


def _resnet_steps(mesh, rank=0, world=1):
    """Two SGD steps of a small ResNet-18 on this process's rows of a
    16-row CIFAR-shaped batch: (running statistics, parameters) as numpy,
    in the module's order."""
    from tpuflow_torch.ckpt.tree import running_stats
    from tpuflow_torch.device import f32_matmul_precision
    from tpuflow_torch.models import get_model
    from tpuflow_torch.train.step import create_train_state, make_train_step

    model = get_model("resnet18", width=4, small_inputs=True, seed=0)
    state = create_train_state(model.to(mesh.device), 0.05)
    step = make_train_step(mesh=mesh)
    r = np.random.default_rng(0)
    rows = slice(rank * 16 // world, (rank + 1) * 16 // world)
    # No TF32 convolutions on the card.
    with f32_matmul_precision(mesh.device.type == "cuda"):
        for _ in range(2):
            x = r.standard_normal((16, 32, 32, 3)).astype(np.float32)
            y = r.integers(0, 10, 16)
            step(state, {"x": x[rows], "y": y[rows]}, 0)
    return ([t.cpu().numpy() for t in running_stats(model).values()],
            [p.detach().cpu().numpy() for p in model.parameters()])


def _spawn(what, device="cpu"):
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, what, out, device))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(WORLD):
            item = out.get(timeout=TIMEOUT_S)
            assert not isinstance(item[1], str), item
            results[item[0]] = item[1:]
    except queue.Empty:
        pytest.fail(f"no result from the workers within {TIMEOUT_S} s")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs)
    return results


def test_averaged_gradients_equal_the_full_batch_gradients():
    results = _spawn("grads")
    x, y = _batch()
    want = _grads(NeuralNetwork(dropout_rate=0.0, seed=0), x, y)
    for rank in range(WORLD):
        for g, w in zip(results[rank][0], want):
            scale = float(w.abs().max())
            np.testing.assert_allclose(g, w.numpy(), rtol=0,
                                       atol=1e-6 * scale)


def _bn_global(device, atol=1e-6):
    results = _spawn("bn", device)
    for a, b in zip(results[0][0] + results[0][1],
                    results[1][0] + results[1][1]):
        np.testing.assert_array_equal(a, b)
    torch.set_num_threads(1)
    stats, params = _resnet_steps(dist.make_mesh(device), world=1)
    assert len(stats) == 2 * 20  # mean and var of 20 BatchNorms
    for a, b in zip(results[0][0] + results[0][1], stats + params):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def test_batchnorm_statistics_are_global_over_two_processes():
    _bn_global("cpu")


def test_one_process_world_leaves_gradients_untouched():
    mesh = dist.make_mesh("cpu")
    assert mesh.shape == {"data": 1} and mesh.device_mesh is None
    g = [torch.ones(3)]
    assert dist.average_gradients(g, mesh) is g
    assert dist.process_count() == 1 and dist.process_index() == 0


def _two_against_one(monkeypatch, device):
    results = _spawn("train", device)
    p0, p1 = results[0][0], results[1][0]
    for a, b in zip(p0, p1):
        np.testing.assert_array_equal(a, b)
    assert results[0][1] == results[1][1]
    assert results[0][2] == {"data": WORLD}
    seen = {}
    monkeypatch.setattr(trainer.TrainContext, "report",
                        trainer.TrainContext.report)
    _capture_params(seen)
    torch.set_num_threads(1)
    one = tmod.train_model(num_workers=1, **_train_kwargs(device))
    for a, b in zip(p0, seen["params"]):
        np.testing.assert_allclose(a, b.cpu().numpy(), rtol=0, atol=2e-6)
    np.testing.assert_allclose(results[0][1]["val_loss"],
                               one.metrics["val_loss"], rtol=1e-5)


def test_two_process_epoch_matches_one_process(monkeypatch):
    _two_against_one(monkeypatch, "cpu")


@pytest.mark.cuda
def test_two_process_epoch_over_nccl(monkeypatch):
    """The same epoch with one process per card over NCCL (TF32 off on
    both sides)."""
    if torch.cuda.device_count() < WORLD:
        pytest.skip(f"needs {WORLD} CUDA devices: one process per card")
    from tpuflow_torch.device import f32_matmul_precision

    with f32_matmul_precision():
        _two_against_one(monkeypatch, "cuda")
