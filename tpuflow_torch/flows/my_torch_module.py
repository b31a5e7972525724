"""The README main path: image-classifier training and batch prediction.

Twin of ``flows/my_tpu_module.py`` on PyTorch and the port:

- ``train_fashion_mnist`` / ``train_model`` (``:357``/``:290``): the
  trainer entry points (per-worker batch = global // workers,
  ``num_to_keep=2``) over the model zoo (``mlp``, ``resnet18``,
  ``resnet50``, ``vit``, ``vit_tiny``, ``vit_small``) and the image
  datasets (``fashion_mnist``, ``mnist``, ``cifar10``,
  ``imagenet_synth``);
- ``train_func_per_worker`` (``:113-287``): the per-process epoch loop;
  an in-run resume from the run's newest retained step comes before any
  warm start; a warm start is weights only (the reference's quirk; the
  SGD trace stays zero and a ResNet's BatchNorm statistics start afresh,
  as ``:76-81`` restores params only) unless ``resume="full"``; the
  in-run resume and ``resume="full"`` restore ``batch_stats`` too; the
  loader reshuffles
  per epoch only when the world has more than one worker, as the
  reference does; each epoch ends in ``report(..., step=epoch + 1,
  data_state=...)``;
- ``set_weights_from_checkpoint`` (``:76``), ``build_model`` (``:84``):
  a ResNet takes the CIFAR stem (``small_inputs``) unless the dataset is
  ``imagenet_synth``; the image models' input channels (and a ViT's
  image size) come from the dataset's registry entry;
- ``TorchPredictor`` (twin of ``TpuPredictor``, ``:363``), with
  ``zero_copy`` for the checkpoint of a finished run.
- The checkpoint machinery as the reference wires it (``:140-158``,
  ``:220``): the resume source is resolved first and its restore's
  buffers backed (page-locked on the card, handed back once the state
  is there) while the model is built, and the manager's pool is
  prewarmed once the state exists.

Every run is on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import time

from tpuflow_torch import dist
from tpuflow_torch.ckpt import (
    Checkpoint,
    prewarm_restore_handle,
    prewarm_restore_wait,
    release_pinned,
    restore_from_handle,
)
from tpuflow_torch.ckpt.tree import (
    checkpoint_tree,
    load_checkpoint_tree,
    load_params,
    running_stats,
)
from tpuflow_torch.data.datasets import dataset_info, get_labels_map
from tpuflow_torch.device import resolve_device
from tpuflow_torch.data.loader import get_dataloaders, prefetch_to_device
from tpuflow_torch.infer.engine import BatchPredictor, map_batches
from tpuflow_torch.models import NeuralNetwork, get_model
from tpuflow_torch.train.step import (
    DispatchWindow,
    create_train_state,
    make_eval_step,
    make_train_step,
    per_worker_batch_size,
)
from tpuflow_torch.train.trainer import (
    CheckpointConfig,
    Result,
    RunConfig,
    ScalingConfig,
    Trainer,
    get_context,
)

_TAG = "[my_torch_module]"
# Steps in flight before the host waits for the oldest one's loss (the
# JAX package's default dispatch depth).
_DISPATCH_DEPTH = 2


def _log(msg: str) -> None:
    print(f"{_TAG} {msg}")


def set_weights_from_checkpoint(state, checkpoint: Checkpoint):
    """Warm-start only the model weights from a checkpoint handle; the
    optimizer state stays as it is."""
    load_params(state.model, restore_from_handle(checkpoint,
                                                 weights_only=True))
    return state


def build_model(name: str = "mlp", *, dataset: str = "fashion_mnist",
                num_classes: int | None = None, **model_kwargs):
    """The model a run of ``train_model`` trains on ``dataset`` (for
    consumers outside the worker loop, such as an eval that rebuilds the
    producing run's model)."""
    return _build_model({"model": name, "dataset": dataset,
                         "num_classes": num_classes,
                         "model_kwargs": model_kwargs or None})


def _build_model(config: dict):
    kwargs = dict(config.get("model_kwargs") or {})
    kwargs.setdefault("num_classes", config.get("num_classes") or 10)
    kwargs.setdefault("seed", config.get("seed", 0))
    name = config.get("model", "mlp")
    dataset = config.get("dataset", "fashion_mnist")
    shape = dataset_info(dataset)["shape"]
    if name in ("resnet18", "resnet50"):
        # CIFAR-sized inputs use the 3x3 stem unless told otherwise.
        kwargs.setdefault("small_inputs", dataset != "imagenet_synth")
        kwargs.setdefault("in_channels", shape[2] if len(shape) == 3 else 1)
    elif name in ("vit", "vit_tiny", "vit_small"):
        kwargs.setdefault("image_shape", shape)
    return get_model(name, **kwargs)


def train_func_per_worker(config: dict) -> None:
    """The per-process training loop (see the module docstring)."""
    ctx = get_context()
    lr = config.get("lr", 1e-3)
    epochs = config.get("epochs", 3)
    batch_size = config.get("batch_size_per_worker", 8)
    seed = config.get("seed", 0)
    world = ctx.get_world_size()
    rank = ctx.get_world_rank()
    nproc = dist.process_count()
    train_loader, val_loader = get_dataloaders(
        batch_size * world // nproc,
        dataset=config.get("dataset", "fashion_mnist"),
        data_dir=config.get("data_dir"),
        seed=seed,
        shard_index=dist.process_index(),
        num_shards=nproc,
        **config.get("data_sizes", {}),
    )
    _log(f"dataloaders ready (world={world}, rank={rank}, "
         f"mesh={ctx.mesh.shape})")
    # The resume source first: its restore's buffers are backed in the
    # background while the model is built.
    mgr = ctx.checkpoint_manager
    in_run_step = mgr.latest_step() if mgr is not None else None
    ckpt = config.get("checkpoint")
    if isinstance(ckpt, dict):
        ckpt = Checkpoint.from_json(ckpt)
    pinned = ctx.device.type == "cuda"
    if in_run_step is not None:
        mgr.prewarm_restore(in_run_step, pinned=pinned)
    elif ckpt is not None:
        # A warm start reads the params only.
        prewarm_restore_handle(ckpt, weights_only=config.get("resume")
                               != "full", pinned=pinned)
    if not config.get("num_classes"):
        config = {**config,
                  "num_classes": getattr(train_loader, "num_classes", 10)}
    state = create_train_state(_build_model(config).to(ctx.device), lr)

    start_epoch = 0
    restoring = in_run_step is not None or ckpt is not None
    if restoring:
        prewarm_restore_wait()  # a restore takes only the landed buffers
    if in_run_step is not None:
        # A retried run resumes the full state from its own newest
        # retained step before it considers any warm start.
        load_checkpoint_tree(state, mgr.restore(
            in_run_step, abstract_state=checkpoint_tree(state,
                                                        abstract=True)))
        start_epoch = int(in_run_step)
        _log(f"in-run resume: restored retained step {in_run_step}")
    elif ckpt is not None:
        if config.get("resume") == "full":
            load_checkpoint_tree(state, restore_from_handle(
                ckpt, abstract_state=checkpoint_tree(state, abstract=True)))
            _log("full state restored from checkpoint (params+opt+step)")
        else:
            state = set_weights_from_checkpoint(state, ckpt)
            _log("model weights warm-started from checkpoint")
    if restoring and pinned:
        release_pinned()  # the restored tree is on the card and dropped
    # Every process starts from rank 0's parameters, BatchNorm statistics
    # and optimizer state.
    dist.replicate([*state.params, *running_stats(state.model).values(),
                    *state.tx.slots()["trace"]], ctx.mesh)
    # Pool files for the first saves, written while epoch 1 trains.
    ctx.prewarm_checkpoints(checkpoint_tree(state, abstract=True))

    train_step = make_train_step(mesh=ctx.mesh)
    eval_step = make_eval_step()
    rng = seed + 1
    start = time.monotonic()
    window = DispatchWindow(_DISPATCH_DEPTH)
    for epoch in range(start_epoch, epochs):
        epoch_start = time.monotonic()
        if world > 1:
            # The reference reshuffles only when world > 1.
            train_loader.set_epoch(epoch)
        n_batches = 0
        for placed in prefetch_to_device(train_loader, ctx.device,
                                         keys=("x", "y")):
            state, train_metrics = train_step(state, placed, rng)
            dist.step_fence(train_metrics["loss"])
            for matured in window.push(train_metrics["loss"]):
                float(matured)
            n_batches += 1
        for matured in window.drain():
            float(matured)

        loss_sum = correct = count = 0.0
        for batch in val_loader:
            out = eval_step(state, dist.shard_batch(batch, ctx.mesh))
            loss_sum += float(out["loss_sum"])
            correct += float(out["num_correct"])
            count += float(out["count"])
        val_loss = loss_sum / max(count, 1.0)
        accuracy = correct / max(count, 1.0)
        _log(f"epoch {epoch}: val_loss={val_loss:.4f} "
             f"accuracy={accuracy:.4f} ({n_batches} train batches, "
             f"{time.monotonic() - epoch_start:.1f}s)")
        ctx.report(
            {"val_loss": val_loss, "accuracy": accuracy},
            state=checkpoint_tree(state),
            step=epoch + 1,
            data_state={"epoch": epoch + 1, "batch_index": 0,
                        "seed": int(train_loader.seed)},
        )
    _log(f"total training time: {time.monotonic() - start:.1f}s")


def train_model(
    num_workers: int | None = None,
    *,
    device: str | None = None,
    model: str = "mlp",
    model_kwargs: dict | None = None,
    num_classes: int | None = None,
    checkpoint_storage_path: str | None = None,
    global_batch_size: int = 32,
    lr: float = 1e-3,
    epochs: int = 3,
    num_to_keep: int = 2,
    checkpoint: Checkpoint | dict | None = None,
    resume: str = "weights",
    dataset: str = "fashion_mnist",
    data_dir: str | None = None,
    seed: int = 0,
    n_train: int | None = None,
    n_test: int | None = None,
) -> Result:
    """The trainer entry point. ``num_workers``: data-parallel processes (None:
    the processes of the world ``dist.initialize`` joins, else 1; each
    process of a multi-process world calls this with its rendezvous
    variables set). ``device``: None is ``cuda``. ``n_train``/``n_test``:
    the synthetic stand-in's sizes (None: the dataset's default, as
    ``datasets.load_dataset`` has them)."""
    dist.initialize(resolve_device(device))
    workers = (num_workers if num_workers and num_workers > 0
               else dist.process_count())
    train_config = {
        "lr": lr,
        "epochs": epochs,
        "batch_size_per_worker": per_worker_batch_size(global_batch_size,
                                                       workers),
        "checkpoint": checkpoint,
        "resume": resume if resume in ("weights", "full") else "weights",
        "dataset": dataset,
        "data_dir": data_dir,
        "data_sizes": {"n_train": n_train, "n_test": n_test},
        "seed": seed,
        "model": model,
        "model_kwargs": model_kwargs,
        "num_classes": num_classes,
    }
    trainer = Trainer(
        train_func_per_worker,
        train_loop_config=train_config,
        scaling_config=ScalingConfig(num_workers=workers, device=device),
        run_config=RunConfig(
            storage_path=checkpoint_storage_path,
            checkpoint_config=CheckpointConfig(num_to_keep=num_to_keep),
        ),
    )
    return trainer.fit()


def train_fashion_mnist(num_workers: int | None = None, **kw) -> Result:
    """``train_model`` with the MLP."""
    kw.setdefault("model", "mlp")
    return train_model(num_workers, **kw)


class TorchPredictor:
    """Stateful batch predictor: loads the checkpoint's weights (and a
    BatchNorm model's running statistics) once into ``model`` (default the
    MLP), then maps batches to logits + argmax."""

    def __init__(self, checkpoint: Checkpoint | dict, *, model=None,
                 device: str | None = None, zero_copy: bool = False):
        if isinstance(checkpoint, dict):
            checkpoint = Checkpoint.from_json(checkpoint)
        self._predictor = BatchPredictor.from_checkpoint(
            checkpoint, model if model is not None else NeuralNetwork(),
            device=device, zero_copy=zero_copy)

    def __call__(self, batch: dict) -> dict:
        return self._predictor(batch)


__all__ = [
    "TorchPredictor",
    "build_model",
    "get_dataloaders",
    "get_labels_map",
    "map_batches",
    "set_weights_from_checkpoint",
    "train_fashion_mnist",
    "train_func_per_worker",
    "train_model",
]
