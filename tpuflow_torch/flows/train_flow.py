"""Training flow: image-classifier training on the card, as a gang of one
process per card.

Twin of ``flows/train_flow.py`` (``TpuTrain``) on the port: the 4-step DAG
``start -> train (x num_parallel gang) -> join -> end`` with the cron
record, the same parameters (epochs, batch size, learning rate, the
``--from-task`` / ``--from-run`` warm start resolved task first, then
run), a train step with retry x3, a gang formation timeout and device
profiling, checkpoints under ``current.tpu_storage_path``, and the
tolerant join. The JAX package's ``TPUFLOW_N_PARALLEL`` is the
``num_parallel`` parameter here (default 1: NCCL takes one process per
card); ``device`` (default ``cuda``) and the synthetic set's sizes
(``n_train`` / ``n_test``, 0 for the dataset's default) are parameters
too. ``--model`` takes the JAX flow's list (``mlp``, ``resnet18``,
``resnet50``, ``vit``, ``vit_tiny``, ``vit_small``), ``--dataset``
``fashion_mnist``, ``mnist``, ``cifar10`` or ``imagenet_synth``.

Run:      python -m tpuflow_torch.flows.train_flow run [--device cpu --home <dir>]
Resume:   python -m tpuflow_torch.flows.train_flow run --from-run TorchTrain/<id>
"""

from tpuflow_torch.flow import (
    FlowSpec,
    Parameter,
    Run,
    Task,
    current,
    device_profile,
    gpu,
    kubernetes,
    retry,
    schedule,
    step,
)


@schedule(cron="*/5 * * * *")
class TorchTrain(FlowSpec):
    """Train an image classifier (the MLP on FashionMNIST by default) with
    data-parallel workers, one a card, and per-epoch checkpoints."""

    epochs = Parameter("epochs", default=3, help="number of training epochs")
    batch_size = Parameter(
        "batch_size", default=32,
        help="global batch size (split across workers)")
    learning_rate = Parameter("learning_rate", default=1e-3, help="SGD lr")
    from_task = Parameter(
        "from_task", default="",
        help="task pathspec Flow/run/step/task to warm-start the model from")
    from_run = Parameter(
        "from_run", default="",
        help="run pathspec Flow/run to warm-start the model from")
    dataset = Parameter("dataset", default="fashion_mnist",
                        help="dataset name")
    model = Parameter(
        "model", default="mlp",
        help="mlp | resnet18 | resnet50 | vit | vit_tiny | vit_small "
        "(BASELINE configs 1-2 run the resnets through this same flow; "
        "the vit_tiny/vit_small patch-16 presets need images patch-16 "
        "divides, e.g. imagenet_synth; use 'vit' for the 28/32-pixel "
        "datasets)")
    num_parallel = Parameter(
        "num_parallel", default=1,
        help="processes of the train step's gang (one a card under NCCL)")
    device = Parameter("device", default="cuda", help="cuda | cpu")
    n_train = Parameter(
        "n_train", default=0,
        help="rows of the synthetic train split (0: the dataset's default)")
    n_test = Parameter(
        "n_test", default=0,
        help="rows of the synthetic test split (0: the dataset's default)")

    @step
    def start(self):
        self.next(self.train, num_parallel=int(self.num_parallel))

    @retry(times=3)
    @gpu(all_hosts_started_timeout=60 * 5)
    @kubernetes(gpu=1)
    @device_profile(interval=1)
    @step
    def train(self):
        from tpuflow_torch.flows import my_torch_module

        # Warm-start checkpoint: task pathspec first, then run pathspec;
        # the artifact carries a handle, never tensors.
        checkpoint = None
        if self.from_task:
            checkpoint = Task(self.from_task).data.result.checkpoint
        elif self.from_run:
            checkpoint = Run(self.from_run).data.result.checkpoint
        if checkpoint is not None:
            print(f"[train_flow] warm-starting from checkpoint "
                  f"{checkpoint.path}")
        self.warm_started = checkpoint is not None
        # Handoff artifacts: the eval flow rebuilds this model on this
        # dataset's test split.
        self.model_used = self.model
        self.dataset_used = self.dataset
        self.data_sizes_used = {"n_train": int(self.n_train) or None,
                                "n_test": int(self.n_test) or None}
        self.result = my_torch_module.train_model(
            num_workers=None,  # every process of the gang's world
            device=self.device,
            model=self.model,
            checkpoint_storage_path=current.tpu_storage_path,
            global_batch_size=int(self.batch_size),
            lr=float(self.learning_rate),
            epochs=int(self.epochs),
            checkpoint=checkpoint,
            dataset=self.dataset,
            **self.data_sizes_used,
        )
        self.next(self.join)

    @step
    def join(self, inputs):
        # Only the gang head carries a result.
        result = None
        for inp in inputs:
            try:
                result = inp.result
                break
            except AttributeError:
                continue
        if result is None:
            raise RuntimeError("no gang member produced a result artifact")
        self.result = result
        self.next(self.end)

    @step
    def end(self):
        print(f"[train_flow] result metrics: {self.result.metrics}")


def main(argv=None):
    return TorchTrain.main(argv)


if __name__ == "__main__":
    main()
