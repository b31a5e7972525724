"""Eval flow: event-triggered batch inference and the error-analysis card.

Twin of ``flows/eval_flow.py`` (``TpuEval``) on the port: triggered when
``TorchTrain`` finishes, it resolves the training checkpoint (trigger,
then task pathspec, then run pathspec, else the "no checkpoint source"
error), runs ``TorchPredictor`` over ``map_batches`` on the test rows,
joins labels and predictions in numpy (the JAX flow's dataframe), and
renders the card: the misclassified count, then up to 50 sampled errors
with the input image, the true and predicted labels and a bar chart of
the logits. No pandas and no matplotlib: the image is a PNG encoded from
numpy and the bars are SVG (``flow/cards.py``).

Run:        python -m tpuflow_torch.flows.eval_flow run --checkpoint-run-pathspec TorchTrain/<id>
Triggered:  python -m tpuflow_torch.flows.eval_flow run --triggered
"""

import numpy as np

from tpuflow_torch.flow import (
    BarChart,
    FlowSpec,
    Image,
    Markdown,
    Parameter,
    Run,
    Table,
    Task,
    card,
    current,
    device_profile,
    kubernetes,
    namespace,
    step,
    trigger_on_finish,
)

N_ERROR_SAMPLES = 50


@trigger_on_finish(flow="TorchTrain")
class TorchEval(FlowSpec):
    """Load the training checkpoint, run batch inference on the test set,
    and render an error-analysis card."""

    checkpoint_task_pathspec = Parameter(
        "checkpoint_task_pathspec", default="",
        help="task pathspec holding the result artifact (Flow/run/step/task)")
    checkpoint_run_pathspec = Parameter(
        "checkpoint_run_pathspec", default="",
        help="run pathspec holding the result artifact (Flow/run)")
    eval_namespace = Parameter(
        "eval_namespace", default="", help="namespace to read artifacts from")
    batch_size = Parameter("batch_size", default=512,
                           help="inference batch size")
    dataset = Parameter(
        "dataset", default="",
        help="dataset name (default: the producing run's dataset_used)")
    device = Parameter("device", default="cuda", help="cuda | cpu")
    n_test = Parameter(
        "n_test", default=0,
        help="rows of the synthetic test split (0: the producing run's, "
        "else 10000)")

    def _get_source(self):
        """Trigger run first, then the task pathspec, then the run
        pathspec, else raise. Returns ``(run, checkpoint)``: the producing
        run carries the model and dataset artifacts."""
        if current.trigger is not None and current.trigger.run is not None:
            run = current.trigger.run
            return run, run.data.result.best_checkpoint
        if self.eval_namespace:
            namespace(self.eval_namespace)
        if self.checkpoint_task_pathspec:
            task = Task(self.checkpoint_task_pathspec)
            return (Run(f"{task.flow}/{task.run_id}"),
                    task.data.result.best_checkpoint)
        if self.checkpoint_run_pathspec:
            run = Run(self.checkpoint_run_pathspec)
            return run, run.data.result.best_checkpoint
        raise ValueError(
            "no checkpoint source: run with --triggered after a TorchTrain "
            "run, or pass --checkpoint-run-pathspec / "
            "--checkpoint-task-pathspec")

    @kubernetes(gpu=1)
    @device_profile(interval=1)
    @card(type="blank")
    @step
    def start(self):
        from tpuflow_torch.data.datasets import dataset_info
        from tpuflow_torch.flows import my_torch_module as m

        run, checkpoint = self._get_source()
        model_name = getattr(run.data, "model_used", "mlp")
        dataset = self.dataset or getattr(run.data, "dataset_used",
                                          "fashion_mnist")
        sizes = getattr(run.data, "data_sizes_used", None) or {}
        n_test = int(self.n_test) or int(sizes.get("n_test", 10_000))
        self.dataset_used = dataset
        print(f"[eval_flow] evaluating checkpoint {checkpoint.path} "
              f"(model={model_name}, dataset={dataset}, {n_test} rows)")
        info = dataset_info(dataset)
        # The test split alone: the synthetic set draws it independently of
        # the train split's size.
        rows = m.get_dataloaders(int(self.batch_size), dataset=dataset,
                                 as_rows=True, n_train=0, n_test=n_test)
        predictor = m.TorchPredictor(
            checkpoint,
            model=m.build_model(model_name, num_classes=info["num_classes"]),
            device=self.device)
        outputs = m.map_batches(rows, predictor,
                                batch_size=int(self.batch_size))

        labels = np.array([r["labels"] for r in rows], dtype=np.int64)
        predicted = np.array([int(o["predicted_values"]) for o in outputs],
                             dtype=np.int64)
        self.n_rows = int(len(labels))
        mis = np.flatnonzero(labels != predicted)
        self.n_misclassified = int(len(mis))
        print(f"[eval_flow] {self.n_misclassified}/{self.n_rows} "
              "misclassified")

        labels_map = m.get_labels_map(dataset)
        current.card.append(Markdown("# Error analysis"))
        current.card.append(Markdown(
            f"**{self.n_misclassified}** of **{self.n_rows}** test rows were "
            "misclassified."))
        if len(mis):
            sample = np.random.default_rng(0).choice(
                mis, size=min(N_ERROR_SAMPLES, len(mis)), replace=False)
            table_rows = []
            for idx in sample:
                features = np.asarray(rows[idx]["features"])
                img = features if features.ndim >= 2 else features.reshape(
                    28, 28)
                logits = np.asarray(outputs[idx]["logits"], dtype=np.float32)
                # Wide heads chart their top 10 logits only.
                top = (np.argsort(logits)[-10:] if len(logits) > 16
                       else np.arange(len(logits)))
                table_rows.append([
                    Image.from_array(img, scale=2),
                    labels_map[int(labels[idx])],
                    labels_map[int(predicted[idx])],
                    BarChart(logits[top], [labels_map[int(i)] for i in top]),
                ])
            current.card.append(Table(
                table_rows,
                headers=["input", "true label", "predicted", "logits"]))
        self.next(self.end)

    @step
    def end(self):
        print(f"[eval_flow] done: {self.n_misclassified}/{self.n_rows} "
              "misclassified")


def main(argv=None):
    return TorchEval.main(argv)


if __name__ == "__main__":
    main()
