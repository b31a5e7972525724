"""GPT eval flow: event-triggered LM evaluation and the generation card.

Twin of ``flows/gpt_eval_flow.py`` (``TpuGptEval``) on the port: triggered
when ``TorchGptTrain`` finishes, it reads the run's checkpoint handle and
``model_config``, rebuilds the model, restores the weights
(``restore_from_handle``; ``--weights ema`` for the averaged ones),
computes the test loss and perplexity over the same held-out split
(``run_validation``), samples greedily and at two temperatures through the
port's ``generate``, and renders the card: perplexity, samples, and the
producer's training history. ``attn_impl`` (default ``xla``, the model's
default as in the reference) set to ``flash`` runs the validation and the
prefill on the flash forward kernel. ``--beam-size K`` > 1 adds a width-K
``beam_search`` sample with its length-normalized score.

Run:        python -m tpuflow_torch.flows.gpt_eval_flow run --checkpoint-run-pathspec TorchGptTrain/<id>
Triggered:  python -m tpuflow_torch.flows.gpt_eval_flow run --triggered
"""

import math

from tpuflow_torch.flow import (
    FlowSpec,
    Markdown,
    Parameter,
    Run,
    Table,
    card,
    current,
    device_profile,
    metrics_table,
    namespace,
    step,
    trigger_on_finish,
)


@trigger_on_finish(flow="TorchGptTrain")
class TorchGptEval(FlowSpec):
    """Evaluate a finished GPT training run: test perplexity and samples."""

    checkpoint_run_pathspec = Parameter(
        "checkpoint_run_pathspec", default="",
        help="run pathspec holding the result artifacts (TorchGptTrain/<id>)")
    eval_namespace = Parameter(
        "eval_namespace", default="", help="namespace to read artifacts from")
    batch_size = Parameter("batch_size", default=8, help="eval batch size")
    sample_tokens = Parameter("sample_tokens", default=32,
                              help="tokens to generate per sample")
    beam_size = Parameter(
        "beam_size", default=1,
        help="add a width-K beam-search sample to the card (1 = off)")
    weights = Parameter("weights", default="raw",
                        help="raw | ema: the trained or the averaged weights")
    device = Parameter("device", default="cuda", help="cuda | cpu")
    attn_impl = Parameter("attn_impl", default="xla",
                          help="xla | flash | auto for the eval model")

    def _get_run(self):
        """Trigger run first, then the explicit pathspec, else raise."""
        if current.trigger is not None and current.trigger.run is not None:
            return current.trigger.run
        if self.eval_namespace:
            namespace(self.eval_namespace)
        if self.checkpoint_run_pathspec:
            return Run(self.checkpoint_run_pathspec)
        raise ValueError(
            "no checkpoint source: run with --triggered after a "
            "TorchGptTrain run, or pass --checkpoint-run-pathspec "
            "TorchGptTrain/<id>")

    @device_profile(interval=1)
    @card(type="blank")
    @step
    def start(self):
        import torch

        from tpuflow_torch.ckpt import restore_from_handle
        from tpuflow_torch.ckpt.tree import load_params
        from tpuflow_torch.data.lm import check_dataset, lm_test_loader
        from tpuflow_torch.device import resolve_device
        from tpuflow_torch.infer.beam import beam_search
        from tpuflow_torch.infer.generate import generate, render_tokens
        from tpuflow_torch.models.gpt2 import GPT2, GPT2Config
        from tpuflow_torch.train.optim import make_optimizer
        from tpuflow_torch.train.step import (
            TrainState,
            make_eval_step,
            run_validation,
        )

        if self.weights not in ("raw", "ema"):
            raise ValueError(
                f"--weights must be raw or ema, got {self.weights!r}")
        run = self._get_run()
        ckpt = run.data.result_checkpoint
        mc = dict(run.data.model_config)
        dataset = run.data.dataset_used
        seq_len = int(run.data.seq_len_used)
        synthetic_size = int(run.data.synthetic_size_used)
        # Only lm_synth is ported: lm_text raises its "not ported" error
        # here, before the checkpoint is read.
        check_dataset(dataset)
        print(f"[gpt_eval] evaluating {ckpt.path} ({mc})")

        dev = resolve_device(self.device)
        cfg = GPT2Config(dropout=0.0, attn_impl=self.attn_impl, **mc)
        model = GPT2(cfg, seed=None, device=dev)
        # Zero-copy (mapped) weights once the producing run has succeeded:
        # no writer recycles its files any more.
        load_params(model, restore_from_handle(
            ckpt, weights_only=True,
            subtree=("ema_params",) if self.weights == "ema" else None,
            zero_copy=run.successful))
        state = TrainState(model=model, tx=make_optimizer(
            list(model.parameters()), 0.0, optimizer="sgd"))

        loader = lm_test_loader(int(self.batch_size), synthetic_size,
                                seq_len, cfg.vocab_size)
        self.test_loss = float(run_validation(state, loader,
                                              make_eval_step()))
        self.test_ppl = math.exp(min(self.test_loss, 30.0))
        print(f"[gpt_eval] test loss={self.test_loss:.4f} "
              f"ppl={self.test_ppl:.2f}")

        # Samples: greedy and two temperatures from the lm_synth prompt.
        prompt = torch.zeros((1, 4), dtype=torch.long)
        n_new = int(self.sample_tokens)

        def sample(temperature, **kw):
            toks = generate(model, prompt, max_new_tokens=n_new,
                            temperature=temperature, **kw)
            return render_tokens(toks[0].cpu())

        self.samples = [("greedy", sample(0.0))] + [
            (f"T={t}", sample(t, top_k=40, generator=torch.Generator(
                device=dev).manual_seed(0)))
            for t in (0.7, 1.0)
        ]
        beam = int(self.beam_size)
        if beam > 1:
            toks, score = beam_search(model, prompt, beam_size=beam,
                                      max_new_tokens=n_new)
            self.samples.append((
                f"beam K={beam} ({float(score[0]):.3f} nats/tok)",
                render_tokens(toks[0].cpu())))
        for name, text in self.samples:
            print(f"[gpt_eval] sample ({name}): {text!r}")

        current.card.append(Markdown("# GPT evaluation"))
        current.card.append(Markdown(
            f"Test perplexity **{self.test_ppl:.2f}** (loss "
            f"{self.test_loss:.4f} nats/token) on `{dataset}`."))
        current.card.append(Table([[n, t] for n, t in self.samples],
                                  headers=["sampling", "text"]))
        history = getattr(run.data, "metrics_history", None)
        if history:
            current.card.append(Markdown("## Producer training history"))
            current.card.append(metrics_table(history))
        self.next(self.end)

    @step
    def end(self):
        print(f"[gpt_eval] done: test ppl={self.test_ppl:.2f}")


def main(argv=None):
    return TorchGptEval.main(argv)


if __name__ == "__main__":
    main()
