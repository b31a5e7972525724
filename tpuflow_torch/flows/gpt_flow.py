"""GPT-2 training flow.

Twin of ``flows/gpt_flow.py`` (``TpuGptTrain``) on the port: the same
parameters bind onto ``tpuflow_torch.train.gpt.GptTrainConfig`` and
``train_gpt`` does the work (the flash kernels with ``--attn-impl
flash``), with per-epoch checkpoints under the step's storage and a
full-state resume with ``--from-run``. The JAX flow runs its ``data`` x
``fsdp`` mesh in one process over many devices; the port runs one
process per card, so the train step is a gang of ``data_axis`` x
``fsdp_axis`` x ``tensor_axis`` x ``seq_axis`` x ``expert_axis`` members
(FSDP, with Megatron tensor and expert parallelism and ring, Ulysses or
gathered attention on ``seq``; the defaults, 2 x 2 x 1 x 1 x 1, take
four cards), or of ``data_axis`` x ``stage_axis`` members in pipeline
mode (``--stage-axis`` > 1, GPipe over ``--microbatches``), whose head
carries the artifacts. ``--dist-backend gloo`` with a device that
names a card (``--device cuda:0``) runs the gang's members on that one
card. The artifacts match
the reference's: ``model_config``, ``dataset_used``, ``seq_len_used``,
``synthetic_size_used``, ``result_checkpoint``, ``loss_history``,
``metrics_history`` (and ``sample``), ``text_source`` on ``lm_text``
(the corpus's path and sha256, which the eval flow checks), and the
``end`` step's training curve card. Options ``train_gpt`` does not run
yet raise its ``NotImplementedError`` naming the ROADMAP item.
``device`` (default ``cuda``), ``flash_bwd``
(the JAX package's ``TPUFLOW_FLASH_BWD``), ``text_path`` (its
``TPUFLOW_TEXT_FILE``) and ``ckpt_format`` (its ``TPUFLOW_CKPT_FORMAT``:
``raw``, or ``dcp`` for ``torch.distributed.checkpoint`` as the JAX
package's ``orbax``) are parameters. The runner's node-local
checkpoint tier (``FlowRunner(ckpt_local_dir=)``) reaches ``train_gpt``
through ``current.ckpt_local_dir``.

Run:    python -m tpuflow_torch.flows.gpt_flow run --preset test
        [--data-axis 1 --fsdp-axis 1]   (one process)
"""

import math
import os

from tpuflow_torch.flow import (
    FlowSpec,
    Parameter,
    Run,
    card,
    current,
    device_profile,
    gpu,
    retry,
    step,
    training_curve_card,
)


class TorchGptTrain(FlowSpec):
    """Train GPT-2 on LM data on data_axis x fsdp_axis x tensor_axis x
    seq_axis x expert_axis cards (data_axis x stage_axis in pipeline
    mode; one process each, the state sharded over them), checkpointing
    the full state."""

    preset = Parameter("preset", default="test", help="test | gpt2 | medium")
    epochs = Parameter("epochs", default=2, help="epochs")
    steps_per_epoch = Parameter("steps_per_epoch", default=16,
                                help="steps/epoch")
    batch_size = Parameter("batch_size", default=8, help="global batch size")
    seq_len = Parameter("seq_len", default=64, help="sequence length")
    learning_rate = Parameter("learning_rate", default=3e-4, help="adamw lr")
    data_axis = Parameter("data_axis", default=2, help="mesh 'data' size")
    fsdp_axis = Parameter("fsdp_axis", default=2, help="mesh 'fsdp' size")
    tensor_axis = Parameter("tensor_axis", default=1,
                            help="mesh 'tensor' size")
    seq_axis = Parameter("seq_axis", default=1, help="mesh 'seq' size")
    expert_axis = Parameter("expert_axis", default=1,
                            help="mesh 'expert' size (expert parallel)")
    experts = Parameter("experts", default=0,
                        help="Switch-MoE experts per block (0 = dense MLP)")
    stage_axis = Parameter("stage_axis", default=1,
                           help="mesh 'stage' size (GPipe pipeline)")
    microbatches = Parameter("microbatches", default=2,
                             help="pipeline microbatches per step")
    attn_impl = Parameter(
        "attn_impl", default="auto",
        help="auto|xla|flash|ring|ulysses (auto = flash on the card at "
        "T >= 128, else xla)")
    dataset = Parameter("dataset", default="lm_synth",
                        help="lm_synth | lm_text (byte-level)")
    text_path = Parameter(
        "text_path", default="",
        help="the lm_text corpus file (empty = the synthetic stand-in)")
    from_run = Parameter("from_run", default="",
                         help="run pathspec to resume full state from")
    sample_tokens = Parameter("sample_tokens", default=0,
                              help="greedy-decode N tokens after training")
    accum_steps = Parameter(
        "accum_steps", default=1,
        help="gradient-accumulation microbatches per optimizer step")
    optimizer = Parameter("optimizer", default="adamw",
                          help="adamw | sgd | adafactor | lion")
    lr_schedule = Parameter("lr_schedule", default="constant",
                            help="constant | cosine | linear")
    warmup_steps = Parameter("warmup_steps", default=0,
                             help="linear LR warmup steps")
    grad_clip = Parameter("grad_clip", default=0.0,
                          help="global-norm gradient clip (0 = off)")
    weight_decay = Parameter("weight_decay", default=1e-4,
                             help="adamw decoupled weight decay")
    ema_decay = Parameter("ema_decay", default=0.0,
                          help="EMA decay for averaged weights (0 = off)")
    ckpt_dtype = Parameter(
        "ckpt_dtype", default="",
        help="reduced-precision checkpoints: bfloat16 | float16 (default "
        "bit-exact)")
    decay_steps = Parameter(
        "decay_steps", default=0,
        help="LR decay horizon in steps (0 = this run's epochs*steps)")
    remat_policy = Parameter(
        "remat_policy", default="",
        help="full | dots | none (empty = the preset's default)")
    dtype = Parameter("dtype", default="",
                      help="activation dtype: bfloat16 | float16 | float32")
    device = Parameter(
        "device", default="cuda",
        help="cuda | cpu | cuda:<i> (every gang member on card i)")
    flash_bwd = Parameter("flash_bwd", default="fused",
                          help="flash backward: fused | split | blockwise")
    ckpt_format = Parameter(
        "ckpt_format", default="raw",
        help="checkpoint format: raw (crosses into the JAX package) | dcp "
        "(torch.distributed.checkpoint)")
    dist_backend = Parameter(
        "dist_backend", default="",
        help="the gang's torch.distributed backend (empty: nccl on the "
        "card, gloo on the cpu; gloo lets members share a card)")

    def _train_config(self):
        from tpuflow_torch.train.gpt import GptTrainConfig

        return GptTrainConfig(
            preset=self.preset,
            epochs=int(self.epochs),
            steps_per_epoch=int(self.steps_per_epoch),
            batch_size=int(self.batch_size),
            seq_len=int(self.seq_len),
            learning_rate=float(self.learning_rate),
            data_axis=int(self.data_axis),
            fsdp_axis=int(self.fsdp_axis),
            tensor_axis=int(self.tensor_axis),
            seq_axis=int(self.seq_axis),
            expert_axis=int(self.expert_axis),
            experts=int(self.experts),
            stage_axis=int(self.stage_axis),
            microbatches=int(self.microbatches),
            attn_impl=self.attn_impl,
            dataset=self.dataset,
            sample_tokens=int(self.sample_tokens),
            accum_steps=int(self.accum_steps),
            optimizer_name=self.optimizer,
            lr_schedule=self.lr_schedule,
            warmup_steps=int(self.warmup_steps),
            grad_clip=float(self.grad_clip),
            weight_decay=float(self.weight_decay),
            ema_decay=float(self.ema_decay),
            ckpt_dtype=self.ckpt_dtype or None,
            decay_steps=int(self.decay_steps),
            remat_policy=self.remat_policy,
            dtype=self.dtype,
        )

    @step
    def start(self):
        self.resume_checkpoint = None
        if self.from_run:
            self.resume_checkpoint = Run(self.from_run).data.result_checkpoint
            print(f"[gpt_flow] resuming from {self.resume_checkpoint.path}")
        from tpuflow_torch.train.gpt import mesh_axes

        self.next(self.train,
                  num_parallel=math.prod(
                      mesh_axes(self._train_config()).values()))

    @retry(times=3)
    @gpu(all_hosts_started_timeout=60 * 5)
    @device_profile(interval=1)
    @step
    def train(self):
        from tpuflow_torch import dist
        from tpuflow_torch.ckpt import prewarm_restore_handle
        from tpuflow_torch.data.lm import lm_corpus_size, text_source_record
        from tpuflow_torch.device import resolve_device
        from tpuflow_torch.train.gpt import train_gpt

        cfg = self._train_config()
        cfg.validate()
        mc = cfg.model_config()
        # What an eval flow needs to rebuild the model and see the same
        # held-out split.
        self.model_config = {
            "vocab_size": mc.vocab_size,
            "n_ctx": mc.n_ctx,
            "n_embd": mc.n_embd,
            "n_layer": mc.n_layer,
            "n_head": mc.n_head,
            "scan_layers": mc.scan_layers,
            "n_experts": mc.n_experts,
        }
        self.dataset_used = cfg.dataset
        self.seq_len_used = cfg.seq_len
        self.synthetic_size_used = lm_corpus_size(cfg.batch_size,
                                                  cfg.steps_per_epoch)
        if cfg.dataset == "lm_text":
            # The corpus's identity, which the eval flow checks before it
            # scores: the file trained on and its content hash.
            self.text_source = text_source_record(self.text_path or None)
            cfg.text_path = self.text_source["path"]
        ckpt = self.resume_checkpoint
        if (ckpt is not None and not ckpt.metadata.get("save_dtype")
                and dist.process_count() == 1):
            # Back the restore's buffers while train_gpt builds the model
            # (a save_dtype checkpoint is cast on restore and takes none;
            # a gang member restores only its region, whose buffers
            # train_gpt backs from its template).
            prewarm_restore_handle(
                ckpt, pinned=resolve_device(self.device).type == "cuda")
        result = train_gpt(
            cfg,
            ckpt_dir=os.path.join(current.tpu_storage_path, "checkpoints"),
            resume_checkpoint=self.resume_checkpoint,
            device=self.device,
            flash_bwd=self.flash_bwd,
            ckpt_format=self.ckpt_format,
            ckpt_local_dir=current.ckpt_local_dir,
        )
        self.result_checkpoint = result.checkpoint
        self.loss_history = result.loss_history
        self.metrics_history = result.metrics_history
        if result.sample is not None:
            self.sample = result.sample
        self.next(self.end)

    @card(type="blank")
    @step
    def end(self):
        training_curve_card(current.card,
                            getattr(self, "metrics_history", None) or [])
        print(f"[gpt_flow] loss history: {self.loss_history}")


def main(argv=None):
    return TorchGptTrain.main(argv)


if __name__ == "__main__":
    main()
