"""GPT-family training on one device (counterpart of ``tpuflow/train/gpt.py``).

``train_gpt(cfg)`` runs the single-device leg of the JAX package's FSDP
recipe (``_run_fsdp_generation``): the epoch loop over the seeded LM
loaders, per-epoch held-out validation with perplexity, tokens/s that
exclude the cold first step, the loss and metrics histories, and the
optional greedy sample through the port's ``generate``. With a
``ckpt_dir`` it checkpoints as the JAX leg does: a save of the full state
at every epoch end (the JAX checkpoint tree, ``ckpt/tree.py``), an in-run
resume from the newest committed step, and a resume from a handle. What
the JAX leg does beyond one device raises ``NotImplementedError`` naming
the ROADMAP item: mesh axes whose product exceeds one device (FSDP and
friends), the pipeline and MoE legs, the health monitor, preemption and
elastic re-form. Nothing is silently ignored.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any

import torch

from tpuflow_torch.ckpt import (
    CheckpointManager,
    prewarm_restore_wait,
    release_pinned,
    restore_from_handle,
)
from tpuflow_torch.ckpt.tree import checkpoint_tree, load_checkpoint_tree
from tpuflow_torch.data.lm import make_lm_loaders
from tpuflow_torch.device import resolve_device
from tpuflow_torch.models.gpt2 import GPT2, GPT2Config
from tpuflow_torch.ops.flash_attention import BWD_MODES
from tpuflow_torch.train.optim import ROADMAP_TRAINING, make_optimizer
from tpuflow_torch.train.step import (
    TrainState,
    make_eval_step,
    make_train_step,
    run_validation,
    with_ema,
)

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}
_SELECTORS = ("full", "dots", "none")


def _resume_cursor(
    data_state: dict | None,
    step: int,
    steps_per_epoch: int,
    epochs: int,
    seed: int,
) -> tuple[int, int]:
    """(start_epoch, batches_to_skip) for a resume landing on ``step``.

    With a persisted loader cursor whose shuffle seed matches, the resume
    lands mid-epoch and replays exactly the epoch's unconsumed tail;
    without one, it falls back to the epoch head the step floors to."""
    if data_state and int(data_state.get("seed", -1)) == int(seed):
        epoch = min(int(data_state.get("epoch", 0)), epochs)
        skip = max(int(data_state.get("batch_index", 0)), 0)
        if skip >= steps_per_epoch:
            # Drained exactly at the epoch boundary: next epoch, no skip.
            return min(epoch + 1, epochs), 0
        return epoch, skip
    return min(step // steps_per_epoch, epochs), 0


def _apply_remat_selector(model_cfg: GPT2Config, selector: str) -> GPT2Config:
    """Map a remat selector onto a GPT2Config.

    ``none`` — remat off: every activation is saved, the flash residuals
               (q, k, v, o, lse) included; the backward recomputes nothing.
    ``dots`` — remat on, saving the matrix products and the flash forward's
               outputs; the elementwise work is recomputed.
    ``full`` — remat on, saving only block inputs.
    """
    if selector == "none":
        return dataclasses.replace(model_cfg, remat=False, remat_policy=None)
    if selector == "full":
        return dataclasses.replace(model_cfg, remat=True, remat_policy=None)
    if selector == "dots":
        return dataclasses.replace(model_cfg, remat=True, remat_policy="dots")
    raise ValueError(
        f"unknown remat selector {selector!r}; the port takes full|dots|none"
    )


def active_remat_policy(model_cfg: GPT2Config) -> str:
    """'none' when remat is off, 'full' for policy-less remat, else the
    policy name."""
    if not model_cfg.remat:
        return "none"
    return model_cfg.remat_policy or "full"


@dataclasses.dataclass
class GptTrainConfig:
    """Everything the GPT training recipe needs: the JAX package's fields
    and defaults. The port trains on one device, so the default mesh axes
    (data 2 x fsdp 2) raise; pass ``data_axis=1, fsdp_axis=1``."""

    preset: str = "test"            # test | gpt2 | medium
    epochs: int = 2
    steps_per_epoch: int = 16
    batch_size: int = 8             # global
    seq_len: int = 64
    learning_rate: float = 3e-4
    data_axis: int = 2
    fsdp_axis: int = 2
    tensor_axis: int = 1
    seq_axis: int = 1
    expert_axis: int = 1
    experts: int = 0                # Switch-MoE experts per block (0=dense)
    stage_axis: int = 1             # >1 = GPipe pipeline mode
    microbatches: int = 2
    attn_impl: str = "auto"         # auto | xla | flash | ring | ulysses
    dataset: str = "lm_synth"       # lm_synth | lm_text
    text_path: str | None = None    # pin the lm_text corpus file
    sample_tokens: int = 0
    accum_steps: int = 1
    optimizer_name: str = "adamw"   # adamw | sgd | adafactor | lion
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    grad_clip: float = 0.0
    weight_decay: float = 1e-4
    ema_decay: float = 0.0
    ckpt_dtype: str | None = None
    decay_steps: int = 0            # 0 = this run's epochs*steps
    # Remat selector: '' = the preset's default (full remat for gpt2 and
    # medium, none for test), else full | dots | none.
    remat_policy: str = ""
    # Activation dtype: '' = f32, 'bfloat16' = mixed precision (bf16
    # products, f32 master weights, optimizer state and loss head).
    dtype: str = ""

    def model_config(self) -> GPT2Config:
        act_dtype = None
        if self.dtype:
            if self.dtype not in _DTYPES:
                raise ValueError(
                    f"unknown dtype {self.dtype!r}; supported: bfloat16, "
                    "float16, float32"
                )
            act_dtype = _DTYPES[self.dtype]
        cfg = GPT2Config.from_preset(
            self.preset,
            attn_impl=self.attn_impl,
            seq_len=self.seq_len,
            stage_axis=self.stage_axis,
            n_experts=self.experts,
            dtype=act_dtype,
        )
        if self.remat_policy:
            if self.remat_policy not in _SELECTORS:
                raise ValueError(
                    f"unknown remat_policy {self.remat_policy!r}; the port "
                    "takes full|dots|none (jax.checkpoint_policies names "
                    "have no counterpart)"
                )
            cfg = _apply_remat_selector(cfg, self.remat_policy)
        return cfg

    def optimizer(self, params):
        total = self.epochs * self.steps_per_epoch
        return make_optimizer(
            params,
            self.learning_rate,
            optimizer=self.optimizer_name,
            weight_decay=self.weight_decay,
            grad_clip_norm=self.grad_clip or None,
            warmup_steps=self.warmup_steps,
            decay_steps=self.decay_steps
            or max(total - self.warmup_steps, 1),
            schedule=self.lr_schedule,
        )

    def validate(self) -> None:
        """Reject incoherent knob combinations with actionable messages."""
        if self.stage_axis > 1:
            if (
                self.tensor_axis > 1
                or self.seq_axis > 1
                or self.expert_axis > 1
            ):
                raise ValueError(
                    "pipeline (stage_axis) composes with data_axis only"
                )
            if self.accum_steps > 1:
                raise ValueError(
                    "accum_steps applies to the FSDP/DP step only; the "
                    "pipeline schedule already microbatches via "
                    "microbatches"
                )
            if self.ema_decay > 0.0:
                raise ValueError(
                    "ema_decay is not supported in pipeline mode "
                    "(stage_axis > 1); the pipeline step tracks no EMA"
                )
        if self.experts and self.experts % self.expert_axis:
            raise ValueError(
                f"experts {self.experts} must be divisible by "
                f"expert_axis {self.expert_axis}"
            )


@dataclasses.dataclass
class GptTrainResult:
    checkpoint: Any                  # the newest step's handle; None without
                                     # a ckpt_dir
    loss_history: list[float]        # per-epoch mean train loss
    metrics_history: list[dict]      # per epoch: losses, ppl, tokens/s
    sample: list[int] | None = None  # greedy tokens when sample_tokens > 0
    # The port's additions: each step's loss and host wall seconds (every
    # step ends in a synchronizing read of its loss).
    step_losses: list[float] = dataclasses.field(default_factory=list)
    step_s: list[float] = dataclasses.field(default_factory=list)
    # With a ckpt_dir: the manager's save and restore records (step,
    # bytes, seconds, GB/s).
    checkpoint_io: dict | None = None


def _deferred(what: str):
    return NotImplementedError(f"{what} is not ported yet: {ROADMAP_TRAINING}")


def _check_supported(cfg: GptTrainConfig, ckpt_dir, health: bool,
                     preemption: bool, elastic: bool) -> None:
    """Raise for every option of the JAX recipe the port does not run."""
    axes = {
        "data_axis": cfg.data_axis, "fsdp_axis": cfg.fsdp_axis,
        "tensor_axis": cfg.tensor_axis, "seq_axis": cfg.seq_axis,
        "expert_axis": cfg.expert_axis,
    }
    n = math.prod(axes.values())
    if n > 1:
        desc = " x ".join(f"{k}={v}" for k, v in axes.items())
        raise _deferred(
            f"a mesh of {desc} = {n} devices (the port trains on one "
            "device; set every axis to 1); multi-device training (FSDP2)"
        )
    if cfg.stage_axis > 1:
        raise _deferred(f"pipeline parallelism (stage_axis={cfg.stage_axis})")
    if cfg.experts > 0:
        raise _deferred(f"MoE blocks (experts={cfg.experts})")
    if cfg.ckpt_dtype and ckpt_dir is None:
        raise ValueError(f"ckpt_dtype={cfg.ckpt_dtype!r} casts checkpoints, "
                         "but no ckpt_dir was given to save them in")
    if health:
        raise _deferred("the training-health monitor (health=True)")
    if preemption:
        raise _deferred("preemption drain and requeue (preemption=True)")
    if elastic:
        raise _deferred("elastic mesh re-form (elastic=True)")


def _init_model(model_cfg: GPT2Config, device, seed: int | None = 0) -> GPT2:
    """The model at step 0: random weights from ``seed`` (None: left
    uninitialised, for a restore to fill)."""
    return GPT2(model_cfg, seed=seed, device=device)


def init_state(cfg: GptTrainConfig, model_cfg: GPT2Config | None = None,
               device=None, *, materialize: bool = True) -> TrainState:
    """Model, optimizer and (with ``ema_decay``) EMA weights at step 0.
    ``materialize=False`` skips the random weights (a restore overwrites
    them); the optimizer's moments are zeros on the device either way."""
    model_cfg = model_cfg or cfg.model_config()
    model = _init_model(model_cfg, resolve_device(device),
                        seed=0 if materialize else None)
    state = TrainState(model=model, tx=cfg.optimizer(model.parameters()))
    if cfg.ema_decay > 0.0:
        state = with_ema(state)
    return state


def train_gpt(
    cfg: GptTrainConfig,
    ckpt_dir: str | None = None,
    resume_checkpoint=None,
    log=print,
    *,
    device=None,
    flash_bwd: str = "fused",
    health: bool = False,
    preemption: bool = False,
    elastic: bool = False,
) -> GptTrainResult:
    """Run the configured GPT training leg end to end on one device
    (``cuda`` unless ``device`` says otherwise).

    ``ckpt_dir``: a ``CheckpointManager(max_to_keep=2,
    save_dtype=cfg.ckpt_dtype)`` there saves the full state at every epoch
    end (metrics ``val_loss``/``train_loss``/``ppl``, the loader cursor as
    ``data_state``), and a directory that already holds committed steps
    resumes from the newest (state, histories, start epoch). None trains
    without checkpoints; the manager's pool is prewarmed for the saves
    (on memory-backed storage), and an in-run resume's restore buffers
    while the model is built (page-locked on the card, and handed back
    once the state is on it).
    ``resume_checkpoint``: a ``Checkpoint`` handle to restore the full
    state from; it wins over the in-run resume. A caller that knows the
    handle early backs its restore first (``prewarm_restore_handle``, as
    ``TorchGptTrain`` does).
    ``flash_bwd``: the flash attention backward, ``fused`` | ``split`` |
    ``blockwise`` (the JAX package's ``TPUFLOW_FLASH_BWD``; ``blockwise``,
    the plain version, on the CPU only). ``health``,
    ``preemption`` and ``elastic`` name features of the JAX leg that are
    not ported; setting any raises."""
    cfg.validate()
    _check_supported(cfg, ckpt_dir, health, preemption, elastic)
    if flash_bwd not in BWD_MODES:
        raise ValueError(f"unknown flash_bwd {flash_bwd!r}; use "
                         f"{'|'.join(BWD_MODES)}")
    model_cfg = dataclasses.replace(cfg.model_config(), flash_bwd=flash_bwd)
    dev = resolve_device(device)
    loader, val_loader = make_lm_loaders(
        cfg.batch_size, cfg.steps_per_epoch, cfg.seq_len,
        model_cfg.vocab_size, dataset=cfg.dataset, text_path=cfg.text_path,
    )
    log(f"[gpt] device {dev}, preset {cfg.preset}, remat "
        f"{active_remat_policy(model_cfg)}, attn {model_cfg.attn_impl}"
        f" (flash backward {flash_bwd})")
    mgr = None
    resume_step = None
    if ckpt_dir is not None:
        mgr = CheckpointManager(ckpt_dir, max_to_keep=2,
                                save_dtype=cfg.ckpt_dtype or None)
        # In-run resume: a previous attempt of this run left committed
        # steps; an explicit handle (a cross-run resume) wins.
        if resume_checkpoint is None:
            resume_step = mgr.latest_step()
        if resume_step is not None and not cfg.ckpt_dtype:
            # Back the restore's buffers while the model is built (a
            # ckpt_dtype step is cast on restore and would take none).
            mgr.prewarm_restore(resume_step, pinned=dev.type == "cuda")
    resuming = resume_checkpoint is not None or resume_step is not None
    state = init_state(cfg, model_cfg, dev, materialize=not resuming)
    scan = model_cfg.scan_layers
    if resuming:
        t0 = time.monotonic()
        tmpl = checkpoint_tree(state, scan_layers=scan, abstract=True)
        prewarm_restore_wait()  # a restore takes only the landed buffers
        if resume_checkpoint is not None:
            restored = restore_from_handle(resume_checkpoint,
                                           abstract_state=tmpl)
        else:
            # crc-verified; a corrupt newest step falls back to the one
            # before it, and the cursor below is read from the step that
            # was restored.
            restored = mgr.restore(resume_step, abstract_state=tmpl)
            resume_step = mgr.restores[-1]["step"]
        load_checkpoint_tree(state, restored)
        del restored
        release_pinned()
        log(f"[gpt] full state restored"
            f"{' (in-run resume)' if resume_step is not None else ''}: "
            f"{time.monotonic() - t0:.1f}s")
    if mgr is not None:
        # Pool files for the saves, written while the first epoch trains.
        mgr.prewarm(checkpoint_tree(state, scan_layers=scan, abstract=True))
    train_step = make_train_step(
        accum_steps=cfg.accum_steps, ema_decay=cfg.ema_decay or None
    )
    eval_step = make_eval_step()
    rng = 1
    history, epoch_records, step_losses, step_s = [], [], [], []
    start_epoch = skip = 0
    if resume_step is not None:
        # Continuous histories across the resume, as the restored step
        # recorded them (drain-only saves carry no metrics and are
        # skipped).
        meta = mgr.restore_metadata(resume_step)
        for m in meta.get("metrics_history", []):
            if "train_loss" in m:
                history.append(m["train_loss"])
                epoch_records.append({
                    "epoch": len(epoch_records),
                    "train_loss": m.get("train_loss"),
                    "val_loss": m.get("val_loss"), "ppl": m.get("ppl"),
                    "tokens_per_s": None,
                })
        start_epoch, skip = _resume_cursor(
            meta.get("data_state"),
            state.step, cfg.steps_per_epoch, cfg.epochs, loader.seed,
        )
        log(f"[gpt] in-run resume from step {state.step} → epoch "
            f"{start_epoch}"
            + (f" (replaying from batch {skip})" if skip else ""))
    cold = True
    for epoch in range(start_epoch, cfg.epochs):
        loader.set_epoch(epoch)
        if skip:
            loader.skip_batches(skip)
            skip = 0
        t_epoch = time.monotonic()
        losses, n_tokens = [], 0
        for batch in loader:
            t0 = time.monotonic()
            state, metrics = train_step(state, batch, rng)
            loss = float(metrics["loss"])  # the step's fence
            step_s.append(time.monotonic() - t0)
            losses.append(loss)
            if cold:
                # The first step pays the kernel builds and allocator
                # warm-up: its tokens stay out of the rate.
                cold = False
                t_epoch = time.monotonic()
            else:
                n_tokens += int(batch["y"].size)
        step_losses += losses
        epoch_s = time.monotonic() - t_epoch
        tok_s = n_tokens / max(epoch_s, 1e-9) if n_tokens else None
        epoch_loss = sum(losses) / len(losses)
        history.append(epoch_loss)
        val_loss = run_validation(state, val_loader, eval_step)
        ppl = math.exp(min(val_loss, 30.0))
        epoch_records.append({
            "epoch": epoch,
            "train_loss": epoch_loss,
            "val_loss": val_loss,
            "ppl": ppl,
            "tokens_per_s": round(tok_s, 1) if tok_s else None,
        })
        rate = f" ({tok_s:.0f} tok/s)" if tok_s else ""
        log(f"[gpt] epoch {epoch}: loss={epoch_loss:.4f} "
            f"val_loss={val_loss:.4f} ppl={ppl:.2f}{rate}")
        if mgr is not None:
            mgr.save(
                state.step, checkpoint_tree(state, scan_layers=scan),
                metrics={"val_loss": val_loss, "train_loss": epoch_loss,
                         "ppl": ppl},
                # Epoch boundary: a resume starts at the next epoch's head.
                data_state={"epoch": epoch + 1, "batch_index": 0,
                            "seed": loader.seed},
            )
    checkpoint = None
    if mgr is not None:
        mgr.wait_until_finished()
        checkpoint = mgr.checkpoint()
        mgr.close()
    result = GptTrainResult(
        checkpoint=checkpoint, loss_history=history,
        metrics_history=epoch_records, step_losses=step_losses,
        step_s=step_s,
        checkpoint_io=({"saves": mgr.saves, "restores": mgr.restores}
                       if mgr is not None else None),
    )
    if cfg.sample_tokens > 0:
        result.sample = _sample_greedy(cfg, state.model, log)
    return result


def _sample_greedy(cfg: GptTrainConfig, model, log) -> list[int]:
    """Greedy KV-cache decode of ``sample_tokens`` tokens from a 4-token
    zero prompt (the lm_synth prompt of the JAX leg)."""
    from tpuflow_torch.infer.generate import generate

    toks = generate(
        model, torch.zeros((1, 4), dtype=torch.long),
        max_new_tokens=cfg.sample_tokens, temperature=0.0,
    )
    sample = [int(t) for t in toks[0]]
    log(f"[gpt] greedy sample: {sample}")
    return sample
