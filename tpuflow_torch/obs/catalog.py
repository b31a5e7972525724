"""The telemetry names the port emits, each with its kind (the subset of
``tpuflow/obs/catalog.py`` that the port's emitters use, with the JAX
catalog's kinds; the rest join with the code that emits them).

Kinds: ``span`` (a timed region: ``ts`` and ``dur_s``), ``counter``,
``gauge``, ``histogram`` and ``event`` (a point-in-time record).
"""

from __future__ import annotations

CATALOG: dict[str, tuple[str, str]] = {
    # ---------------------------------------------------------------- flow
    "flow.run": ("span", "one whole flow run, start → terminal status"),
    "flow.step": ("span", "one step/task execution (attempt granularity)"),
    "flow.gang_member": ("span", "one gang member process's step body"),
    "flow.member_failed": (
        "event",
        "gang supervisor: first non-zero member exit (member, rc, log "
        "tail, flight dump); surviving peers are killed promptly",
    ),
    "flow.preempt": (
        "event",
        "a gang member exited with the requeue code after a preemption "
        "drain; the step reruns without consuming the retry budget",
    ),
    "flow.heartbeat_stall": (
        "event",
        "gang supervisor: a member's heartbeat went silent past the stall "
        "timeout (member, age_s, last_step: heartbeats stamp the current "
        "step, so the report says where the member stalled); the gang is "
        "killed",
    ),
    # Elastic gang: a member loss becomes a mesh resize at a step fence.
    "flow.member_lost": (
        "event",
        "elastic supervisor: a gang member died (member, rc, log tail, "
        "flight, survivor count) and the gang SHRINKS over the survivors "
        "instead of failing the step (contrast flow.member_failed)",
    ),
    "flow.gang_resize": (
        "span",
        "one mesh re-form, announce -> every roster member joined the new "
        "generation (generation, reason shrink|grow, from/to member "
        "counts)",
    ),
    # --------------------------------------------------------------- train
    "train.report": ("event", "one TrainContext.report: step + metrics"),
    # -------------------------------------------------------------- health
    "health.loss": ("gauge", "per-step train loss (fenced host copy)"),
    "health.grad_norm": (
        "gauge",
        "pre-clip global gradient norm of the fenced step (spikes predict "
        "divergence; ~0 flags dead gradients)",
    ),
    "health.update_norm": (
        "gauge",
        "global norm of the applied parameter update (post-optimizer)",
    ),
    "health.param_norm": (
        "gauge",
        "global parameter norm after the step (drift/blowup evidence)",
    ),
    "health.nonfinite": (
        "counter",
        "steps whose on-device NaN/Inf flag fired (loss or grads)",
    ),
    "health.anomaly": (
        "event",
        "HealthMonitor detection: nonfinite streak, grad explosion, or "
        "median+MAD loss spike (detector, step, detector detail)",
    ),
    "health.rollback": (
        "event",
        "divergence auto-rollback: restored the newest crc-verified "
        "checkpoint step (from_step -> step, lr_scale when backed off)",
    ),
    "health.profile": (
        "event",
        "windowed torch.profiler capture committed (profile=(start, "
        "stop)): step window + trace directory",
    ),
    # ---------------------------------------------------------------- ckpt
    "ckpt.corrupt": (
        "event",
        "a shard failed crc32/truncation verification; restore fell back "
        "to the next tier / previous committed step or raised — never "
        "silent",
    ),
    "ckpt.io_retry": (
        "event",
        "one transient storage error absorbed by the retrying I/O wrapper "
        "(op, path, attempt, jittered backoff slept)",
    ),
    "ckpt.io_error": (
        "event",
        "a storage operation failed for good: permanent errno or retry "
        "budget exhausted (raises CheckpointIOError)",
    ),
    "ckpt.save_failed": (
        "event",
        "one step's save died on a classified storage error after "
        "retries: staging reclaimed, history entry dropped, training "
        "continues on the previous committed step — never a member death",
    ),
    "ckpt.gc": (
        "event",
        "manager startup reclaimed killed-writer leftovers: staged .tmp "
        "dirs, uncommitted step dirs, stale local-tier staging/overflow",
    ),
    "ckpt.upload": (
        "span",
        "local fast tier → persistent run dir copy of one committed step "
        "(on the saver thread); ok=False means the step is durable "
        "locally only",
    ),
    "ckpt.restore_tier": (
        "event",
        "which tier served a restore (local | persistent) for which step "
        "— the fallback-ladder evidence trail",
    ),
    "ckpt.emergency_save": (
        "event",
        "last-chance synchronous commit on the fastest tier inside a "
        "closing preemption-grace window (upload skipped); the requeued "
        "attempt resumes from this step",
    ),
    # ----------------------------------------------------------------- obs
    "obs.dropped": (
        "event",
        "telemetry events lost by this recorder (buffer overflow or a "
        "failed flush), surfaced once at close — never silently",
    ),
    "obs.flight": (
        "event",
        "a crash-forensics flight dump was written (reason + path): the "
        "bounded ring of recent events, the launch fingerprint and the "
        "faulting stack — referenced from the supervisor's "
        "flow.member_failed event",
    ),
    # ----------------------------------------------------------- serve
    "serve.admit": (
        "event",
        "a queued request entered a free slot (request, slot, bucket, "
        "queue_wait_s)",
    ),
    "serve.trace": (
        "event",
        "one request-lifecycle transition (request, phase=submitted|"
        "queued|kv_fallback|admitted|first_token|complete, plus the "
        "phase's evidence: backpressure reason, bucket/pages, the "
        "admission mode and its shipped/promoted pages, ttft_s, finish "
        "reason)",
    ),
    "serve.page_evict": (
        "event",
        "pool pressure reclaimed an idle (refcount-0) prefix-cache page "
        "LRU-first; its cached prefix must be recomputed on next use",
    ),
    "serve.kv_ship": (
        "span",
        "prefill-role export: chunked prefill + page extraction + the "
        "atomic kv_store commit of one KVPageSet (prompt_len, pages, key) — "
        "the prefill half of a disaggregated admission",
    ),
    "serve.kv_import": (
        "span",
        "decode-role import: load + validate a committed KVPageSet at "
        "submit (ok=False = torn/missing/mismatched set → the request rides "
        "local prefill; the fallback evidence the chaos tests assert)",
    ),
    "serve.tier_hit": (
        "event",
        "a prompt's prefix-digest chain matched pages in a lower tier "
        "(host/disk counts); the pages promote back into the HBM pool "
        "instead of being recomputed by prefill",
    ),
    "serve.tier_promote": (
        "event",
        "tier-hit pages were written back into the HBM pool for an "
        "admission (pages, and whether prefill was skipped entirely)",
    ),
    "serve.tier_spill": (
        "event",
        "an evicted prefix page's content dropped to a lower tier "
        "(tier=host|disk) instead of being forgotten — still findable "
        "through the bounded digest→tier index",
    ),
    # ---------------------------------------------------------------- dist
    "dist.mesh_generation": (
        "gauge",
        "the mesh generation this member formed (elastic gang: 0 at "
        "launch, one more at every shrink or grow; members and reason)",
    ),
}


def kind_of(name: str) -> str:
    """Registered kind of ``name``; raises KeyError for unknown names."""
    return CATALOG[name][0]


def is_registered(name: str) -> bool:
    return name in CATALOG
