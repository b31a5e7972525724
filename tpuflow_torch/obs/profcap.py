"""Anomaly-triggered profiler capture (counterpart of
``tpuflow/obs/profcap.py``): the detector-armed twin of the static
profile window (``obs/health.py::ProfileWindow``, ``train_gpt(profile=)``).

:class:`AnomalyCapturer` watches the observations the loops already
produce and arms a **bounded** ``torch.profiler`` trace (CUDA activity
included on the card) plus a device-memory snapshot the moment one
spikes:

- **Step-time detector**: a rolling median+MAD spike test over fenced
  train-step wall times (the spike never joins its own baseline).
- **ITL detector**: the same test over the serving engine's per-token
  decode latencies.
- **Direct triggers**: a declared-SLO breach and a nonfinite train step
  each arm a capture at once.

**Governor**: at most one capture in flight, a cooldown between
captures, a per-run cap. A trace spans the next ``trace_steps``
observations (with a hard wall bound), then stops, writes its chrome
trace and dumps ``device_memory.pickle`` (``torch.cuda.memory.
_dump_snapshot``) beside it. Every capture is a ``prof.capture`` event
naming the artifact directory.

The JAX package arms the capturer with ``TPUFLOW_PROF_TRIGGER`` and tunes
it with ``TPUFLOW_PROF_*``; here a :class:`CaptureConfig` (or a built
capturer) is an argument of ``train_gpt``, ``StepClock`` and
``ServeEngine``. Every profiler call is fenced: a failing tracer is
counted, printed once and disables capture for the run, never raising
into the loop. Disarmed (None, the default) a loop pays one ``is not
None`` check an observation.
"""

from __future__ import annotations

import collections
import dataclasses
import importlib
import os
import statistics
import time
from typing import Any

# The recorder submodule, not the package's ``recorder()`` accessor that
# shadows it once ``tpuflow_torch.obs`` is initialised.
_rec = importlib.import_module("tpuflow_torch.obs.recorder")

MEMORY_SNAPSHOT = "device_memory.pickle"


@dataclasses.dataclass
class CaptureConfig:
    """The capture policy (the JAX package's ``TPUFLOW_PROF_ZMADS``,
    ``_COOLDOWN_S``, ``_MAX_CAPTURES``, ``_TRACE_STEPS`` and ``_DIR``,
    with its defaults). ``out_dir`` None: ``<obs dir>/profile`` of the
    configured recorder."""

    z_mads: float = 8.0
    cooldown_s: float = 300.0
    max_captures: int = 3
    trace_steps: int = 2
    window: int = 64
    warmup: int = 16
    # Hard wall bound on one capture: a path that stops producing
    # observations must not leave the profiler running for the run.
    max_trace_s: float = 60.0
    out_dir: str | None = None


class TorchTracer:
    """The capture backend: ``torch.profiler`` with CUDA activity when
    ``cuda`` (None: when a card is present), the chrome trace written into
    the capture's directory at ``stop`` (as ``name``, default
    ``trace.pid<pid>.json``); the static profile window traces through it
    too, and tests inject a fake with the same three methods."""

    def __init__(self, cuda: bool | None = None):
        self.cuda = cuda
        self._prof = None
        self._dir: str | None = None
        self.trace_path: str | None = None

    def start(self, out_dir: str) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.cuda or (self.cuda is None and torch.cuda.is_available()):
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(out_dir, exist_ok=True)
        prof = profile(activities=acts)
        prof.start()
        self._prof, self._dir = prof, out_dir

    def stop(self, name: str | None = None) -> None:
        prof, self._prof = self._prof, None
        if prof is None:
            return
        prof.stop()
        self.trace_path = os.path.join(
            self._dir, name or f"trace.pid{os.getpid()}.json")
        prof.export_chrome_trace(self.trace_path)

    def memdump(self, path: str) -> None:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("no card: no device memory snapshot")
        torch.cuda.memory._dump_snapshot(path)


class AnomalyCapturer:
    """Detector + governor + bounded capture, one instance a run.

    Feed it observations (``observe_step`` / ``observe_itl``) and direct
    triggers (``note_slo_breach`` / ``note_nonfinite``); it decides when a
    bounded capture is warranted and owns its lifecycle. ``tracer``
    (default :class:`TorchTracer`) and ``clock`` are injectable."""

    def __init__(self, out_dir: str, cfg: CaptureConfig | None = None, *,
                 tracer=None, clock=time.monotonic):
        self.cfg = cfg or CaptureConfig()
        self.out_dir = out_dir
        self._tracer = tracer or TorchTracer()
        self._clock = clock
        self._step_window: collections.deque = collections.deque(
            maxlen=self.cfg.window)
        self._itl_window: collections.deque = collections.deque(
            maxlen=self.cfg.window)
        self.captures = 0
        self.suppressed = 0
        # Tracer calls that raised (start, stop): counted and printed,
        # never raised into the loop.
        self.tracer_errors = 0
        self.records: list[dict] = []  # the prof.capture payloads
        self._last_capture_t: float | None = None
        self._active: dict[str, Any] | None = None
        self._broken = False

    # ----------------------------------------------------------- detectors
    def _judge(self, window, v: float) -> float | None:
        """Median+MAD spike test: the threshold when ``v`` spikes, None
        otherwise. The sigma floor keeps a flat window from branding
        jitter an anomaly."""
        if len(window) < self.cfg.warmup:
            return None
        med = statistics.median(window)
        mad = statistics.median(abs(x - med) for x in window)
        sigma = max(1.4826 * mad, 0.01 * abs(med), 1e-9)
        threshold = med + self.cfg.z_mads * sigma
        return threshold if v > threshold else None

    def observe_step(self, dur_s: float, step: int | None = None) -> None:
        """One fenced train step's wall time. While a capture is live this
        only advances its bound."""
        if self._active is not None:
            self._advance()
            return
        threshold = self._judge(self._step_window, dur_s)
        if threshold is not None:
            # The spike stays out of the window: a pre-spike baseline.
            self.trigger("step_time", value=round(float(dur_s), 6),
                         threshold=round(threshold, 6), step=step)
        else:
            self._step_window.append(float(dur_s))

    def observe_itl(self, itl_s: float) -> None:
        """One decode tick's per-token latency (the serving twin)."""
        if self._active is not None:
            self._advance()
            return
        threshold = self._judge(self._itl_window, itl_s)
        if threshold is not None:
            self.trigger("itl", value=round(float(itl_s), 6),
                         threshold=round(threshold, 6))
        else:
            self._itl_window.append(float(itl_s))

    def note_slo_breach(self, kind: str) -> None:
        """A declared-SLO violation (ttft | itl): a direct trigger."""
        if self._active is not None:
            return
        self.trigger(f"slo_{kind}")

    def note_nonfinite(self, step: int | None = None) -> None:
        """A nonfinite train step: a direct trigger (the trace shows what
        the card did when the numerics went bad)."""
        if self._active is not None:
            return
        self.trigger("nonfinite", step=step)

    # ------------------------------------------------------------ governor
    def trigger(self, reason: str, **detail) -> bool:
        """Arm one bounded capture, subject to the governor (no concurrent
        capture, the cooldown, the cap; suppressions are counted).
        Returns whether a capture started."""
        if self._broken:
            return False
        if self._active is not None or self.captures >= self.cfg.max_captures:
            self.suppressed += 1
            return False
        now = self._clock()
        if (self._last_capture_t is not None
                and now - self._last_capture_t < self.cfg.cooldown_s):
            self.suppressed += 1
            return False
        cap_dir = os.path.join(self.out_dir,
                               f"capture_{self.captures + 1:02d}_{reason}")
        try:
            self._tracer.start(cap_dir)
        except Exception as e:
            # A broken tracer must not re-fail every later trigger, and
            # never fails the run: capture is off for good.
            self._broken = True
            self.tracer_errors += 1
            print("[tpuflow_torch] triggered profiler capture failed to "
                  f"start (capture disabled for this run): {e!r}")
            return False
        self.captures += 1
        self._last_capture_t = now
        self._active = {
            "reason": reason, "dir": cap_dir,
            "remaining": max(1, self.cfg.trace_steps),
            "deadline": now + self.cfg.max_trace_s,
            "detail": {k: v for k, v in detail.items() if v is not None},
            "t0": now,
        }
        return True

    def _advance(self) -> None:
        a = self._active
        a["remaining"] -= 1
        if a["remaining"] <= 0 or self._clock() > a["deadline"]:
            self._finish()

    def poll(self) -> None:
        """Deadline check for loops between observations: finishes a
        wall-expired capture."""
        if self._active is not None and self._clock() > self._active[
                "deadline"]:
            self._finish()

    def _finish(self) -> None:
        a, self._active = self._active, None
        try:
            self._tracer.stop()
        except Exception as e:
            self._broken = True
            self.tracer_errors += 1
            print(f"[tpuflow_torch] profiler trace stop failed (ignored): "
                  f"{e!r}")
        mem_path: str | None = os.path.join(a["dir"], MEMORY_SNAPSHOT)
        try:
            self._tracer.memdump(mem_path)
        except Exception:
            # Off the card there is no device memory: the trace alone
            # is the artifact.
            mem_path = None
        payload = dict(reason=a["reason"], dir=a["dir"],
                       capture=self.captures,
                       dur_s=round(self._clock() - a["t0"], 4),
                       memory_profile=mem_path,
                       suppressed_so_far=self.suppressed, **a["detail"])
        self.records.append(payload)
        _rec.event("prof.capture", **payload)

    def close(self) -> None:
        """End of run: an in-flight capture must not leave the profiler
        running."""
        if self._active is not None:
            self._finish()


def make_capturer(capture) -> AnomalyCapturer | None:
    """The capturer an entry point's ``capture=`` argument asks for: an
    ``AnomalyCapturer`` as given, a ``CaptureConfig`` (or True, the
    defaults) built into one writing to its ``out_dir`` or else the
    configured recorder's ``profile/`` directory; None when ``capture``
    is None or False, or when there is nowhere to write (printed)."""
    if capture is None or capture is False:
        return None
    if isinstance(capture, AnomalyCapturer):
        return capture
    cfg = CaptureConfig() if capture is True else capture
    out_dir = cfg.out_dir
    if not out_dir:
        rec = _rec.recorder()
        if rec is not None:
            out_dir = os.path.join(rec.directory, "profile")
    if not out_dir:
        print("[tpuflow_torch] anomaly capture asked for, but no obs "
              "recorder is configured and no out_dir was given; capture "
              "disabled")
        return None
    return AnomalyCapturer(out_dir, cfg)
