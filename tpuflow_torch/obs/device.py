"""Device observatory (counterpart of ``tpuflow/obs/device.py``): what the
card runs, what it costs, and what its memory is doing.

- **Program ledger.** :class:`ProgramLedger` records one entry per
  program into a ``programs.json`` run artifact (merged by name across
  writers) plus a ``device.program`` event per entry. The JAX package's
  programs are compiled XLA executables with their cost and memory
  analyses; the port compiles no graph, so its programs are what it
  builds and runs:

  - the kernel libraries ``ops/_build.py`` compiles (``kernel.<name>``,
    ``compile_s`` = the seconds this process spent in ``nvcc`` for it, 0
    when the library was already built);
  - the train step and the serving engine's prefill / decode / verify /
    insert signatures, each with its FLOP estimate (``flops``), the wall
    of its first fenced run (``compile_s``: kernel builds, cuBLAS and
    allocator warm-up), and on the card the allocator's bytes before
    that run (``argument_bytes``), its peak after it (``peak_bytes``)
    and their difference (``temp_bytes``). The peak is the process's
    allocator peak, never reset here, so ``temp_bytes`` is an upper
    bound on the run's transient bytes (exact when the run set the
    peak). Off the card the memory keys are absent, never invented.

- **Memory gauges.** :func:`maybe_emit_hbm` reads the card's allocator
  (``torch.cuda.memory_stats``) and its capacity
  (``torch.cuda.mem_get_info``) at the fences ``StepClock`` and
  ``ServeEngine`` already pay, throttled by its ``poll_s`` argument (the
  JAX package's ``TPUFLOW_DEVICE_POLL_S``): ``device.hbm_used`` /
  ``device.hbm_peak`` / ``device.hbm_limit`` gauges in the event stream
  and the live ``/metrics`` + ``/status`` export (``tpuflow_hbm_*``). Off
  the card the poller disables itself after the first probe.

- **Static budget check.** :meth:`ProgramLedger.budget_check` sums the
  recorded programs' ``temp_bytes`` + ``argument_bytes`` against the
  card's capacity and records a ``device.hbm_budget`` event. The sum
  counts bytes shared between programs (the parameters) once a program,
  so the check can only warn early.

Consumers: ``device_summary(run_dir)`` (file reads only), the timeline
card's Device section (``flow/cards.py``) and the live export.
"""

from __future__ import annotations

import importlib
import json
import os
import time
from typing import Any

# The recorder submodule, not the package's ``recorder()`` accessor that
# shadows it once ``tpuflow_torch.obs`` is initialised.
_rec = importlib.import_module("tpuflow_torch.obs.recorder")

PROGRAMS_NAME = "programs.json"
# The default poll cadence of the memory gauges, seconds (the JAX
# package's ``TPUFLOW_DEVICE_POLL_S`` default); 0 disables them.
DEFAULT_POLL_S = 10.0

# Budget-check warn threshold: resident program bytes above this
# fraction of the card's capacity are flagged. Below 1.0 on purpose:
# allocations in flight ride on top of the static footprint.
BUDGET_WARN_FRAC = 0.9

_WARNED: set[str] = set()


def _warn_once(key: str, msg: str) -> None:
    """A note printed once a process (a backend that answers nothing must
    not print one line a fence)."""
    if key not in _WARNED:
        _WARNED.add(key)
        print(f"[tpuflow_torch] {msg}")


# -------------------------------------------------------- program ledger
class ProgramLedger:
    """Per-run ledger of program footprints. Entries merge by program
    NAME, and ``write()`` merges with whatever an earlier writer already
    persisted, so one ``programs.json`` accumulates the run's whole
    inventory."""

    def __init__(self, source: str = "run"):
        self.source = source
        self._by_name: dict[str, dict] = {}
        self.budget: dict[str, Any] | None = None

    @property
    def programs(self) -> list[dict]:
        return list(self._by_name.values())

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def note_entry(self, entry: dict) -> dict:
        """Record (or enrich) one entry and emit its ``device.program``
        event (``name`` becomes ``program``: the record's ``name`` is the
        catalog name)."""
        name = str(entry.get("name", "?"))
        merged = self._by_name.setdefault(name, {"name": name})
        merged.update({k: v for k, v in entry.items() if v is not None})
        merged.setdefault("source", self.source)
        attrs = {k: v for k, v in merged.items() if k != "name"}
        _rec.event("device.program", program=name, **attrs)
        return merged

    def resident_bytes(self) -> int:
        """The recorded inventory's static claim: temp + argument bytes
        summed over programs (shared bytes counted once a program: an
        upper bound that can only warn early)."""
        return sum(int(e.get("temp_bytes", 0))
                   + int(e.get("argument_bytes", 0))
                   for e in self._by_name.values())

    def budget_check(self, bytes_limit: int | None = None, *,
                     devices=None) -> dict[str, Any]:
        """Static memory budget verdict, recorded as a
        ``device.hbm_budget`` event. ``bytes_limit`` defaults to the
        card's capacity (``hbm_snapshot``); without a card the verdict
        carries the resident bytes only (no ratio)."""
        if bytes_limit is None:
            snap = hbm_snapshot(devices)
            if snap is not None:
                bytes_limit = snap.get("limit")
        resident = self.resident_bytes()
        verdict: dict[str, Any] = {"resident_bytes": resident,
                                   "programs": len(self._by_name)}
        if bytes_limit:
            frac = resident / float(bytes_limit)
            verdict["bytes_limit"] = int(bytes_limit)
            verdict["resident_frac"] = round(frac, 4)
            verdict["over"] = frac > BUDGET_WARN_FRAC
            if verdict["over"]:
                print(f"[tpuflow_torch] device ledger: static program "
                      f"residency {resident / 2**30:.2f} GiB is "
                      f"{100.0 * frac:.0f}% of the card's "
                      f"{bytes_limit / 2**30:.2f} GiB: expect allocation "
                      f"pressure or an out-of-memory error")
        _rec.event("device.hbm_budget", **verdict)
        self.budget = verdict
        return verdict

    def write(self, path: str | None = None) -> str | None:
        """Persist the ledger as ``programs.json``, merged by name with an
        existing file. Default location: beside the recorder's event
        files; with telemetry off and no ``path``, a no-op returning
        None. Written to a temporary file and renamed, so a reader never
        sees a torn artifact; a failed write is printed, never raised."""
        if path is None:
            rec = _rec.recorder()
            if rec is None:
                return None
            path = os.path.join(rec.directory, PROGRAMS_NAME)
        existing: dict[str, dict] = {}
        budget = self.budget
        try:
            with open(path) as f:
                prior = json.load(f)
            for e in prior.get("programs", []):
                if isinstance(e, dict) and e.get("name"):
                    existing[str(e["name"])] = e
            if budget is None and isinstance(prior.get("budget"), dict):
                budget = prior["budget"]
        except (OSError, ValueError):
            pass
        for name, e in self._by_name.items():
            merged = existing.setdefault(name, {"name": name})
            merged.update({k: v for k, v in e.items() if v is not None})
        record: dict[str, Any] = {
            "written_ts": time.time(),
            "source": self.source,
            "programs": sorted(existing.values(),
                               key=lambda e: e.get("name", "")),
        }
        if budget is not None:
            record["budget"] = budget
        try:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(record, f, indent=1)
            os.replace(tmp, path)
        except OSError as e:
            print(f"[tpuflow_torch] device ledger write failed (ignored): "
                  f"{e}")
            return None
        return path


def kernel_entries() -> list[dict]:
    """One ledger entry a kernel library this process loaded:
    ``kernel.<name>`` with the seconds this process spent building it."""
    from tpuflow_torch.ops import _build

    return [{"name": f"kernel.{n}",
             "compile_s": round(_build.BUILT.get(n, 0.0), 4),
             "library": os.path.basename(_build.library_path(n)),
             "source": "build"}
            for n in sorted(_build._LIBS)]


def allocated_bytes(device=None) -> int | None:
    """The card allocator's bytes in use (None off the card): the
    ``argument_bytes`` mark a program's first run starts from."""
    dev = _card(device)
    if dev is None:
        return None
    import torch

    return int(torch.cuda.memory_allocated(dev))


def program_entry(name: str, *, run_s: float | None = None,
                  flops: float | None = None,
                  argument_bytes: int | None = None, device=None,
                  source: str | None = None) -> dict[str, Any]:
    """One program's entry after its first fenced run: its wall
    (``compile_s``), its FLOP estimate, and on the card the memory marks
    of the module docstring (``argument_bytes`` taken by the caller with
    ``allocated_bytes()`` before the run)."""
    entry: dict[str, Any] = {"name": str(name)}
    if run_s is not None:
        entry["compile_s"] = round(float(run_s), 4)
    if flops is not None:
        entry["flops"] = float(flops)
    if source:
        entry["source"] = source
    dev = _card(device)
    if dev is not None and argument_bytes is not None:
        import torch

        peak = int(torch.cuda.max_memory_allocated(dev))
        entry.update(argument_bytes=int(argument_bytes), peak_bytes=peak,
                     temp_bytes=max(peak - int(argument_bytes), 0))
    return entry


def note_program(name: str, *, run_s: float | None = None,
                 flops: float | None = None,
                 argument_bytes: int | None = None, device=None,
                 source: str = "train", ledger: bool = True,
                 kernels: bool = True) -> dict | None:
    """Record one program at its first fence into ``programs.json`` (the
    JAX package's ``note_jit_program``), with the kernel libraries loaded
    so far when ``kernels``. Gated as there: the recorder must be on, and
    ``ledger`` (its ``TPUFLOW_DEVICE_LEDGER``) true. Never raises into
    the loop."""
    if not (_rec.enabled() and ledger):
        return None
    try:
        book = ProgramLedger(source=source)
        entry = book.note_entry(program_entry(
            name, run_s=run_s, flops=flops, argument_bytes=argument_bytes,
            device=device, source=source))
        if kernels:
            for k in kernel_entries():
                book.note_entry(k)
        book.write()
        return entry
    except Exception as e:  # telemetry never fails a run
        _warn_once(f"note:{name}", f"device ledger: {name!r} not recorded "
                   f"({e!r})")
        return None


# ------------------------------------------------------- memory gauges
def _card(device=None):
    """The card ``device`` names (default: this process's current card),
    or None off the card."""
    try:
        import torch

        if device is not None:
            d = torch.device(device)
            return d if d.type == "cuda" else None
        if not torch.cuda.is_available():
            return None
        return torch.device("cuda", torch.cuda.current_device())
    except Exception:
        return None


class _Card:
    """One card's readings, as ``hbm_snapshot`` asks them of a device
    (tests inject objects with the same two methods)."""

    def __init__(self, dev):
        self.dev = dev

    def memory_stats(self) -> dict:
        import torch

        return torch.cuda.memory_stats(self.dev)

    def mem_get_info(self) -> tuple[int, int]:
        import torch

        return torch.cuda.mem_get_info(self.dev)


def hbm_snapshot(devices=None) -> dict[str, Any] | None:
    """One reading of the cards' memory: ``{devices, used, peak, limit}``
    (the JAX function's keys). ``used`` is the allocator's bytes in use
    (``allocated_bytes.all.current``: ``torch.cuda.memory_allocated``),
    ``peak`` its peak (``allocated_bytes.all.peak``:
    ``torch.cuda.max_memory_allocated``), ``limit`` the card's capacity
    (``mem_get_info``'s total); ``used``/``peak`` the max over devices and
    ``limit`` the min, each key present only when a device reported it.
    ``devices``: objects with ``memory_stats()`` and ``mem_get_info()``
    (default: this process's card, and only it). None off the card."""
    if devices is None:
        dev = _card()
        if dev is None:
            return None
        devices = [_Card(dev)]
    used = peak = limit = None
    n = 0
    for d in devices:
        try:
            stats = d.memory_stats()
        except Exception:
            stats = None
        if not stats:
            continue
        n += 1
        u = stats.get("allocated_bytes.all.current")
        if isinstance(u, (int, float)):
            used = int(u) if used is None else max(used, int(u))
        p = stats.get("allocated_bytes.all.peak")
        if isinstance(p, (int, float)):
            peak = int(p) if peak is None else max(peak, int(p))
        try:
            total = int(d.mem_get_info()[1])
        except Exception:
            total = None
        if total:
            limit = total if limit is None else min(limit, total)
    if n == 0:
        return None
    out: dict[str, Any] = {"devices": n}
    if used is not None:
        out["used"] = used
    if peak is not None:
        out["peak"] = peak
    if limit is not None:
        out["limit"] = limit
    return out


def emit_hbm(snap: dict) -> None:
    """Record one snapshot as gauges and feed the live process ledger
    (the ``/metrics`` ``tpuflow_hbm_*`` rows)."""
    from tpuflow_torch.obs import goodput as _goodput

    used, peak, limit = snap.get("used"), snap.get("peak"), snap.get("limit")
    if used is not None:
        _rec.gauge("device.hbm_used", used)
    if peak is not None:
        _rec.gauge("device.hbm_peak", peak)
    if limit is not None:
        _rec.gauge("device.hbm_limit", limit)
    _goodput.live().note_device_hbm(used, peak, limit)


# Poller state: one monotonic compare while the interval has not
# elapsed, one bool check forever after the first probe off the card.
_POLL_NEXT = 0.0
_POLL_OFF = False


def maybe_emit_hbm(force: bool = False, devices=None,
                   poll_s: float = DEFAULT_POLL_S) -> dict | None:
    """Throttled memory poll for the ``StepClock`` / ``ServeEngine``
    fences: at most one reading every ``poll_s`` seconds (0 disables;
    ``force`` reads now). Disables itself after the first probe off the
    card."""
    global _POLL_NEXT, _POLL_OFF
    if _POLL_OFF and not force:
        return None
    now = time.monotonic()
    if not force and now < _POLL_NEXT:
        return None
    if poll_s <= 0 and not force:
        return None
    _POLL_NEXT = now + max(float(poll_s), 0.0)
    snap = hbm_snapshot(devices)
    if snap is None:
        _POLL_OFF = True
        _warn_once("hbm_off", "device observatory: no card's memory to "
                   "read; memory gauges disabled (keys absent, never "
                   "invented)")
        return None
    _POLL_OFF = False
    emit_hbm(snap)
    return snap


def reset_poller() -> None:
    """Forget the poller's schedule and its off-card verdict (a test, or
    a process that moves onto a card)."""
    global _POLL_NEXT, _POLL_OFF
    _POLL_NEXT = 0.0
    _POLL_OFF = False
    _WARNED.clear()


# ------------------------------------------------------- reading a run
def load_programs(run_dir: str) -> dict | None:
    """The run's ``programs.json`` (under ``<run_dir>/obs/`` or the run
    root), or None."""
    from tpuflow_torch.obs.timeline import OBS_SUBDIR

    for candidate in (os.path.join(run_dir, OBS_SUBDIR, PROGRAMS_NAME),
                      os.path.join(run_dir, PROGRAMS_NAME)):
        try:
            with open(candidate) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(rec, dict) and isinstance(rec.get("programs"), list):
            rec["path"] = candidate
            return rec
    return None


def device_summary(run_dir: str) -> dict[str, Any]:
    """The run's device evidence in one dict: ``programs.json``, the last
    ``device.hbm_*`` gauges (and the used/peak maxima), budget verdicts
    and ``prof.capture`` events. File reads only."""
    from tpuflow_torch.obs.timeline import load_run_events

    out: dict[str, Any] = {}
    ledger = load_programs(run_dir)
    if ledger:
        out["programs_path"] = ledger.get("path")
        out["programs"] = ledger["programs"]
        if isinstance(ledger.get("budget"), dict):
            out["budget"] = ledger["budget"]
    hbm: dict[str, float] = {}
    captures: list[dict] = []
    for ev in load_run_events(run_dir):
        kind, name = ev.get("kind"), ev.get("name", "")
        if kind == "gauge" and name in ("device.hbm_used", "device.hbm_peak",
                                        "device.hbm_limit"):
            try:
                key = name[len("device."):]
                v = float(ev.get("value", 0.0))
                hbm[key] = v
                if key != "hbm_limit":
                    hbm[f"{key}_max"] = max(hbm.get(f"{key}_max", 0.0), v)
            except (TypeError, ValueError):
                pass
        elif kind == "event" and name == "prof.capture":
            captures.append({k: v for k, v in ev.items()
                             if k not in ("kind", "name", "pid")})
        elif kind == "event" and name == "device.hbm_budget":
            out.setdefault("budget", {
                k: v for k, v in ev.items()
                if k not in ("kind", "name", "ts", "proc", "pid", "launch")})
    if hbm:
        out["hbm"] = hbm
    if captures:
        out["captures"] = captures
    return out


def summarize_entry(e: dict) -> str:
    """One human table line for a ``programs.json`` entry (the
    ``device-summary`` command's)."""

    def _fmt_bytes(v):
        return "-" if v is None else f"{v / 2**20:9.2f}"

    flops = e.get("flops")
    return (
        f"  {e.get('name', '?'):<16} "
        f"{e.get('compile_s', '-')!s:>9}  "
        f"{'-' if flops is None else f'{flops:.3g}':>10}  "
        f"{_fmt_bytes(e.get('argument_bytes')):>9}  "
        f"{_fmt_bytes(e.get('output_bytes')):>9}  "
        f"{_fmt_bytes(e.get('temp_bytes')):>9}"
    )
