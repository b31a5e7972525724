"""The port's device observatory (``tpuflow_torch/obs/device.py``,
``obs/profcap.py``) against the JAX package's (``tpuflow/obs/device.py``,
``profcap.py``; oracle ``tests/test_device_obs.py``).

- ``hbm_snapshot`` reads the card allocator's ``memory_stats`` and
  ``mem_get_info``; fed the same numbers through injected devices it
  gives the JAX function's dict, equal (exact), and None on the CPU.
- ``maybe_emit_hbm`` emits the same gauges and feeds the same live
  ledger keys; it disables itself off the card.
- ``ProgramLedger``: the same entries give the same ``programs.json``
  programs and budget verdict, and the same ``device.program`` /
  ``device.hbm_budget`` events, key for key (exact).
- ``AnomalyCapturer``: fed one step / ITL / trigger sequence with a fake
  tracer (the JAX tests' sequences and a seeded one), both packages take
  the same decisions: captures, suppressions, trace starts, stops, dumps
  and ``prof.capture`` payloads, exact. A broken tracer is counted and
  printed, never raised.
- The port's own paths: ``note_program``'s gates, the real
  ``torch.profiler`` tracer on the CPU, a nonfinite ``train_gpt`` step
  arming one capture, and the serving engine's program ledger.
"""

import glob
import json
import os

import numpy as np
import pytest

from torch_parity import one_torch_thread  # noqa: F401
from tpuflow import obs as jobs
from tpuflow.obs import device as jdev
from tpuflow.obs import goodput as jgp
from tpuflow.obs import profcap as jcap
from tpuflow_torch import obs as tobs
from tpuflow_torch.obs import device as tdev
from tpuflow_torch.obs import goodput as tgp
from tpuflow_torch.obs import profcap as tcap

VOLATILE = ("ts", "pid", "dur_s")


@pytest.fixture(autouse=True)
def reset_state(monkeypatch):
    monkeypatch.delenv("TPUFLOW_DEVICE_LEDGER", raising=False)
    for o in (jobs, tobs):
        o.configure(None)
    jdev._reset_for_tests()
    jcap._reset_for_tests()
    tdev.reset_poller()
    yield
    for o in (jobs, tobs):
        o.configure(None)
    jdev._reset_for_tests()
    tdev.reset_poller()


def _events(o, d, *names):
    o.flush()
    return [{k: v for k, v in e.items() if k not in VOLATILE}
            for p in sorted(glob.glob(os.path.join(d, "events.p*.jsonl")))
            for e in o.read_events(p) if not names or e["name"] in names]


class _JaxDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        if isinstance(self._stats, Exception):
            raise self._stats
        return self._stats


class _TorchDevice:
    """An injected card: the allocator's stats and the capacity."""

    def __init__(self, stats, total=None):
        self._stats, self._total = stats, total

    def memory_stats(self):
        if isinstance(self._stats, Exception):
            raise self._stats
        return self._stats

    def mem_get_info(self):
        if self._total is None:
            raise RuntimeError("no capacity")
        return (0, self._total)


def _pair(used=None, peak=None, limit=None, raises=False):
    """One reading as a JAX device and as a card."""
    if raises:
        return _JaxDevice(RuntimeError("x")), _TorchDevice(RuntimeError("x"))
    if used is None and peak is None and limit is None:
        return _JaxDevice(None), _TorchDevice({})
    j, t = {}, {}
    if used is not None:
        j["bytes_in_use"] = t["allocated_bytes.all.current"] = used
    if peak is not None:
        j["peak_bytes_in_use"] = t["allocated_bytes.all.peak"] = peak
    if limit is not None:
        j["bytes_limit"] = limit
    return _JaxDevice(j), _TorchDevice(t, limit)


@pytest.mark.parametrize("readings", [
    [(100, 150, 1000), (300, 120, 900), None, "raise"],
    [None], ["raise"], [(5, None, None)], [(7, 9, 64)],
], ids=["four", "silent", "raising", "partial", "one"])
def test_hbm_snapshot_gives_the_jax_keys(readings):
    jd, td = [], []
    for r in readings:
        j, t = (_pair(raises=True) if r == "raise"
                else _pair(*r) if r else _pair())
        jd.append(j)
        td.append(t)
    assert tdev.hbm_snapshot(td) == jdev.hbm_snapshot(jd)


def test_hbm_snapshot_is_none_on_the_cpu():
    assert tdev.hbm_snapshot() is None
    assert tdev.allocated_bytes() is None
    assert tdev.maybe_emit_hbm(force=True) is None
    assert tdev._POLL_OFF  # off the card the poller disables itself


def test_emit_hbm_gauges_and_live_keys_match(tmp_path, monkeypatch):
    """The same reading through both pollers: the same three gauges and
    the same ``hbm_*`` keys in the live ledger's snapshot; an immediate
    second poll is throttled in both."""
    jd, td = _pair(600, 800, 1000)
    out = {}
    for name, o, dev, gp, devs in (("jax", jobs, jdev, jgp, [jd]),
                                   ("port", tobs, tdev, tgp, [td])):
        d = str(tmp_path / name)
        o.configure(d, proc=0)
        led = gp.ProcessLedger()
        monkeypatch.setattr(gp, "_LEDGER", led)
        snap = dev.maybe_emit_hbm(force=True, devices=devs)
        assert dev.maybe_emit_hbm(devices=devs) is None
        o.configure(None)
        keys = {k: v for k, v in led.snapshot().items()
                if k.startswith("hbm_")}
        out[name] = (snap, _events(o, d), keys)
    assert out["port"] == out["jax"]
    assert out["port"][2]["hbm_used_bytes"] == 600


def _ledger_drive(dev, o, d, path):
    """One merge-and-budget sequence (the JAX test's numbers)."""
    o.configure(d, proc=0)
    led = dev.ProgramLedger(source="warmup")
    led.note_entry({"name": "decode", "compile_s": 1.25})
    led.write(path)
    led2 = dev.ProgramLedger(source="serve")
    led2.note_entry({"name": "decode", "compile_s": 0.5, "flops": 1e9,
                     "argument_bytes": 400, "temp_bytes": 200})
    led2.note_entry({"name": "insert", "argument_bytes": 100,
                     "temp_bytes": 0})
    v1 = led2.budget_check(bytes_limit=750)
    led2.write(path)
    under = dev.ProgramLedger()
    under.note_entry({"name": "a", "temp_bytes": 50, "argument_bytes": 30})
    v2 = under.budget_check(bytes_limit=1000)
    v3 = under.budget_check(bytes_limit=85)
    o.configure(None)
    with open(path) as f:
        rec = json.load(f)
    rec.pop("written_ts")
    return rec, [v1, v2, v3], _events(o, d)


def test_program_ledger_merge_and_budget_match_jax(tmp_path, capsys):
    j = _ledger_drive(jdev, jobs, str(tmp_path / "j"),
                      str(tmp_path / "j.json"))
    t = _ledger_drive(tdev, tobs, str(tmp_path / "t"),
                      str(tmp_path / "t.json"))
    assert t == j
    rec, verdicts, _ = t
    assert {e["name"] for e in rec["programs"]} == {"decode", "insert"}
    assert verdicts[0]["over"] is True and verdicts[1]["over"] is False
    assert "allocation pressure" in capsys.readouterr().out
    # No card and no limit: the resident bytes only, no ratio.
    v = tdev.ProgramLedger().budget_check()
    assert v == {"resident_bytes": 0, "programs": 0}


def test_note_program_gates_and_records(tmp_path):
    assert tdev.note_program("train.step", run_s=2.5) is None  # obs off
    d = str(tmp_path / "obs")
    tobs.configure(d, proc=0)
    assert tdev.note_program("train.step", run_s=2.5, ledger=False) is None
    entry = tdev.note_program("train.step", run_s=2.5, flops=6e9,
                              argument_bytes=123)
    tobs.configure(None)
    # Off the card the memory keys are absent, never invented.
    assert entry == {"name": "train.step", "compile_s": 2.5, "flops": 6e9,
                     "source": "train"}
    with open(os.path.join(d, "programs.json")) as f:
        assert json.load(f)["programs"] == [entry]
    summ = tdev.device_summary(str(tmp_path))
    assert summ["programs"] == [entry]


# ---------------------------------------------------- capture governor
class _FakeTracer:
    def __init__(self, start_raises=False, stop_raises=False):
        self.started, self.stops, self.dumps = [], 0, []
        self._start_raises = start_raises
        self._stop_raises = stop_raises

    def start(self, out_dir):
        if self._start_raises:
            raise RuntimeError("profiler unavailable")
        self.started.append(os.path.basename(out_dir))

    def stop(self):
        self.stops += 1
        if self._stop_raises:
            raise RuntimeError("stop failed")

    def memdump(self, path):
        self.dumps.append(os.path.basename(os.path.dirname(path)))


def _governor_trace(cap_mod, o, d, script, **cfg_kw):
    """Run ``script`` (a list of (op, arg) and ("tick", dt) for the
    clock) through one package's capturer; returns its decisions."""
    now = [100.0]
    cfg = cap_mod.CaptureConfig(z_mads=4.0, cooldown_s=10.0, max_captures=2,
                                trace_steps=2, window=16, warmup=4, **cfg_kw)
    tracer = _FakeTracer()
    cap = cap_mod.AnomalyCapturer(d + "/profile", cfg, tracer=tracer,
                                  clock=lambda: now[0])
    o.configure(d, proc=0)
    states = []
    for op, arg in script:
        if op == "tick":
            now[0] += arg
        elif op == "step":
            cap.observe_step(arg, 7)
        elif op == "itl":
            cap.observe_itl(arg)
        elif op == "slo":
            cap.note_slo_breach(arg)
        elif op == "nonfinite":
            cap.note_nonfinite(step=arg)
        elif op == "poll":
            cap.poll()
        elif op == "close":
            cap.close()
        states.append((cap.captures, cap.suppressed, tracer.stops,
                       cap._active is not None))
    o.configure(None)
    # Paths relative to the run; the memory snapshot by its directory
    # (its file is ``device_memory.prof`` in JAX, a pickle here).
    evs = [{**e, "dir": os.path.relpath(e["dir"], d),
            "memory_profile": os.path.relpath(
                os.path.dirname(e["memory_profile"]), d)}
           for e in _events(o, d, "prof.capture")]
    return states, tracer.started, tracer.dumps, evs


_SPIKES = ([("step", 0.1)] * 8 + [("step", 5.0), ("step", 5.0),
           ("step", 5.0), ("step", 7.0), ("tick", 11.0), ("step", 7.0),
           ("step", 0.1), ("step", 0.1), ("tick", 11.0), ("step", 9.0)])
_DIRECT = ([("slo", "ttft"), ("itl", 0.01), ("itl", 0.01), ("tick", 11.0)]
           + [("itl", 0.005)] * 6 + [("itl", 1.0), ("nonfinite", 7),
                                     ("close", None)])
_DEADLINE = [("slo", "itl"), ("tick", 6.0), ("poll", None),
             ("nonfinite", 3), ("tick", 11.0), ("nonfinite", 4),
             ("step", 0.2), ("step", 0.2)]


def _seeded_script(seed):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(120):
        r = rng.random()
        if r < 0.55:
            ops.append(("step", float(rng.choice([0.1, 0.11, 0.3, 4.0],
                                                 p=[.45, .45, .07, .03]))))
        elif r < 0.85:
            ops.append(("itl", float(rng.choice([0.01, 0.012, 0.5],
                                                p=[.48, .48, .04]))))
        elif r < 0.9:
            ops.append(("slo", str(rng.choice(["ttft", "itl"]))))
        elif r < 0.93:
            ops.append(("nonfinite", int(rng.integers(0, 50))))
        elif r < 0.97:
            ops.append(("tick", float(rng.uniform(0.0, 12.0))))
        else:
            ops.append(("poll", None))
    return ops + [("close", None)]


@pytest.mark.parametrize("script,cfg_kw", [
    (_SPIKES, {}), (_DIRECT, {}), (_DEADLINE, {"max_trace_s": 5.0}),
    (_seeded_script(0), {}), (_seeded_script(1), {"max_trace_s": 3.0}),
], ids=["spikes", "direct", "deadline", "seeded0", "seeded1"])
def test_capturer_decisions_match_jax(tmp_path, script, cfg_kw):
    j = _governor_trace(jcap, jobs, str(tmp_path / "j"), script, **cfg_kw)
    t = _governor_trace(tcap, tobs, str(tmp_path / "t"), script, **cfg_kw)
    assert t == j
    assert t[0][-1][0] >= 1  # every script captures at least once


@pytest.mark.parametrize("where", ["start", "stop"])
def test_broken_tracer_is_counted_and_printed(tmp_path, capsys, where):
    cfg = tcap.CaptureConfig(trace_steps=1)
    cap = tcap.AnomalyCapturer(
        str(tmp_path), cfg, tracer=_FakeTracer(
            start_raises=where == "start", stop_raises=where == "stop"))
    jcfg = jcap.CaptureConfig(trace_steps=1)
    jc = jcap.AnomalyCapturer(
        str(tmp_path), jcfg, tracer=_FakeTracer(
            start_raises=where == "start", stop_raises=where == "stop"))
    for c in (cap, jc):
        c.note_nonfinite(step=1)
        c.observe_step(0.1)
        assert c.trigger("step_time") is False  # disabled for the run
    assert cap.tracer_errors == 1
    assert (cap.captures, cap._broken) == (jc.captures, jc._broken)
    out = capsys.readouterr().out
    assert out.count("[tpuflow_torch]") == 1


def test_torch_tracer_writes_a_trace_on_the_cpu(tmp_path):
    """The real tracer: a nonfinite trigger, two observations, one chrome
    trace in the capture's directory; no device memory off the card."""
    import torch

    d = str(tmp_path / "obs")
    tobs.configure(d, proc=0)
    cap = tcap.make_capturer(tcap.CaptureConfig(trace_steps=2))
    assert cap.out_dir == os.path.join(d, "profile")
    cap.note_nonfinite(step=3)
    for _ in range(2):
        torch.ones(8) @ torch.ones(8)
        cap.observe_step(0.1)
    tobs.configure(None)
    (rec,) = cap.records
    assert rec["reason"] == "nonfinite" and rec["memory_profile"] is None
    (trace,) = glob.glob(os.path.join(rec["dir"], "trace.pid*.json"))
    with open(trace) as f:
        assert json.load(f)["traceEvents"]
    assert tcap.make_capturer(None) is None
    assert tcap.make_capturer(tcap.CaptureConfig()) is None  # nowhere


def test_nonfinite_train_step_arms_one_capture(tmp_path):
    """``train_gpt`` with a NaN at step 3 and a capturer: the nonfinite
    step triggers exactly one capture, bounded by the next two (replayed)
    steps, and its ``prof.capture`` event is in the stream."""
    from tpuflow_torch.train import gpt as tgpt

    tracer = _FakeTracer()
    cap = tcap.AnomalyCapturer(str(tmp_path / "prof"),
                               tcap.CaptureConfig(trace_steps=2),
                               tracer=tracer)
    d = str(tmp_path / "obs")
    tobs.configure(d, proc=0)
    cfg = tgpt.GptTrainConfig(preset="test", epochs=2, steps_per_epoch=2,
                              batch_size=8, seq_len=16, data_axis=1,
                              fsdp_axis=1)
    tgpt.train_gpt(cfg, str(tmp_path / "ck"), device="cpu",
                   log=lambda *a: None, faults="nan_grad:0@step3",
                   capture=cap)
    tobs.configure(None)
    assert tracer.started == ["capture_01_nonfinite"] and tracer.stops == 1
    (ev,) = _events(tobs, d, "prof.capture")
    assert ev["reason"] == "nonfinite" and ev["capture"] == 1
    assert [e["name"] for e in _events(tobs, d, "health.rollback")]


def test_engine_records_its_signatures_and_writes_the_ledger(tmp_path):
    """The serving engine's program ledger: the first run of each
    signature, 2 N FLOPs a token; ``serve_forever`` writes it with its
    budget check; the HBM poll disables itself on the CPU."""
    from tpuflow_torch.infer.serve import ServeEngine, serve_forever
    from tpuflow_torch.models.gpt2 import GPT2, GPT2Config

    model = GPT2(GPT2Config.small_test(dropout=0.0), seed=0, device="cpu")
    eng = ServeEngine(model, max_slots=2, buckets=[16], decode_block=4,
                      page_size=8)
    d = str(tmp_path / "obs")
    tobs.configure(d, proc=0)
    for n in (5, 9):
        eng.submit(np.arange(n, dtype=np.int32) % 50, max_new_tokens=6)
    serve_forever(eng, gateway=False, should_stop=lambda: not (
        eng.queue_depth or eng.live_slots))
    tobs.configure(None)
    n_params = sum(p.numel() for p in model.parameters())
    progs = {e["name"]: e for e in eng.programs.programs}
    assert {"prefill@16", "decode", "insert"} <= set(progs)
    assert progs["prefill@16"]["flops"] == 2.0 * n_params * 16
    assert progs["decode"]["flops"] == 2.0 * n_params * 2 * 4
    assert "temp_bytes" not in progs["decode"]  # the CPU has none
    with open(os.path.join(d, "programs.json")) as f:
        rec = json.load(f)
    assert {e["name"] for e in rec["programs"]} == set(progs)
    assert rec["budget"]["programs"] == len(progs)
    assert _events(tobs, d, "device.hbm_budget")
