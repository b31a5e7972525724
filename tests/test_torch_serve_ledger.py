"""The serving observatory's host-side layer on the port
(``tpuflow_torch/obs/serve_ledger.py``), held against
``tpuflow/obs/serve_ledger.py`` case by case of tests/test_serve_obs.py:
the engine-time ledger's bucket and cursor math, the efficiency and SLO
accounting, the access log's records and their summary, and the summary
reproducing the live ledger's /metrics percentiles. Each case runs both
modules on the same inputs (made from a seed with numpy) and holds the
port's results equal to the JAX module's."""

import json
import os
import time

import numpy as np
import pytest

from tpuflow.obs import serve_ledger as jsl
from tpuflow.obs.export import prometheus_text as jprom
from tpuflow.obs.goodput import ProcessLedger as JLedger
from tpuflow_torch.obs import serve_ledger as tsl
from tpuflow_torch.obs.export import prometheus_text as tprom
from tpuflow_torch.obs.goodput import ProcessLedger as TLedger

MODS = pytest.mark.parametrize("sl", [jsl, tsl], ids=["jax", "port"])

# Keys of a snapshot that read the clock.
TIME_KEYS = {"wall_s", "buckets", "fractions"}


def _untimed(snap):
    return {k: v for k, v in snap.items() if k not in TIME_KEYS}


@MODS
def test_serve_ledger_buckets_sum_by_construction(sl):
    led = sl.ServeLedger()
    for name, s in (("prefill", 0.004), (None, 0.002), ("decode", 0.006),
                    ("verify", 0.003), ("insert", 0.001), ("idle", 0.002)):
        if name is None:
            time.sleep(s)  # uncharged gap -> host_sched
            continue
        with led.bucket(name):
            time.sleep(s)
    snap = led.snapshot()
    assert set(snap["buckets"]) == set(sl.SERVE_BUCKETS)
    assert sum(snap["buckets"].values()) == pytest.approx(
        snap["wall_s"], rel=1e-9)
    for b in ("prefill", "decode", "verify", "insert", "idle", "host_sched"):
        assert snap["buckets"][b] > 0
    assert sum(snap["fractions"].values()) == pytest.approx(1.0)
    led2 = sl.ServeLedger()
    with led2.bucket("decode"):
        time.sleep(0.002)
    time.sleep(0.002)
    fr = led2.fractions()
    assert sum(fr.values()) == pytest.approx(1.0, abs=1e-3)
    assert fr["host_sched"] > 0
    led.reset()
    assert sum(led.snapshot()["buckets"].values()) == pytest.approx(
        led.snapshot()["wall_s"], abs=1e-3)
    with pytest.raises(KeyError, match="bucket"):
        led.bucket("not_a_bucket")


def test_overlapping_charges_count_each_second_once():
    """Two threads' spans overlap (the loop's idle sleep, a gateway ship's
    prefill inside it): the port charges each span only past the cursor,
    so the buckets still sum to the wall. The JAX ledger counts both spans
    whole (ROADMAP Queue 3), which this case shows as its difference."""
    leds = {m: m.ServeLedger() for m in (jsl, tsl)}
    for led in leds.values():
        t0 = led._t0
        # idle [1, 5] opens first; prefill [2, 4] closes first, then idle.
        led._charge("prefill", t0 + 2.0, t0 + 4.0)
        led._charge("idle", t0 + 1.0, t0 + 5.0)
        # prefill [6, 9] opens inside idle [7, 8], which closes first.
        led._charge("idle", t0 + 7.0, t0 + 8.0)
        led._charge("prefill", t0 + 6.0, t0 + 9.0)
    b = leds[tsl].buckets
    assert sum(b.values()) == pytest.approx(9.0)
    # host_sched [0, 2], [5, 7]; prefill [2, 4], [8, 9]; idle [4, 5], [7, 8].
    assert (b["host_sched"], b["prefill"], b["idle"]) == pytest.approx(
        (4.0, 3.0, 2.0))
    # The JAX ledger counts [1, 2], [2, 4], [6, 7] and [7, 8] twice.
    assert sum(leds[jsl].buckets.values()) == pytest.approx(9.0 + 5.0)


def test_bucket_names_and_groups_equal():
    assert tsl.SERVE_BUCKETS == jsl.SERVE_BUCKETS
    assert tsl.GROUPS == jsl.GROUPS
    for q in (False, True):
        for s in (False, True):
            assert tsl.group_key(q, s) == jsl.group_key(q, s)
    assert set(tsl.GROUPS) == {
        tsl.group_key(q, s) for q in (False, True) for s in (False, True)}


def test_serve_ledger_efficiency_and_spec_economics():
    """Random block notes, TTFT/ITL observations and SLO checks: the two
    ledgers' snapshots are equal but for the clock's keys."""
    rng = np.random.default_rng(0)
    leds = [m.ServeLedger(slo_ttft_s=0.05, slo_itl_s=0.004)
            for m in (jsl, tsl)]
    for led in leds:
        assert led.decode_utilization is None
        assert led.masked_row_waste is None
    groups = list(jsl.GROUPS)
    for _ in range(40):
        rows = 8
        live = int(rng.integers(0, rows + 1))
        group_live = int(rng.integers(0, live + 1))
        spec = bool(rng.integers(0, 2))
        drafted = int(rng.integers(0, 16))
        committed = int(rng.integers(0, 20))
        g = groups[int(rng.integers(0, 4))]
        ttft = float(rng.lognormal(-3.5, 1.0))
        itl = float(rng.lognormal(-6.0, 0.8))
        for led in leds:
            led.note_decode_block(rows, group_live, live, spec=spec,
                                  drafted=drafted, committed=committed)
            led.note_ttft(g, ttft)
            led.note_itl(g, itl)
            led.check_ttft(ttft, group=g)
            led.check_itl(itl, group=g)
    j, t = (_untimed(led.snapshot()) for led in leds)
    assert t == j
    assert t["spec_wasted"] == max(t["spec_drafted"] - t["spec_accepted"], 0)
    # The JAX test's hand case.
    led = tsl.ServeLedger()
    led.note_decode_block(8, 4, 6)
    led.note_decode_block(8, 2, 2, spec=True, drafted=4, committed=5)
    assert led.decode_utilization == pytest.approx(6 / 16)
    assert led.masked_row_waste == pytest.approx(2 / 16)
    assert (led.spec_drafted, led.spec_accepted, led.spec_wasted) == (4, 3, 1)


def test_serve_ledger_slo_checks_and_resolution(monkeypatch):
    """The checks count as the JAX ledger's; the port's millisecond
    arguments resolve as the JAX knobs do (ms -> s, unset -> off), and a
    value the JAX knob would turn off raises ``ValueError``."""
    for sl in (jsl, tsl):
        led = sl.ServeLedger(slo_ttft_s=0.1, slo_itl_s=0.01)
        assert not led.check_ttft(0.05) and led.check_ttft(0.2)
        assert not led.check_itl(0.005) and led.check_itl(0.02)
        assert led.check_itl(None) is False
        assert led.slo_violations == 2
        assert led.slo_ttft_violations == led.slo_itl_violations == 1
        off = sl.ServeLedger()
        assert not off.check_ttft(1e9) and off.slo_violations == 0
    # The JAX knob's accepted values convert alike; the values it turns
    # off (unset aside) are the port argument's errors.
    for raw in ("250", "0.5", None):
        if raw is None:
            monkeypatch.delenv("TPUFLOW_SERVE_SLO_TTFT_MS", raising=False)
        else:
            monkeypatch.setenv("TPUFLOW_SERVE_SLO_TTFT_MS", raw)
        want = jsl.resolve_slo_s("TPUFLOW_SERVE_SLO_TTFT_MS")
        assert tsl.resolve_slo_s(None if raw is None else float(raw)) == want
    for raw in ("banana", "0", "-3"):
        monkeypatch.setenv("TPUFLOW_SERVE_SLO_TTFT_MS", raw)
        assert jsl.resolve_slo_s("TPUFLOW_SERVE_SLO_TTFT_MS") is None
        bad = raw if raw == "banana" else float(raw)
        with pytest.raises(ValueError, match="positive number of ms"):
            tsl.resolve_slo_s(bad)
    for bad in (True, "250", float("nan")):
        with pytest.raises(ValueError):
            tsl.resolve_slo_s(bad)
    assert tsl.resolve_slo_s(250) == pytest.approx(0.25)


def _mk_record(i, group="fp.plain", ttft=0.01, itl=(0.002,), reason="budget",
               slo=0, tokens=5):
    return {
        "request": i,
        "ts": 100.0 + i,
        "group": group,
        "quant": group.startswith("int8"),
        "spec": group.endswith("spec"),
        "prompt_len": 4,
        "tokens": tokens,
        "terminal": "complete" if reason != "drained" else "drained",
        "finish_reason": reason,
        "ttft_s": ttft,
        "itl_s": list(itl),
        "slo_violations": slo,
    }


def _records(seed, n):
    rng = np.random.default_rng(seed)
    groups = list(jsl.GROUPS)
    out = []
    for i in range(n):
        reason = ("budget", "eos", "capacity", "drained")[int(
            rng.integers(0, 4))]
        itl = tuple(float(x) for x in rng.lognormal(
            -6.0, 0.8, size=int(rng.integers(0, 5))))
        out.append(_mk_record(
            i, groups[int(rng.integers(0, 4))],
            ttft=None if reason == "drained" else float(
                rng.lognormal(-3.5, 1.0)),
            itl=() if reason == "drained" else itl, reason=reason,
            slo=int(rng.integers(0, 3)), tokens=int(rng.integers(0, 33))))
    return out


def test_access_log_roundtrip_and_summary(tmp_path):
    """Both AccessLogs write the same lines; each package's reader loads
    the other's file; the summaries are equal (the JAX test's hand case
    too)."""
    recs = [
        _mk_record(0, "fp.plain", ttft=0.01, itl=(0.002, 0.004)),
        _mk_record(1, "int8.spec", ttft=0.03, itl=(0.001,), slo=2),
        _mk_record(2, "fp.plain", ttft=0.02, reason="eos"),
        _mk_record(3, "fp.plain", ttft=None, itl=(), reason="drained"),
    ] + [dict(r, request=r["request"] + 4, ts=r["ts"] + 4)
         for r in _records(1, 60)]
    logs = {}
    for name, sl in (("jax", jsl), ("port", tsl)):
        run_dir = str(tmp_path / name)
        log = sl.AccessLog(os.path.join(run_dir, "obs"), proc=0)
        for r in recs:
            log.write(r)
        with open(log.path, "a") as f:  # a live writer's torn tail
            f.write('{"request": 99, "torn...')
        logs[name] = (run_dir, log.path)
    jdir, jpath = logs["jax"]
    tdir, tpath = logs["port"]
    assert os.path.basename(tpath) == os.path.basename(jpath)
    assert open(tpath).read() == open(jpath).read()
    loaded = tsl.load_access_log(tdir)
    assert loaded == jsl.load_access_log(tdir) == tsl.load_access_log(jdir)
    assert [r["request"] for r in loaded] == list(range(len(recs)))
    assert len(tsl.load_access_log(os.path.join(tdir, "obs"))) == len(recs)
    s = tsl.summarize_access(loaded)
    assert s == jsl.summarize_access(loaded)
    hand = tsl.summarize_access(loaded[:4])
    assert hand == jsl.summarize_access(loaded[:4])
    assert hand["requests"] == 4 and hand["tokens"] == 20
    assert hand["slo_violations"] == 2
    assert hand["finish_reasons"] == {"budget": 2, "drained": 1, "eos": 1}
    assert hand["ttft"]["count"] == 3 and hand["itl"]["count"] == 4
    assert tsl.load_access_log(str(tmp_path / "nope")) == []
    assert tsl.summarize_access([]) == jsl.summarize_access([])
    assert tsl.percentiles([]) is None and tsl.pctl([], 0.5) == 0.0


def test_serve_summary_reproduces_metrics_percentiles():
    """The same TTFT/ITL observations fed to both packages' live ledgers
    and written as access records give identical p50/p95/p99 on all four
    surfaces, and the two Prometheus renderings are equal but for the
    clock's lines."""
    rng = np.random.default_rng(2)
    ttfts = [float(x) for x in rng.lognormal(-3.5, 1.0, size=37)]
    itls = [float(x) for x in rng.lognormal(-6.0, 0.8, size=53)]
    leds = [JLedger(), TLedger()]
    for led in leds:
        led.note_serve_state(queue_depth=0, live_slots=1, max_slots=2)
        for v in ttfts:
            led.note_serve_ttft(v)
        for v in itls:
            led.note_serve_itl(v)
        led.note_serve_ledger(
            {"idle": 0.5, "decode": 0.3, "prefill": 0.1, "insert": 0.05,
             "host_sched": 0.05},
            utilization=0.8, masked_waste=0.125, slo_violations=3)
    records = [_mk_record(i, ttft=t, itl=()) for i, t in enumerate(ttfts)]
    records[0]["itl_s"] = list(itls)
    s = tsl.summarize_access(records)
    assert s == jsl.summarize_access(records)
    jsnap, tsnap = (led.snapshot() for led in leds)
    for q in ("p50", "p95", "p99"):
        for which in ("ttft", "itl"):
            assert tsnap[f"serve_{which}_{q}_s"] == jsnap[
                f"serve_{which}_{q}_s"]
            assert tsnap[f"serve_{which}_{q}_s"] == pytest.approx(
                s[which][q], abs=1e-6)
    for key in ("serve_idle_fraction", "serve_decode_utilization",
                "serve_masked_row_waste", "serve_slo_violations"):
        assert tsnap[key] == jsnap[key]

    def lines(text):
        return [ln for ln in text.splitlines()
                if "uptime" not in ln and "tokens_per_s" not in ln]

    ttext = tprom(tsnap)
    assert lines(ttext) == lines(jprom(jsnap))
    for want in ("tpuflow_serve_idle_fraction 0.5",
                 "tpuflow_serve_decode_fraction 0.3",
                 "tpuflow_serve_masked_row_waste 0.125",
                 "tpuflow_serve_slo_violations_total 3",
                 "tpuflow_serve_itl_p99_seconds",
                 "tpuflow_serve_ttft_p95_seconds"):
        assert want in ttext


def test_jax_serve_summary_cli_reads_port_access_log(tmp_path, capsys):
    """``python -m tpuflow.obs serve-summary`` over an access log and the
    ledger gauges the port wrote: the JAX CLI's summary equals the port's
    ``summarize_access`` of the same records."""
    from tpuflow.obs.__main__ import main as obs_main
    from tpuflow_torch import obs as tobs

    run_dir = str(tmp_path / "run")
    log = tsl.AccessLog(os.path.join(run_dir, "obs"), proc=0)
    recs = [_mk_record(0, "fp.plain", ttft=0.01, itl=(0.002,)),
            _mk_record(1, "int8.plain", ttft=0.05, itl=(0.003,), slo=1)]
    for r in recs:
        log.write(r)
    tobs.configure(os.path.join(run_dir, "obs"), proc=0)
    try:
        for name, v in (("serve.idle_fraction", 0.25),
                        ("serve.decode_fraction", 0.60),
                        ("serve.prefill_fraction", 0.10),
                        ("serve.decode_utilization", 0.9)):
            tobs.gauge(name, v)
    finally:
        tobs.configure(None)
    assert obs_main(["serve-summary", run_dir, "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    ledger = out.pop("ledger")
    assert out == json.loads(json.dumps(tsl.summarize_access(recs)))
    assert ledger["serve.decode_fraction"] == pytest.approx(0.60)
    assert obs_main(["serve-summary", run_dir]) == 0
    text = capsys.readouterr().out
    assert "requests: 2" in text and "decode: 60.0%" in text
