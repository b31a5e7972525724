"""The port's live watch (``tpuflow_torch/obs/watch.py``) held to the live
modes of ``tools/tpu_watch.py`` (``follow`` and ``fleet``, the tool
imported by its path): both watch the same in-process
``MetricsServer(snapshot_fn=)`` replicas through the same scripted
snapshots, under a stepped clock (each ``sleep`` advances it, so both
loops poll the same number of times), and print the same lines once the
timestamp and the program tag (``[tpu_watch HH:MM:SS]`` against ``[watch
HH:MM:SS]``, ``python -m tpuflow.obs`` against ``python -m
tpuflow_torch.obs``) are stripped. The JAX tool's alert thresholds come
from its ``TPUFLOW_ALERT_*`` knobs; the port's engine is passed."""

import contextlib
import importlib.util
import io
import os
import re

import pytest

from tpuflow_torch.obs import alerts as talerts
from tpuflow_torch.obs import fleet as tfleet
from tpuflow_torch.obs import watch
from tpuflow_torch.obs.export import MetricsServer
from tpuflow_torch.obs.goodput import ProcessLedger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool():
    spec = importlib.util.spec_from_file_location(
        "_tpu_watch_tool", os.path.join(REPO, "tools", "tpu_watch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class SteppedTime:
    """The ``time`` module the loops see: ``sleep`` advances the clock,
    ``strftime`` is fixed."""

    def __init__(self):
        self.t = 1000.0

    def time(self):
        return self.t

    def sleep(self, dt):
        self.t += dt

    def strftime(self, fmt):
        return "00:00:00"


_PREFIX = re.compile(r"^\[(?:tpu_watch|watch)( 00:00:00)?\]")


def _norm(text):
    return [_PREFIX.sub("[W]", line).replace("python -m tpuflow_torch.obs",
                                             "python -m tpuflow.obs")
            for line in text.splitlines()]


class Script:
    """A snapshot source that steps through ``snaps`` one ``/status`` call
    at a time (the last one repeats); ``reset()`` replays it."""

    def __init__(self, snaps):
        self.snaps, self.i = snaps, 0

    def __call__(self):
        snap = dict(self.snaps[min(self.i, len(self.snaps) - 1)])
        self.i += 1
        return snap

    def reset(self):
        self.i = 0


def _run_both(monkeypatch, capsys, jax_call, port_call, reset):
    """The JAX tool's loop, then the port's, each under a stepped clock;
    returns both outputs, normalised."""
    tool = _tool()
    monkeypatch.setattr(tool, "time", SteppedTime())
    monkeypatch.setattr(watch, "time", SteppedTime())
    reset()
    capsys.readouterr()
    assert jax_call(tool) == 0
    jax_out = capsys.readouterr().out
    reset()
    buf = io.StringIO()
    assert port_call(buf) == 0
    return _norm(jax_out), _norm(buf.getvalue())


@pytest.fixture
def knobs(monkeypatch):
    for k in ("TPUFLOW_ALERT_HBM_HEADROOM", "TPUFLOW_ALERT_GOODPUT_MIN",
              "TPUFLOW_ALERT_SLO_BUDGET", "TPUFLOW_ALERT_FAST_WINDOW_S",
              "TPUFLOW_ALERT_SLOW_WINDOW_S", "TPUFLOW_ALERT_MIN_HEALTH",
              "TPUFLOW_ALERT_REROUTE_RATE", "TPUFLOW_ALERT_ROUTER_TTFT_FRAC",
              "TPUFLOW_FLEET_STALE_S", "TPUFLOW_FLEET_POLL_S",
              "TPUFLOW_FLEET_REPLICAS", "TPUFLOW_FLEET_REGISTRATION_DIR",
              "TPUFLOW_FLEET_HIST_BUCKETS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("TPUFLOW_ALERT_COOLDOWN_S", "0")
    return monkeypatch


def _serving_snap(i):
    led = ProcessLedger()
    led.note_serve_state(queue_depth=i % 3, live_slots=2, max_slots=4)
    for k in range(5 + i):
        led.note_serve_ttft(0.01 * (k + 1))
        led.note_serve_itl(0.002 * (k % 3 + 1))
        led.note_serve_complete("fp.plain")
    led.note_serve_ledger({"idle": 0.2, "decode": 0.7, "prefill": 0.1},
                          slo_violations=i)
    led.note_serve_tiers(3, 1, 0)
    snap = led.snapshot()
    snap.pop("uptime_s")
    return snap


def test_follow_prints_the_tools_lines(knobs, capsys):
    """Training snapshots, the card's memory, serving snapshots: a goodput
    drop and an HBM headroom alert that fire and resolve, then an SLO
    burn: the same status and ALERT lines."""
    snaps = [
        {"step": 3, "steps": 3, "step_rate": 2.5, "tokens_per_s": 20480.0,
         "goodput_fraction": 0.9, "loss": 5.4321, "uptime_s": 12.0},
        {"step": 4, "steps": 4, "goodput_fraction": 0.2, "loss": 5.1,
         "mfu": 0.0412, "uptime_s": 13.0},
        {"step": 5, "steps": 5, "goodput_fraction": 0.2, "uptime_s": 14.0,
         "hbm_used_bytes": 76 << 30, "hbm_used_frac": 0.95,
         "hbm_peak_frac": 0.97},
        {"step": 6, "steps": 6, "goodput_fraction": 0.8, "uptime_s": 15.0,
         "hbm_used_frac": 0.5},
        {**_serving_snap(2), "hbm_used_frac": 0.5},
        _serving_snap(4),
    ]
    script = Script(snaps)
    srv = MetricsServer(0, snapshot_fn=script)
    try:
        jax_lines, port_lines = _run_both(
            knobs, capsys,
            lambda tool: tool.follow(srv.url, 1.0, 6.5),
            lambda out: watch.follow(
                srv.url, 1.0, 6.5, out=out,
                engine=talerts.AlertEngine(cooldown_s=0.0)),
            script.reset)
    finally:
        srv.close()
    assert port_lines == jax_lines
    alerts = [ln[len("[W] "):] for ln in port_lines if "ALERT" in ln]
    assert alerts == [
        "ALERT [ticket] goodput_drop FIRED: goodput fraction 0.200 under "
        "the 0.50 floor (runbook #goodput--live-monitoring-runbook)",
        "ALERT [page] hbm_headroom FIRED: HBM headroom 0.050 under the "
        "0.080 budget line (used 0.950 of the tightest device) (runbook "
        "#device-observatory-runbook)",
        "ALERT [page] hbm_headroom RESOLVED after 0.0s",
        "ALERT [ticket] goodput_drop RESOLVED after 0.0s",
        "ALERT [page] slo_burn_rate FIRED: SLO burn: fast 100.0x / slow "
        "100.0x the 0.01 violation-rate budget (runbook "
        "#regression--alerting-runbook)"]
    assert any("| serve q=" in ln and "host=3 disk=1" in ln
               for ln in port_lines)
    assert port_lines[-1] == "[W] follow deadline reached"
    assert len(port_lines) == 7 + 5 + 1  # 7 polls, 5 ALERT lines


def test_follow_reports_an_unreachable_endpoint(knobs, capsys):
    srv = MetricsServer(0)
    url = srv.url
    srv.close()
    jax_lines, port_lines = _run_both(
        knobs, capsys, lambda tool: tool.follow(url, 2.0, 3.0),
        lambda out: watch.follow(url, 2.0, 3.0, out=out), lambda: None)
    assert port_lines == jax_lines
    assert port_lines[0].startswith(f"[W] follow: {url} unreachable (")
    assert port_lines[0].endswith("; retry in 2s")


def test_fleet_prints_the_tools_lines(knobs, capsys, tmp_path):
    """Two serving replicas (their TTFTs carrying trace exemplars) and a
    killed one: the same fleet headline, replica lines, p99 exemplar and
    the stale and health ALERT lines."""
    reg = str(tmp_path / "fleet")
    servers = []
    try:
        for i in range(2):
            led = ProcessLedger()
            led.note_serve_state(queue_depth=i, live_slots=1 + i,
                                 max_slots=4)
            for k in range(20):
                led.note_serve_ttft(0.005 * (k + 1) * (i + 1),
                                    trace_id=f"trace-{i}-{k}")
                led.note_serve_complete("fp.plain")
            snap = led.snapshot()
            snap.pop("uptime_s")
            ident = {"id": f"replica-{i}", "attempt": 0}
            servers.append(MetricsServer(
                0, snapshot_fn=lambda s=snap, ident=ident: {
                    **s, "replica": ident}))
            tfleet.register_replica(reg, servers[-1].url, identity=ident)
        dead = MetricsServer(0)
        tfleet.register_replica(reg, dead.url,
                                identity={"id": "replica-dead",
                                          "attempt": 0})
        dead.close()
        jax_lines, port_lines = _run_both(
            knobs, capsys, lambda tool: tool.fleet(reg, 1.0, 2.5),
            lambda out: watch.fleet(reg, 1.0, 2.5, out=out),
            lambda: None)
        empty = str(tmp_path / "empty")
        os.makedirs(empty)
        jax_empty, port_empty = _run_both(
            knobs, capsys, lambda tool: tool.fleet(empty, 1.0, 1.5),
            lambda out: watch.fleet(empty, 1.0, 1.5, out=out),
            lambda: None)
    finally:
        for s in servers:
            s.close()
    assert port_lines == jax_lines
    assert port_lines[0].startswith("[W] fleet n=3 healthy=2 stale=1")
    assert sum("STALE" in ln for ln in port_lines) == 3  # one a poll
    assert any(ln.startswith("[W] ttft p99 exemplar: trace trace-1-")
               for ln in port_lines)
    fired = sorted(ln.split()[3] for ln in port_lines if "FIRED" in ln)
    assert fired == ["health_collapse", "stale_replicas"]
    assert port_lines[-1] == "[W] fleet deadline reached"
    assert port_empty[0].startswith("[W] fleet: no replicas discovered")
    assert len(port_empty) == len(jax_empty) == 3


def test_main_parses_the_modes(monkeypatch):
    calls = []
    monkeypatch.setattr(watch, "follow",
                        lambda *a: calls.append(("follow", *a)) or 0)
    monkeypatch.setattr(watch, "fleet",
                        lambda *a: calls.append(("fleet", *a)) or 0)
    assert watch.main(["--follow", "http://h:1", "--interval", "0.5",
                       "--max-s", "3"]) == 0
    assert watch.main(["--fleet", "a,b"]) == 0
    assert calls == [("follow", "http://h:1", 0.5, 3.0),
                     ("fleet", "a,b", watch.DEFAULT_INTERVAL_S,
                      watch.DEFAULT_MAX_S)]
    for bad in ([], ["--follow", "u", "--fleet", "t"], ["--evidence"]):
        with contextlib.redirect_stderr(io.StringIO()), \
                pytest.raises(SystemExit) as e:
            watch.main(bad)
        assert e.value.code == 2
