"""The port's operator CLI (``python -m tpuflow_torch.obs``) held to the
JAX package's (``python -m tpuflow.obs``): all eight commands on the SAME
run directories, registries, fleet and trace directories, with equal
standard output, equal ``--json`` structures and equal exit codes. The
usage text (on standard error) differs by its program name, and where the
JAX CLI falls back to a knob (``TPUFLOW_REGISTRY_PATH``,
``TPUFLOW_FLEET_*``, ``TPUFLOW_TRACE_DIR``) the port answers exit 2 with
its usage text. One real ``python -m tpuflow_torch.obs trend`` runs in a
subprocess with ``jax`` and ``tpuflow`` poisoned."""

import importlib
import json
import os
import subprocess
import sys

import pytest

from tpuflow_torch.obs import fleet as tfleet
from tpuflow_torch.obs import trace as ttrace
from tpuflow_torch.obs.__main__ import main as tmain
from tpuflow_torch.obs.export import MetricsServer
from tpuflow_torch.obs.goodput import ProcessLedger
from tpuflow_torch.obs.recorder import Recorder
from tpuflow_torch.obs.serve_ledger import AccessLog

jmain = importlib.import_module("tpuflow.obs.__main__").main
jreg = importlib.import_module("tpuflow.obs.registry")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_KNOBS = ("TPUFLOW_REGISTRY_PATH", "TPUFLOW_FLEET_REPLICAS",
          "TPUFLOW_FLEET_REGISTRATION_DIR", "TPUFLOW_TRACE_DIR",
          "TPUFLOW_FLEET_STALE_S", "TPUFLOW_FLEET_POLL_S",
          "TPUFLOW_FLEET_HIST_BUCKETS", "TPUFLOW_REGISTRY_WINDOW",
          "TPUFLOW_REGISTRY_ZMADS")


@pytest.fixture
def both(monkeypatch, capsys):
    """``run(argv)``: each CLI on ``argv``; returns {"jax": (rc, out,
    err), "torch": ...}."""
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)

    def run(argv, mains=(("jax", jmain), ("torch", tmain))):
        out = {}
        for name, main in mains:
            capsys.readouterr()
            rc = main(list(argv))
            o, e = capsys.readouterr()
            out[name] = (rc, o, e)
        return out

    return run


def _equal(got, json_out=False, strip=()):
    """The two CLIs' exit codes and standard output equal (parsed, with
    the ``strip`` keys dropped at every depth, for ``--json``)."""

    def clean(x):
        if isinstance(x, dict):
            return {k: clean(v) for k, v in x.items() if k not in strip}
        if isinstance(x, list):
            return [clean(v) for v in x]
        return x

    (jrc, jout, _), (trc, tout, _) = got["jax"], got["torch"]
    assert jrc == trc
    if json_out:
        assert clean(json.loads(tout)) == clean(json.loads(jout))
    else:
        assert tout == jout
    return trc, tout


# --------------------------------------------------------- run dirs
def _run_dir(tmp):
    """A run directory every run-dir command reads: spans, step times,
    tokens, a restore in a second launch, serve and device gauges, a
    capture event, a budget verdict, the access log and programs.json."""
    run_dir = os.path.join(tmp, "run")
    d = os.path.join(run_dir, "obs")
    rec = Recorder(d, proc=0, flush_interval=60)
    rec.record("span", "train.compile", ts=100.0, dur_s=1.0)
    for i in range(4):
        rec.record("histogram", "train.step_s", ts=102.0 + i, value=0.5)
    rec.record("counter", "train.tokens", ts=105.0, value=1024)
    rec.record("span", "ckpt.save", ts=105.5, dur_s=0.25, bytes=4e8,
               gbps=1.6)
    for name, v in (("serve.idle_fraction", 0.25),
                    ("serve.decode_fraction", 0.60),
                    ("serve.prefill_fraction", 0.10),
                    ("serve.decode_utilization", 0.9),
                    ("serve.masked_row_waste", 0.125),
                    ("device.hbm_used", 6 << 30),
                    ("device.hbm_peak", 8 << 30),
                    ("device.hbm_limit", 80 << 30),
                    ("device.hbm_used", 5 << 30)):
        rec.record("gauge", name, ts=106.0, value=v)
    rec.record("event", "prof.capture", ts=107.0, reason="step_time",
               dir="/x/capture_01_step_time", capture=1,
               memory_profile="/x/mem.pickle")
    rec.record("event", "device.hbm_budget", ts=107.5,
               resident_bytes=3 << 30, programs=2, bytes_limit=80 << 30,
               resident_frac=0.0375, over=False)
    rec.close()
    rec = Recorder(d, proc=1, attempt=1, flush_interval=60)
    rec.record("span", "ckpt.restore", ts=110.0, dur_s=0.5, bytes=1e9)
    rec.record("histogram", "train.step_s", ts=111.0, value=0.5)
    rec.close()
    log = AccessLog(d, proc=0)
    for i, (group, ttft, itl, reason, slo) in enumerate((
            ("fp.plain", 0.01, [0.002, 0.004], "budget", 0),
            ("int8.plain", 0.05, [0.003], "eos", 1),
            ("fp.plain", 0.02, [0.001, 0.002, 0.003], "budget", 0),
            ("fp.spec", None, [], "drained", 0))):
        log.write({"request": i, "ts": 200.0 + i, "group": group,
                   "tokens": len(itl) + (ttft is not None),
                   "finish_reason": reason, "ttft_s": ttft, "itl_s": itl,
                   "slo_violations": slo})
    with open(os.path.join(d, "programs.json"), "w") as f:
        json.dump({"written_ts": 1.0, "source": "serve", "programs": [
            {"name": "decode", "compile_s": 1.2, "flops": 1e9,
             "argument_bytes": 4 << 20, "output_bytes": 1 << 20,
             "temp_bytes": 2 << 20},
            {"name": "prefill@16", "compile_s": 0.8},
            {"name": "kernel.flash_fwd", "compile_s": 0}],
            "budget": {"resident_bytes": 6 << 20, "programs": 3,
                       "bytes_limit": 80 << 30, "resident_frac": 0.0001,
                       "over": False}}, f)
    return run_dir


@pytest.mark.parametrize("cmd", ["summarize", "serve-summary",
                                 "device-summary"])
def test_run_dir_commands_same_output(cmd, both, tmp_path):
    run_dir = _run_dir(str(tmp_path))
    rc, out = _equal(both([cmd, run_dir]))
    assert rc == 0 and out
    rc, _ = _equal(both([cmd, run_dir, "--json"]), json_out=True)
    assert rc == 0
    empty = str(tmp_path / "empty")
    for argv in ([cmd, empty], [cmd], [cmd, run_dir, "--bogus"],
                 [cmd, run_dir, run_dir]):
        _equal(both(argv))
    assert both([cmd, empty])["torch"][0] == 1


def test_summarize_reads_the_committed_stream(both, tmp_path):
    """A finished run's ``events.jsonl`` (merged by the port's
    ``merge_run_events``) reads the same through both CLIs."""
    from tpuflow_torch.obs import merge_run_events

    run_dir = _run_dir(str(tmp_path))
    assert merge_run_events(run_dir)
    assert os.path.exists(os.path.join(run_dir, "events.jsonl"))
    assert _equal(both(["summarize", run_dir]))[0] == 0


def test_usage_and_unknown_commands(both):
    for argv in ([], ["nope", "x"], ["summarize"], ["--json"],
                 ["trace"], ["trace", "req"], ["trace", "req", "d", "-x"]):
        got = both(argv)
        assert got["jax"][:2] == got["torch"][:2] == (2, "")
        assert got["torch"][2].startswith(
            "usage: python -m tpuflow_torch.obs ")
        assert (got["torch"][2].replace("tpuflow_torch", "tpuflow")
                .count("python -m tpuflow.obs")) == 6


# ------------------------------------------------------------ fleet
def test_fleet_summary_same_output(both, tmp_path):
    """Three replicas (their ``/status`` fixed snapshots) and a killed one
    in a registration directory: equal headline and replica lines, equal
    JSON but the poll's clock readings."""
    reg = str(tmp_path / "fleet")
    servers = []
    try:
        for i in range(3):
            led = ProcessLedger()
            led.note_serve_state(queue_depth=i, live_slots=1 + i,
                                 max_slots=4)
            for k in range(10 + 5 * i):
                led.note_serve_ttft(0.004 * (k + 1) * (i + 1),
                                    trace_id=f"t{i}-{k}")
                led.note_serve_itl(0.001 * (k % 4 + 1))
                led.note_serve_complete("fp.plain" if k % 3 else
                                        "int8.plain")
            led.note_serve_ledger({"idle": 0.5, "decode": 0.5},
                                  utilization=0.75, slo_violations=i,
                                  slo_by_group={"fp.plain": i})
            ident = {"id": f"replica-{i}", "attempt": 0}
            snap = {**led.snapshot(), "replica": ident}
            snap.pop("uptime_s")
            servers.append(MetricsServer(0, snapshot_fn=lambda s=snap:
                                         dict(s)))
            tfleet.register_replica(reg, servers[-1].url, identity=ident)
        dead = MetricsServer(0)
        tfleet.register_replica(reg, dead.url,
                                identity={"id": "replica-dead",
                                          "attempt": 0})
        dead.close()
        rc, out = _equal(both(["fleet-summary", reg]))
        assert rc == 0 and "fleet n=4" in out and "STALE" in out
        rc, out = _equal(both(["fleet-summary", reg, "--json"]),
                         json_out=True, strip=("ts", "age_s"))
        assert json.loads(out)["fleet"]["stale"] == 1
        urls = ",".join(s.url for s in servers)
        assert _equal(both(["fleet-summary", urls]))[0] == 0
        empty = str(tmp_path / "empty")
        os.makedirs(empty)
        assert _equal(both(["fleet-summary", empty]))[0] == 1
        assert _equal(both(["fleet-summary", "a", "b"]))[0] == 2
        # No target: the JAX CLI's knobs resolve nothing (exit 1); the
        # port needs the argument (exit 2, usage).
        got = both(["fleet-summary"])
        assert (got["jax"][0], got["torch"][0]) == (1, 2)
        assert got["torch"][2].startswith("usage:")
    finally:
        for s in servers:
            s.close()


# ------------------------------------------------------------ trace
def _trace_dirs(tmp):
    """A rerouted request's spans split over two writers under
    ``<tmp>/run/trace``, and one more writer's under
    ``<tmp>/other/obs/trace``."""
    from test_torch_trace import _reroute_spans

    spans = _reroute_spans()
    d = os.path.join(tmp, "run", "trace")
    other = os.path.join(tmp, "other", "obs", "trace")
    for directory, writers in ((d, ("frontdoor", "rep-0")),
                               (other, ("rep-1",))):
        os.makedirs(directory)
        for w in writers:
            assert ttrace.write_spans(
                [{k: v for k, v in s.items() if k != "writer"}
                 for s in spans if s["writer"] == w],
                writer=w, directory=directory)
    # The same front-door spans twice: merged once.
    ttrace.write_spans([{k: v for k, v in s.items() if k != "writer"}
                        for s in spans if s["writer"] == "frontdoor"],
                       writer="frontdoor", directory=d)
    return d, os.path.join(tmp, "run"), os.path.join(tmp, "other")


def test_trace_same_output(both, tmp_path):
    d, run_dir, other = _trace_dirs(str(tmp_path))
    rc, out = _equal(both(["trace", "req-3", d, other]))
    assert rc == 0 and "[REROUTED]" in out
    assert "reroute: rep-0 -> rep-1" in out
    assert _equal(both(["trace", "req-3", run_dir, other]))[1] == out
    rc, out = _equal(both(["trace", "req-3", d, other, "--json"]),
                     json_out=True)
    assert json.loads(out)["rerouted"] is True
    assert _equal(both(["trace", "nope", d]))[0] == 1
    assert _equal(both(["trace", "req-3", str(tmp_path / "x")]))[0] == 1
    # No directory: the JAX CLI's knob is unset, both answer 2.
    assert _equal(both(["trace", "req-3"]))[0] == 2


# --------------------------------------------------------- registry
def _registry(tmp):
    """One registry every registry command reads: five backfilled
    captures (the registry test's shapes) and two live records."""
    from test_torch_registry import _bench_dir

    path = os.path.join(tmp, "reg.jsonl")
    jreg.backfill_bench(_bench_dir(tmp), path)
    for i, gp in enumerate((0.8, 0.4)):
        jreg.append_record(path, jreg.make_record(
            "train", {"goodput_fraction": gp, "host_combined_gbps": 3.4},
            source="train:live", run_id=f"train-{i}", ts=10.0 + i))
    return path


def test_registry_commands_same_output(both, tmp_path):
    path = _registry(str(tmp_path))
    reg = f"--registry={path}"
    for argv in (["trend", reg], ["trend", reg, "--metric=train_mfu",
                                  "--metric=goodput_fraction"],
                 ["trend", reg, "--window=2"],
                 ["compare", "BENCH_r01", "train-1", reg],
                 ["compare", "train", "BENCH_r05", reg],
                 ["compare", "BENCH_r01", "nope", reg],
                 ["compare", "a", reg], ["trend", "x", reg],
                 ["trend", "--window=no", reg], ["trend", "-v", reg]):
        _equal(both(argv))
    for argv in (["trend", reg, "--json"],
                 ["compare", "BENCH_r02", "train-0", reg, "--json"]):
        assert _equal(both(argv), json_out=True)[0] == 0
    out = _equal(both(["trend", reg]))[1]
    assert "REGRESSED: goodput_fraction" in out
    empty = f"--registry={tmp_path / 'none.jsonl'}"
    assert _equal(both(["trend", empty]))[0] == 1
    assert _equal(both(["compare", "a", "b", empty]))[0] == 1


def test_registry_backfill_same_output(both, tmp_path):
    from test_torch_registry import _bench_dir

    d = _bench_dir(str(tmp_path))
    got = {}
    for name, main in (("jax", jmain), ("torch", tmain)):
        path = str(tmp_path / f"{name}.jsonl")
        first = both(["registry-backfill", d, f"--registry={path}"],
                     ((name, main),))[name]
        again = both(["registry-backfill", d, f"--registry={path}"],
                     ((name, main),))[name]
        got[name] = [first[0], first[1].replace(path, "<reg>"), again[0],
                     again[1].replace(path, "<reg>"),
                     open(path).read()]
    assert got["torch"] == got["jax"]
    assert "imported 5 bench record(s)" in got["torch"][1]
    assert _equal(both(["registry-backfill", d, d,
                        f"--registry={tmp_path / 'x.jsonl'}"]))[0] == 2


def test_registry_commands_need_the_registry_argument(both, tmp_path):
    for argv in (["trend"], ["compare", "a", "b"],
                 ["registry-backfill", str(tmp_path)]):
        rc, out, err = both(argv, (("torch", tmain),))["torch"]
        assert (rc, out) == (2, "")
        assert err.startswith("usage: python -m tpuflow_torch.obs ")
    assert os.listdir(tmp_path) == []


def test_trend_subprocess_with_jax_and_tpuflow_poisoned(tmp_path):
    """A real ``python -m tpuflow_torch.obs trend`` (``runpy``, as ``-m``
    runs it) with ``jax`` and ``tpuflow`` unimportable: the same table the
    JAX CLI prints in process."""
    path = _registry(str(tmp_path))
    code = (
        "import runpy, sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'tpuflow'):\n"
        "    sys.modules[m] = None\n"
        "sys.argv = ['tpuflow_torch.obs', 'trend', sys.argv[1]]\n"
        "runpy.run_module('tpuflow_torch.obs', run_name='__main__',\n"
        "                 alter_sys=True)\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for k in _KNOBS:
        env.pop(k, None)
    proc = subprocess.run(
        [sys.executable, "-c", code, f"--registry={path}"],
        capture_output=True, text=True, env=env, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jmain(["trend", f"--registry={path}"]) == 0
    assert proc.stdout == buf.getvalue()
    assert "host_combined_gbps" in proc.stdout
