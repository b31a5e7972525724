"""The port's run registry (``tpuflow_torch/obs/registry.py``) and its
``trend`` / ``compare`` / ``registry-backfill`` commands held to the JAX
package's (oracle ``tests/test_registry.py``).

Each case of the JAX file runs once on each package, on the same inputs,
and returns what it observed; the observations must be EQUAL (paths under
each package's own temporary directory written as ``<tmp>``). The JAX side
takes its registry file from ``TPUFLOW_REGISTRY_PATH`` (set by
``monkeypatch``), the port always from an explicit path. The backfill
reads ``BENCH_r*``-shaped captures the test writes, never the repository's
TPU captures. The differences the port makes on purpose are checked
apart: the ``"gpu"`` platform stamp where the JAX module stamps
``"tpu"``, and exit 2 with the usage text where the JAX CLI falls back to
its knob. The JAX file's jax-free subprocess has its counterpart in
``tests/test_torch_obs_cli.py``."""

import importlib
import json
import os

import pytest

from tpuflow_torch import obs as tobs
from tpuflow_torch.obs import fleet as tfleet
from tpuflow_torch.obs import registry as treg
from tpuflow_torch.obs.__main__ import main as tmain

jobs = importlib.import_module("tpuflow.obs")
jreg = importlib.import_module("tpuflow.obs.registry")
jfleet = importlib.import_module("tpuflow.obs.fleet")
jmain = importlib.import_module("tpuflow.obs.__main__").main


class Pkg:
    """One package's registry, obs and CLI; its registry file set through
    the environment (JAX) or passed (the port)."""

    def __init__(self, name, monkeypatch, capsys):
        self.name = name
        self.jax = name == "jax"
        self.reg = jreg if self.jax else treg
        self.obs = jobs if self.jax else tobs
        self.fleet = jfleet if self.jax else tfleet
        self.mp = monkeypatch
        self.capsys = capsys

    def live(self, kind, snap, path):
        if self.jax:
            if path:
                self.mp.setenv("TPUFLOW_REGISTRY_PATH", path)
            else:
                self.mp.delenv("TPUFLOW_REGISTRY_PATH", raising=False)
            return self.reg.maybe_append_live(kind, snap)
        return self.reg.maybe_append_live(kind, snap, path=path)

    def cli(self, argv, tmp):
        """(exit code, stdout with ``tmp`` as ``<tmp>``, stderr)."""
        self.capsys.readouterr()
        rc = (jmain if self.jax else tmain)(list(argv))
        out, err = self.capsys.readouterr()
        return rc, out.replace(tmp, "<tmp>"), err


@pytest.fixture
def pkgs(monkeypatch, capsys):
    for k in ("TPUFLOW_REGISTRY_PATH", "TPUFLOW_REGISTRY_WINDOW",
              "TPUFLOW_REGISTRY_ZMADS", "TPUFLOW_OBS_DIR"):
        monkeypatch.delenv(k, raising=False)
    jobs.configure(None)
    tobs.configure(None)
    yield [Pkg("jax", monkeypatch, capsys), Pkg("torch", monkeypatch,
                                                 capsys)]
    jobs.configure(None)
    tobs.configure(None)


def _mk(P, run_id, metrics, ts=0.0):
    return P.reg.make_record("bench", metrics, source="test",
                             run_id=run_id, ts=ts)


def _events(P, d):
    out = []
    for name in sorted(os.listdir(d)):
        if name.startswith("events."):
            out.extend(P.obs.read_events(os.path.join(d, name)))
    return out


# BENCH_r*-shaped captures: each generation of record the backfill reads
# (bare metric/value, the full record's extra, a null parsed with a
# truncated tail, the compact summary digest), values made up.
BENCH = {
    "BENCH_r01.json": {"n": 1, "rc": 0, "tail": "", "parsed": {
        "metric": "host_combined_gbps", "value": 1.25, "unit": "GB/s",
        "vs_baseline": 0.625}},
    "BENCH_r02.json": {"n": 2, "rc": 0, "tail": "", "parsed": {
        "value": 2.5, "vs_baseline": 1.25, "extra": {
            "tiers": {"disk": {"combined_gbps": 0.5}},
            "train": {"platform": "cpu", "tokens_per_s": 5000.0,
                      "mfu": None}}}},
    "BENCH_r03.json": {"n": 3, "rc": 0, "tail": "", "parsed": {
        "value": 2.75, "extra": {"train": {"platform": "gpu", "mfu": 0.3,
                                           "tokens_per_s": 6000.0}}}},
    "BENCH_r04.json": {"n": 4, "rc": 1, "parsed": None, "tail": (
        '..."serving": {"tokens_per_s": 1\n'
        + json.dumps({"value": 3.0, "summary": {
            "host_combined_gbps": 3.0, "train": {"platform": "gpu"}}})
        + "\n")},
    "BENCH_r05.json": {"n": 5, "rc": 0, "tail": "", "parsed": {
        "value": 3.5, "summary": {
            "host_combined_gbps": 3.5,
            "train": {"platform": "gpu", "mfu": 0.4, "tokens_per_s": 9e4},
            "spec_decode": {"numerics_ok": False, "speedup": None},
            "serving": {"hbm_peak_frac": 0.5, "ttft_p99_s": 0.12},
            "git": "abc1234"}}},
}


def _bench_dir(tmp):
    d = os.path.join(tmp, "bench")
    os.makedirs(d)
    for name, rec in BENCH.items():
        with open(os.path.join(d, name), "w") as f:
            json.dump(rec, f)
    with open(os.path.join(d, "BENCH_r06.json"), "w") as f:
        f.write("{not json")  # unreadable: skipped
    return d


def _backfilled(P, tmp):
    path = os.path.join(tmp, "reg.jsonl")
    assert P.reg.backfill_bench(_bench_dir(tmp), path) == 5
    return path


CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


# ------------------------------------------------------------- appends
@case
def append_read_roundtrip_and_event(P, tmp):
    path = os.path.join(tmp, "reg.jsonl")
    d = os.path.join(tmp, "obs")
    P.obs.configure(d, proc=0)
    try:
        ok = [P.reg.append_record(path, _mk(P, "a", {"mfu": 0.4})),
              P.reg.append_record(path, _mk(P, "b", {"mfu": 0.41}))]
        P.obs.flush()
    finally:
        P.obs.configure(None)
    with open(path, "rb") as f:
        raw = f.read()
    appends = [{k: v for k, v in e.items() if k not in ("ts", "pid")}
               for e in _events(P, d) if e["name"] == "registry.append"]
    for a in appends:
        a["path"] = a["path"].replace(tmp, "<tmp>")
    assert len(appends) == 2 and appends[0]["run_id"] == "a"
    return [ok, raw, P.reg.read_registry(path), appends]


@case
def reader_skips_torn_and_corrupt_lines(P, tmp):
    path = os.path.join(tmp, "reg.jsonl")
    P.reg.append_record(path, _mk(P, "a", {"mfu": 0.4}))
    with open(path, "a") as f:
        f.write('{"not": "a record"}\n')
        f.write("{garbage}\n")
    P.reg.append_record(path, _mk(P, "b", {"mfu": 0.41}))
    with open(path, "a") as f:
        f.write('{"schema": 1, "run_id": "torn", "metrics": {"m"')
    first = [r["run_id"] for r in P.reg.read_registry(path)]
    P.reg.append_record(path, _mk(P, "c", {"mfu": 0.42}))
    P.reg.append_record(path, _mk(P, "d", {"mfu": 0.43}))
    second = [r["run_id"] for r in P.reg.read_registry(path)]
    assert (first, second) == (["a", "b"], ["a", "b", "d"])
    return [first, second,
            P.reg.read_registry(os.path.join(tmp, "missing.jsonl"))]


# -------------------------------------------- tolerant extraction
@case
def digest_metrics_tolerates_missing_post_pr15_keys(P, tmp):
    legacy = {"host_combined_gbps": 1.76,
              "train": {"platform": "cpu", "tokens_per_s": 6929.4,
                        "mfu": None}}
    rich = {"serving": {"hbm_peak_frac": 0.63, "ttft_p99_s": 0.12},
            "serving_paged": {"vs_slot": 1.31},
            "serving_router": {"router_requests": 22,
                               "router_dropped": 0},
            "spec_decode": {"numerics_ok": False, "speedup": None},
            "exposed_comm_s": float("nan")}
    out = [P.reg.digest_metrics(legacy), P.reg.digest_metrics(rich),
           P.reg.digest_metrics(None), P.reg.digest_metrics([1]),
           P.reg.bench_metrics({"value": "NaN-ish"})]
    assert "train_mfu" not in out[0] and out[1]["paged_vs_slot"] == 1.31
    return out


@case
def bench_metrics_all_generations(P, tmp):
    return [P.reg.bench_metrics(rec["parsed"]) for rec in BENCH.values()
            ] + [P.reg.bench_metrics(None)]


# ------------------------------------------------------------ backfill
@case
def backfill_bench_history_idempotent(P, tmp):
    d = _bench_dir(tmp)
    path = os.path.join(tmp, "reg.jsonl")
    n = [P.reg.backfill_bench(d, path), P.reg.backfill_bench(d, path),
         P.reg.backfill_bench(os.path.join(tmp, "nope"), path)]
    recs = P.reg.read_registry(path)
    assert n == [5, 0, 0] and "BENCH_r04" in {r["run_id"] for r in recs}
    return [n, recs, P.reg.record_from_bench_file(
        os.path.join(d, "BENCH_r06.json"))]


# ---------------------------------------------------------- trend math
def _history(P):
    return [_mk(P, f"r{i}", {"train_mfu": 0.42 + 0.002 * (i % 3),
                             "serve_ttft_p99_s": 0.100 + 0.001 * (i % 2)},
                ts=float(i)) for i in range(5)]


@case
def trend_jitter_is_ok_regression_is_flagged(P, tmp):
    h = _history(P)
    out = [P.reg.verdict_rows(h, cur, window=5, zmads=8.0) for cur in (
        {"train_mfu": 0.421, "serve_ttft_p99_s": 0.1005},
        {"train_mfu": 0.20, "paged_vs_slot": 1.3},
        {"serve_ttft_p99_s": 0.02},
    )]
    # The defaults: the JAX knobs' defaults, 5 records and 8.0 MADs.
    out.append(P.reg.verdict_rows(h * 2, {"train_mfu": 0.43}))
    verdicts = {r["metric"]: r["verdict"] for r in out[1]}
    assert verdicts == {"train_mfu": "REGRESSED", "paged_vs_slot": "new",
                        "serve_ttft_p99_s": "absent"}
    return out


@case
def trend_constant_history_has_jitter_floor(P, tmp):
    h = [_mk(P, f"r{i}", {"m": 100.0}, ts=float(i)) for i in range(5)]
    out = [P.reg.verdict_rows(h, {"m": v}, window=5, zmads=8.0)
           for v in (100.4, 50.0)]
    assert [o[0]["verdict"] for o in out] == ["ok", "REGRESSED"]
    return out + [P.reg.trend_rows(h + [_mk(P, "x", {"m": 101.0})]),
                  P.reg.trend_rows([])]


@case
def compare_rows_direction_and_absent(P, tmp):
    a = _mk(P, "a", {"train_mfu": 0.40, "serve_ttft_p99_s": 0.10,
                     "host_combined_gbps": 3.9, "router_dropped": 0})
    b = _mk(P, "b", {"train_mfu": 0.44, "serve_ttft_p99_s": 0.20,
                     "hbm_peak_frac": 0.6, "router_dropped": 0})
    rows = P.reg.compare_rows(a, b)
    assert {r["metric"]: r["verdict"] for r in rows}["train_mfu"] == (
        "improved")
    return [rows, P.reg.format_rows(
        rows, ("metric", "a", "b", "delta", "delta_pct", "verdict"))]


# ------------------------------------------------------------------ CLI
@case
def trend_cli_over_backfilled_history(P, tmp):
    path = _backfilled(P, tmp)
    reg = f"--registry={path}"
    out = [P.cli(["trend", reg], tmp)[:2],
           P.cli(["trend", "--metric=train_mfu", "--json", reg], tmp)[:2],
           P.cli(["trend", "--window=2", reg], tmp)[:2],
           P.cli(["trend", "--window=x", reg], tmp)[0],
           P.cli(["trend", "extra", reg], tmp)[0],
           P.cli(["trend", "--bogus", reg], tmp)[0]]
    assert out[0][0] == 0 and "host_combined_gbps" in out[0][1]
    assert [r["metric"] for r in json.loads(out[1][1])] == ["train_mfu"]
    return out


@case
def compare_cli_and_prefix_match(P, tmp):
    path = _backfilled(P, tmp)
    reg = f"--registry={path}"
    out = [P.cli(["compare", "BENCH_r01", "BENCH_r05", reg], tmp)[:2],
           P.cli(["compare", "BENCH_r0", "BENCH_r03", reg, "--json"],
                 tmp)[:2],
           P.cli(["compare", "BENCH_r01", reg], tmp)[0]]
    rc, _, err = P.cli(["compare", "BENCH_r01", "nope", reg], tmp)
    assert out[0][0] == 0 and "absent" in out[0][1]
    assert rc == 1 and "nope" in err
    return out + [rc]


@case
def backfill_cli(P, tmp):
    d = _bench_dir(tmp)
    path = os.path.join(tmp, "reg.jsonl")
    out = [P.cli(["registry-backfill", d, f"--registry={path}"], tmp)[:2],
           P.cli(["registry-backfill", d, f"--registry={path}"], tmp)[:2],
           P.cli(["registry-backfill", d, d, f"--registry={path}"],
                 tmp)[0]]
    assert out[0][0] == 0 and "imported 5" in out[0][1]
    return out + [P.reg.read_registry(path)]


@case
def trend_cli_empty_registry(P, tmp):
    path = os.path.join(tmp, "empty.jsonl")
    rc, out, err = P.cli(["trend", f"--registry={path}"], tmp)
    assert rc == 1 and "registry" in err
    return [rc, out, P.cli(["compare", "a", f"--registry={path}"], tmp)[0]]


# ----------------------------------------------------- live run appends
@case
def maybe_append_live_knob_gated(P, tmp):
    assert P.live("train", {"goodput_fraction": 0.9}, None) is False
    path = os.path.join(tmp, "reg.jsonl")
    snap = {"goodput_fraction": 0.93, "tokens_per_s": 1000.0, "steps": 10,
            "serve_ttft_p95_s": 0.05, "router_requests": 4,
            "mfu": float("nan"), "nonfinite_steps": True}
    ok = P.live("train", snap, path)
    (rec,) = P.reg.read_registry(path)
    assert ok and rec["metrics"]["goodput_fraction"] == 0.93
    assert rec["run_id"] == f"train-{int(rec['ts'])}-{os.getpid()}"
    return [ok, {k: v for k, v in rec.items() if k not in ("ts", "run_id")},
            P.live("train", snap, "")]


@case
def snapshot_metrics_prefers_mergeable_buckets(P, tmp):
    h = P.fleet.MergeableHistogram()
    for v in (0.01, 0.02, 0.03, 0.2):
        h.observe(v)
    snap = {"serve_ttft_hist": h.to_dict(), "serve_ttft_p99_s": 123.0,
            "serve_itl_p99_s": 0.007, "goodput_fraction": 0.5,
            "serve_itl_hist": {"count": 0}}
    m = P.reg.snapshot_metrics(snap)
    assert m["serve_ttft_p99_s"] == P.fleet.hist_percentiles(
        h.to_dict())["p99"]
    assert m["serve_itl_p99_s"] == 0.007
    return m


@pytest.mark.parametrize("name", sorted(CASES))
def test_registry_case_same_on_both_packages(name, pkgs, tmp_path):
    """One case of tests/test_registry.py on each package: EQUAL
    observations."""
    seen = {}
    for P in pkgs:
        d = tmp_path / P.name
        d.mkdir()
        seen[P.name] = CASES[name](P, str(d))
    assert seen["torch"] == seen["jax"]


def test_every_registry_case_is_ported():
    """The JAX file's tests, one for one; its jax-free subprocess is in
    tests/test_torch_obs_cli.py."""
    src = open(os.path.join(os.path.dirname(__file__), "test_registry.py"),
               encoding="utf-8").read()
    jax_cases = {line[len("def test_"):].split("(")[0]
                 for line in src.splitlines() if line.startswith("def test_")}
    assert len(jax_cases) == 15
    assert jax_cases - set(CASES) == {"trend_cli_is_jax_free"}


# ------------------------------------------------ the port's own rules
def test_platform_stamp_is_gpu_where_jax_stamps_tpu(pkgs, tmp_path,
                                                    monkeypatch):
    """An injected card snapshot (the device observatory's memory keys):
    the JAX module stamps ``"tpu"``, the port ``"gpu"``; off the card
    (no ``hbm_limit_bytes``) neither stamps a platform. Every other field
    but the time stamps is equal."""
    card = {"goodput_fraction": 0.8, "hbm_used_bytes": 3 << 30,
            "hbm_limit_bytes": 80 << 30, "hbm_used_frac": 0.0375}
    got = {}
    for P in pkgs:
        for which, snap in (("card", card), ("cpu", {"steps": 3})):
            path = str(tmp_path / f"{P.name}-{which}.jsonl")
            assert P.live("serve", snap, path)
            (rec,) = P.reg.read_registry(path)
            got[P.name, which] = rec
    assert got["jax", "card"]["platform"] == "tpu"
    assert got["torch", "card"]["platform"] == "gpu"
    assert "platform" not in got["jax", "cpu"]
    assert "platform" not in got["torch", "cpu"]
    strip = ("ts", "run_id", "platform")
    for which in ("card", "cpu"):
        assert ({k: v for k, v in got["torch", which].items()
                 if k not in strip}
                == {k: v for k, v in got["jax", which].items()
                    if k not in strip})
    assert treg.DEFAULT_BASENAME == "GPU_REGISTRY.jsonl" != (
        jreg.DEFAULT_BASENAME)


def test_git_stamp_and_defaults_match(pkgs, tmp_path):
    """Both stamp the same checkout alike, a directory outside any
    repository as (None, None); the port's window and threshold defaults
    are the JAX knobs' defaults."""
    assert treg.git_stamp() == jreg.git_stamp()
    outside = str(tmp_path)
    assert treg.git_stamp(outside) == jreg.git_stamp(outside)
    from tpuflow.utils import knobs

    assert treg.DEFAULT_WINDOW == knobs.get_int("TPUFLOW_REGISTRY_WINDOW")
    assert treg.DEFAULT_ZMADS == knobs.get_float("TPUFLOW_REGISTRY_ZMADS")
    assert treg.registry_path(None) is None
    assert treg.registry_path(None, "d") == "d"
    assert treg.registry_path("p", "d") == "p"


def test_registry_commands_need_an_explicit_registry(pkgs, tmp_path,
                                                     capsys):
    """Without ``--registry=`` the port's registry commands answer exit 2
    and the usage text (the JAX CLI reads TPUFLOW_REGISTRY_PATH: unset,
    its trend finds an empty registry and answers 1)."""
    for argv in (["trend"], ["compare", "a", "b"],
                 ["registry-backfill", str(tmp_path)]):
        capsys.readouterr()
        assert tmain(argv) == 2
        err = capsys.readouterr().err
        assert err.startswith("usage: python -m tpuflow_torch.obs ")
    assert jmain(["trend"]) == 1
    assert not os.listdir(tmp_path)  # the backfill wrote nothing


def test_bench_append_and_verdict_lines_match(pkgs, tmp_path, monkeypatch):
    """A benchmark's hook: the port with an explicit path, the JAX one
    with its knob, over the same history and digest: the same verdict
    rows and log lines, the same record appended."""
    got = {}
    for P in pkgs:
        path = str(tmp_path / f"{P.name}.jsonl")
        for i in range(5):
            P.reg.append_record(path, _mk(P, f"r{i}", {
                "host_combined_gbps": 3.0 + 0.01 * i, "train_mfu": 0.4}))
        compact = {"value": 1.0, "summary": {
            "host_combined_gbps": 1.0,
            "train": {"platform": "gpu", "mfu": 0.41}}}
        lines = []
        if P.jax:
            monkeypatch.setenv("TPUFLOW_REGISTRY_PATH", path)
            rows = P.reg.bench_append_and_verdict(compact, str(tmp_path),
                                                  log=lines.append)
        else:
            rows = P.reg.bench_append_and_verdict(
                compact, str(tmp_path), log=lines.append, path=path)
        last = P.reg.read_registry(path)[-1]
        got[P.name] = [rows, [ln.replace(path, "<path>") for ln in lines],
                       {k: v for k, v in last.items()
                        if k not in ("ts", "run_id")}]
    assert got["torch"] == got["jax"]
    assert any("REGRESSED" in ln for ln in got["torch"][1])
    # No path: the port's default file beside the records.
    treg.bench_append_and_verdict({"value": 1.0}, str(tmp_path),
                                  log=lambda s: None)
    assert treg.read_registry(str(tmp_path / "GPU_REGISTRY.jsonl"))
