"""The port's telemetry core (``tpuflow_torch/obs``) against the JAX
package's (``tpuflow/obs``): the same calls give the same JSONL lines
(apart from ``ts``, ``pid`` and ``dur_s``), the disabled path writes
nothing, ``merge_run_events`` gives the same merged order and bytes, the
flight dump holds the same ring, and every name the port emits is in its
catalog with the JAX catalog's kind."""

import glob
import importlib
import json
import os
import threading

import pytest

from tpuflow import obs as jobs
from tpuflow.lint.obs_pass import (
    _API_RE,
    _RAW_RECORD_RE,
    _RECORD_RE,
    _TIMED_ITER_RE,
)
from tpuflow.obs.catalog import CATALOG as JCATALOG
from tpuflow_torch import obs as tobs
from tpuflow_torch.obs.catalog import CATALOG as TCATALOG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOLATILE = ("ts", "pid", "dur_s")


@pytest.fixture(autouse=True)
def obs_off(monkeypatch):
    for k in ("TPUFLOW_OBS_DIR", "TPUFLOW_OBS_PROC", "TPUFLOW_ATTEMPT"):
        monkeypatch.delenv(k, raising=False)
    jobs.configure(None)
    tobs.configure(None)
    yield
    jobs.configure(None)
    tobs.configure(None)


def _drive(o):
    """One sequence of every emitter kind through module API ``o``."""
    with o.span("ckpt.upload", step=3, bytes=10) as sp:
        sp.set(ok=True)
    with pytest.raises(RuntimeError):
        with o.span("flow.step", step="boom"):
            raise RuntimeError("x")
    o.counter("flow.retry", 2, step="train")
    o.gauge("flow.retry_backoff_s", 1.5, step="train")
    o.histogram("data.batch_wait_s", 0.25)
    o.event("ckpt.restore_tier", step=4, tier="local")
    o.event("train.report", step=5, loss=2.5)


def _lines(d):
    (path,) = glob.glob(os.path.join(d, "events.p*.jsonl"))
    with open(path) as f:
        events = [json.loads(line) for line in f]
    return os.path.basename(path), [
        {k: v for k, v in e.items() if k not in VOLATILE} for e in events]


def test_same_calls_same_lines(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUFLOW_ATTEMPT", "1")
    jobs.configure(str(tmp_path / "j"), proc=2)
    tobs.configure(str(tmp_path / "t"), proc=2, attempt=1)
    _drive(jobs)
    _drive(tobs)
    jobs.configure(None)
    tobs.configure(None)
    jname, jlines = _lines(str(tmp_path / "j"))
    tname, tlines = _lines(str(tmp_path / "t"))
    assert tname == jname == f"events.p00002.{os.getpid()}.jsonl"
    assert tlines == jlines
    assert [e["name"] for e in tlines][:2] == ["ckpt.upload", "flow.step"]
    assert tlines[1]["error"] == "RuntimeError"
    assert all(e["launch"] == 1 and e["proc"] == 2 for e in tlines)


def test_timed_iter_records_each_wait(tmp_path):
    tobs.configure(str(tmp_path / "t"))
    assert list(tobs.timed_iter(iter([1, 2, 3]), "data.batch_wait_s")) == [
        1, 2, 3]
    tobs.configure(None)
    waits = [e for e in _lines(str(tmp_path / "t"))[1]]
    assert [(e["kind"], e["name"]) for e in waits] == [
        ("histogram", "data.batch_wait_s")] * 3
    assert all(e["value"] >= 0 for e in waits)


def test_disabled_path_writes_nothing(tmp_path):
    assert not tobs.enabled() and tobs.recorder() is None
    _drive(tobs)
    assert list(tobs.timed_iter([1], "data.batch_wait_s")) == [1]
    # One shared no-op span; the iterable handed back untouched.
    assert tobs.span("flow.step") is tobs.span("flow.run")
    items = [1, 2]
    assert tobs.timed_iter(items, "data.batch_wait_s") is items
    assert tobs.dump_flight("sigterm") is None
    tobs.flush()
    assert os.listdir(tmp_path) == []


def test_buffer_bound_counts_drops(tmp_path):
    kw = dict(proc=0, flush_interval=60, max_buffered=3)
    jrec = jobs.Recorder(str(tmp_path / "j"), **kw)
    trec = tobs.Recorder(str(tmp_path / "t"), **kw)
    for rec in (jrec, trec):
        for i in range(5):
            rec.record("counter", "flow.retry", value=i)
        rec.close()
    assert trec.dropped == jrec.dropped == 2
    assert _lines(str(tmp_path / "t"))[1] == _lines(str(tmp_path / "j"))[1]


def test_merge_run_events_same_order(tmp_path):
    """Ties break by proc, a file keeps its order, a torn tail is
    skipped, and the merged file's bytes are the JAX merge's."""
    for side in ("j", "t"):
        d = os.path.join(tmp_path, side, "obs")
        os.makedirs(d)
        with open(os.path.join(d, "events.p00001.7.jsonl"), "w") as f:
            for seq, ts in (("p1-a", 5.0), ("p1-b", 5.0), ("p1-c", 1.0)):
                f.write(json.dumps({"kind": "event", "name": "train.report",
                                    "ts": ts, "proc": 1, "seq": seq}) + "\n")
            f.write('{"kind": "event", "na')  # a killed writer's tail
        with open(os.path.join(d, "events.p00000.9.jsonl"), "w") as f:
            for seq, ts in (("p0-a", 5.0), ("p0-b", 2.0)):
                f.write(json.dumps({"kind": "event", "name": "train.report",
                                    "ts": ts, "proc": 0, "seq": seq}) + "\n")
    jm = jobs.merge_run_events(str(tmp_path / "j"))
    tm = tobs.merge_run_events(str(tmp_path / "t"))
    assert tm == jm
    assert [e["seq"] for e in tm] == ["p1-c", "p0-b", "p0-a", "p1-a", "p1-b"]
    read = lambda side: open(os.path.join(  # noqa: E731
        tmp_path, side, "events.jsonl")).read()
    assert read("t") == read("j")
    assert tobs.merge_run_events(str(tmp_path / "t")) == tm  # idempotent
    assert tobs.merge_run_events(str(tmp_path / "none")) == []


def test_flight_dump_ring_and_marker(tmp_path):
    d = str(tmp_path / "obs")
    tobs.configure(d, proc=3, attempt=2)
    for i in range(300):
        tobs.counter("flow.retry", i)
    try:
        raise RuntimeError("boom")
    except RuntimeError as e:
        path = tobs.dump_flight("unhandled_exception", e)
    assert path == tobs.flight_path(d, 3) == jobs.flight_path(d, 3)
    with open(path) as f:
        dump = json.load(f)
    assert dump["reason"] == "unhandled_exception"
    assert (dump["proc"], dump["pid"], dump["attempt"]) == (3, os.getpid(), 2)
    assert "RuntimeError: boom" in dump["stack"]
    # The bounded ring: the newest 256 of 300.
    assert len(dump["events"]) == 256
    assert dump["events"][-1]["value"] == 299
    tobs.flush()
    (marker,) = [e for e in tobs.read_events(tobs.recorder().path)
                 if e["name"] == "obs.flight"]
    assert marker["path"] == path
    assert tobs.dump_flight("sigterm") == path  # the newest dump wins
    with open(path) as f:
        assert json.load(f)["reason"] == "sigterm"


def _port_emitted():
    """(file, kind, name) of every literal emitter call in the port, by
    the JAX catalog lint's own patterns."""
    out = []
    for path in glob.glob(os.path.join(REPO, "tpuflow_torch", "**", "*.py"),
                          recursive=True):
        src = open(path, encoding="utf-8").read()
        rel = os.path.relpath(path, REPO)
        for m in _API_RE.finditer(src):
            out.append((rel, m.group(1), m.group(2)))
        for m in _TIMED_ITER_RE.finditer(src):
            out.append((rel, "histogram", m.group(1)))
        for rx in (_RECORD_RE, _RAW_RECORD_RE):
            for m in rx.finditer(src):
                out.append((rel, m.group(1), m.group(2)))
    return out


def test_port_catalog_names_and_kinds():
    emitted = _port_emitted()
    bad = [(f, k, n) for f, k, n in emitted
           if n not in TCATALOG or TCATALOG[n][0] != k]
    assert not bad, f"emitted names off the port's catalog: {bad}"
    # Every catalog entry is emitted somewhere, with the JAX kind.
    assert {n for _, _, n in emitted} == set(TCATALOG)
    for name, (kind, _) in TCATALOG.items():
        assert JCATALOG[name][0] == kind == tobs.kind_of(name), name
    assert tobs.is_registered("ckpt.emergency_save")
    assert tobs.is_registered("train.step_s")
    assert tobs.is_registered("alert.fired")
    assert tobs.kind_of("registry.append") == "event"
    # The names the slice's events are read under.
    assert {"ckpt.emergency_save", "ckpt.restore_tier", "ckpt.corrupt",
            "ckpt.io_retry", "ckpt.gc", "ckpt.upload", "ckpt.save_failed",
            "flow.preempt", "flow.member_failed", "flow.run", "flow.step",
            "flow.gang_member", "train.report"} <= set(TCATALOG)


def test_flush_waits_for_the_batch_the_flush_thread_holds(tmp_path,
                                                          monkeypatch):
    """``flush()`` returns only once every batch taken before it is on
    disk, in the order taken: here the flush thread takes the first five
    events and is held inside its write (a patched ``open``) while five
    more are recorded and ``flush()`` is called; the events on disk when
    ``flush()`` returns must be all ten, in order."""
    rec_mod = importlib.import_module("tpuflow_torch.obs.recorder")
    held, release = threading.Event(), threading.Event()
    real_open = open

    def held_open(path, *args, **kwargs):
        if (threading.current_thread().name == "tpuflow-torch-obs-flush"
                and not held.is_set()):
            held.set()
            release.wait(10)
        return real_open(path, *args, **kwargs)

    monkeypatch.setattr(rec_mod, "open", held_open, raising=False)
    rec = rec_mod.Recorder(str(tmp_path), flush_interval=0.01)

    def steps_on_disk():
        with real_open(rec.path) as f:
            return [json.loads(line)["step"] for line in f]

    seen, calling = [], threading.Event()

    def flusher():
        calling.set()
        rec.flush()
        seen.extend(steps_on_disk())

    try:
        for i in range(5):
            rec.record("event", "train.report", step=i)
        assert held.wait(10), "the flush thread never took a batch"
        for i in range(5, 10):
            rec.record("event", "train.report", step=i)
        t = threading.Thread(target=flusher)
        t.start()
        assert calling.wait(10)
        t.join(0.5)  # the parent's flush() returned here at once
        release.set()
        t.join(10)
        assert seen == list(range(10))
        assert steps_on_disk() == list(range(10))
    finally:
        release.set()
        rec.close()
