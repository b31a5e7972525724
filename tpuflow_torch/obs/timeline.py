"""Run-level assembly of the per-process event files (the part of
``tpuflow/obs/timeline.py`` the flow runner needs): ``merge_run_events``
unions every ``<run_dir>/obs/events.p*.jsonl`` into one time-ordered
``<run_dir>/events.jsonl``; ``load_run_events`` reads a run's merged
stream."""

from __future__ import annotations

import json
import os

MERGED_NAME = "events.jsonl"
OBS_SUBDIR = "obs"


def obs_dir(run_dir: str) -> str:
    return os.path.join(run_dir, OBS_SUBDIR)


def read_events(path: str) -> list[dict]:
    """One JSONL event file, unparsable lines skipped (a killed writer
    may leave a torn tail)."""
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    except OSError:
        return []
    return out


def merge_run_events(run_dir: str, *, out_name: str = MERGED_NAME
                     ) -> list[dict]:
    """Merge every per-process event file under ``<run_dir>/obs`` into one
    ``<run_dir>/events.jsonl`` sorted by (``ts``, ``proc``); returns the
    events. Idempotent (the fragments stay; the merge is a view). A run
    with no events writes no file."""
    d = obs_dir(run_dir)
    try:
        names = sorted(n for n in os.listdir(d)
                       if n.startswith("events.p") and n.endswith(".jsonl"))
    except OSError:
        return []
    events: list[dict] = []
    for name in names:
        events.extend(read_events(os.path.join(d, name)))
    events.sort(key=lambda e: (e.get("ts", 0.0), e.get("proc", 0)))
    if events:
        out = os.path.join(run_dir, out_name)
        tmp = out + ".tmp"
        try:
            with open(tmp, "w") as f:
                for ev in events:
                    f.write(json.dumps(ev) + "\n")
            os.replace(tmp, out)
        except OSError:
            pass
    return events


def load_run_events(run_dir: str) -> list[dict]:
    """The run's merged event stream: ``events.jsonl`` once the runner
    merged it, else merged now from the per-process files."""
    path = os.path.join(run_dir, MERGED_NAME)
    if os.path.exists(path):
        return read_events(path)
    return merge_run_events(run_dir)
