"""Flow datastore: run directories, artifact persistence, run metadata.

Counterpart of ``tpuflow/flow/store.py``, with the same on-disk layout, so
that either package reads the other's runs::

    flows/<FlowName>/<run_id>/run.json
    flows/<FlowName>/<run_id>/<step>/<task_id>/artifacts.json (+ blobs,
                                                 then the artifacts.ok marker)
    flows/<FlowName>/<run_id>/tpu_storage/<step>/   # the checkpoint area
    events/<flow_name>.jsonl                        # trigger records

under the home directory: ``~/.tpuflow`` unless ``set_home`` (or the flow
CLI's ``--home``) names another. ``Checkpoint`` and ``Result`` artifacts
are stored as JSON references (``{"__type__": "checkpoint"}`` /
``{"__type__": "result"}``), never pickled tensors; plain JSON types stay
JSON; numpy arrays go to ``.npy``; anything else is pickled. A
``torch.Tensor`` anywhere in an artifact is rejected.
"""

from __future__ import annotations

import fcntl
import json
import os
import pickle
import time
from typing import Any

import numpy as np
import torch

from tpuflow_torch.ckpt import Checkpoint
from tpuflow_torch.utils import FileLock

_HOME: str | None = None


def set_home(path: str | None) -> str:
    """Root every later store call at ``path`` (None: the default
    ``~/.tpuflow``). Returns the absolute root."""
    global _HOME
    _HOME = os.path.abspath(os.path.expanduser(path)) if path else None
    return home()


def home() -> str:
    return _HOME or os.path.abspath(os.path.expanduser("~/.tpuflow"))


def flow_dir(flow: str) -> str:
    return os.path.join(home(), "flows", flow)


def run_dir(flow: str, run_id: str | int) -> str:
    return os.path.join(flow_dir(flow), str(run_id))


def task_dir(flow: str, run_id: str | int, step: str, task_id: int) -> str:
    return os.path.join(run_dir(flow, run_id), step, str(task_id))


def storage_dir(flow: str, run_id: str | int, step: str) -> str:
    """The step's checkpoint area (``current.tpu_storage_path``)."""
    return os.path.join(run_dir(flow, run_id), "tpu_storage", step)


def new_run_id(flow: str) -> int:
    """Monotonic per-flow run ids, atomic under concurrent launches."""
    d = flow_dir(flow)
    os.makedirs(d, exist_ok=True)
    with FileLock(os.path.join(d, ".id.lock")):
        path = os.path.join(d, "latest_run_id")
        last = 0
        if os.path.exists(path):
            with open(path) as f:
                last = int(f.read().strip() or 0)
        run_id = last + 1
        with open(path, "w") as f:
            f.write(str(run_id))
    return run_id


def latest_run_id(flow: str) -> int | None:
    path = os.path.join(flow_dir(flow), "latest_run_id")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return int(f.read().strip())


# ------------------------------------------------------------------ metadata
def write_run_meta(flow: str, run_id, meta: dict) -> None:
    d = run_dir(flow, run_id)
    os.makedirs(d, exist_ok=True)
    # Atomic replace: the client reads run.json while the run writes it.
    path = os.path.join(d, "run.json")
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1, default=str)
    os.replace(tmp, path)


def read_run_meta(flow: str, run_id) -> dict:
    with open(os.path.join(run_dir(flow, run_id), "run.json")) as f:
        return json.load(f)


# ----------------------------------------------------------------- artifacts
def _tensors(value: Any):
    """The torch.Tensors in ``value`` and the containers and dataclasses
    below it."""
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif isinstance(value, (list, tuple, set, frozenset)):
        for v in value:
            yield from _tensors(v)
    elif hasattr(value, "__dataclass_fields__"):
        for name in value.__dataclass_fields__:
            yield from _tensors(getattr(value, name, None))


def reject_device_arrays(name: str, value: Any) -> None:
    """Enforce the never-pickled-tensors artifact contract: a
    ``torch.Tensor`` inside an artifact (on the card or not) would ship
    through pickle across processes and runs. Device state travels as
    ``Checkpoint`` handles — path and metadata — so reject the tensor
    loudly instead."""
    for t in _tensors(value):
        raise TypeError(
            f"artifact {name!r} contains a torch.Tensor "
            f"({tuple(t.shape)}, {t.dtype}, on {t.device}): tensors are "
            "never pickled into artifacts — save them through the "
            "CheckpointManager and store the Checkpoint handle, or convert "
            "to numpy explicitly if the value is small host data"
        )


def _encode(name: str, value: Any, blob_dir: str) -> dict:
    from tpuflow_torch.train.trainer import Result

    if isinstance(value, Checkpoint):
        return {"__type__": "checkpoint", **value.to_json()}
    if isinstance(value, Result):
        return {"__type__": "result", "value": value.to_json()}
    reject_device_arrays(name, value)
    if isinstance(value, np.ndarray):
        fname = f"{name}.npy"
        np.save(os.path.join(blob_dir, fname), value)
        return {"__type__": "ndarray", "file": fname}
    try:
        json.dumps(value)
        return {"__type__": "json", "value": value}
    except (TypeError, ValueError):
        fname = f"{name}.pkl"
        with open(os.path.join(blob_dir, fname), "wb") as f:
            pickle.dump(value, f)
        return {"__type__": "pickle", "file": fname}


def _decode(entry: dict, blob_dir: str) -> Any:
    from tpuflow_torch.train.trainer import Result

    t = entry["__type__"]
    if t == "checkpoint":
        return Checkpoint.from_json(entry)
    if t == "result":
        return Result.from_json(entry["value"])
    if t == "ndarray":
        return np.load(os.path.join(blob_dir, entry["file"]))
    if t == "json":
        return entry["value"]
    if t == "pickle":
        with open(os.path.join(blob_dir, entry["file"]), "rb") as f:
            return pickle.load(f)
    raise ValueError(f"unknown artifact type {t!r}")


def save_artifacts(
    flow: str, run_id, step: str, task_id: int, artifacts: dict[str, Any],
    attempt: int = 0,
) -> None:
    d = task_dir(flow, run_id, step, task_id)
    os.makedirs(d, exist_ok=True)
    encoded = {k: _encode(k, v, d) for k, v in artifacts.items()}
    with open(os.path.join(d, "artifacts.json"), "w") as f:
        json.dump(encoded, f, indent=1)
    # Commit marker, written strictly after artifacts.json and its blobs: a
    # task that died mid-save leaves an unmarked directory. ``attempt``
    # records which launch of the step wrote the bytes.
    tmp = os.path.join(d, "artifacts.ok.tmp")
    with open(tmp, "w") as f:
        json.dump({"attempt": int(attempt), "ts": time.time()}, f)
    os.replace(tmp, os.path.join(d, "artifacts.ok"))


def load_artifacts(flow: str, run_id, step: str, task_id: int) -> dict[str, Any]:
    d = task_dir(flow, run_id, step, task_id)
    path = os.path.join(d, "artifacts.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        encoded = json.load(f)
    return {k: _decode(v, d) for k, v in encoded.items()}


# -------------------------------------------------------------------- events
def append_event(event: dict) -> None:
    d = os.path.join(home(), "events")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{event['flow']}.jsonl")
    line = json.dumps({**event, "ts": time.time()})
    # O_APPEND + flock: concurrent flows may finish at the same time.
    fd = os.open(path, os.O_CREAT | os.O_WRONLY | os.O_APPEND)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        os.write(fd, (line + "\n").encode())
    finally:
        os.close(fd)


def read_events(flow: str) -> list[dict]:
    path = os.path.join(home(), "events", f"{flow}.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
