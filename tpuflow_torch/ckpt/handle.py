"""Checkpoint handle: a path plus metadata, never the tensors.

Counterpart of ``tpuflow/ckpt/handle.py``: the reference that crosses runs
and flows (persisted as JSON) points at a committed checkpoint directory;
``as_directory`` serves the first of ``path`` and ``alt_paths`` that still
exists.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from typing import Any, Iterator


@dataclasses.dataclass
class Checkpoint:
    """Reference to a checkpoint directory written by CheckpointManager
    (``alt_paths``: other directories holding the same committed step)."""

    path: str
    metadata: dict[str, Any] = dataclasses.field(default_factory=dict)
    alt_paths: list[str] = dataclasses.field(default_factory=list)

    @classmethod
    def from_directory(cls, path: str, metadata: dict | None = None
                       ) -> "Checkpoint":
        """Wrap an existing checkpoint directory, reading its
        ``metadata.json`` when no metadata is given."""
        path = os.path.abspath(path)
        if not os.path.isdir(path):
            raise FileNotFoundError(f"checkpoint directory not found: {path}")
        meta_path = os.path.join(path, "metadata.json")
        if metadata is None and os.path.exists(meta_path):
            with open(meta_path) as f:
                metadata = json.load(f)
        return cls(path=path, metadata=metadata or {})

    @contextlib.contextmanager
    def as_directory(self) -> Iterator[str]:
        """A local directory with the checkpoint's contents: the first
        existing one among ``path`` and ``alt_paths``."""
        for candidate in [self.path, *self.alt_paths]:
            if os.path.isdir(candidate):
                yield candidate
                return
        raise FileNotFoundError(
            f"checkpoint directory gone: {self.path}"
            + (f" (and {len(self.alt_paths)} alternate tiers)"
               if self.alt_paths else ""))

    def to_json(self) -> dict:
        out = {"path": self.path, "metadata": self.metadata}
        if self.alt_paths:
            out["alt_paths"] = list(self.alt_paths)
        return out

    @classmethod
    def from_json(cls, obj: dict) -> "Checkpoint":
        return cls(path=obj["path"], metadata=obj.get("metadata", {}),
                   alt_paths=list(obj.get("alt_paths", [])))
