"""FlowSpec base class, @step, Parameter, and the ``current`` singleton.

Counterpart of ``tpuflow/flow/spec.py``: subclass ``FlowSpec``, mark
methods ``@step``, chain with ``self.next(...)`` (optionally
``num_parallel=N`` for gang steps), declare CLI ``Parameter``s as class
attributes, assign ``self.<name>`` for persisted artifacts, and read
``current.*`` for runtime context (run id, storage path, trigger). The
checkpoint area keeps the JAX package's name, ``current.tpu_storage_path``,
so that runs of either package lay out alike."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


class Parameter:
    """CLI-exposed flow parameter. ``type`` is inferred from ``default`` if
    omitted."""

    def __init__(
        self,
        name: str,
        *,
        default: Any = None,
        help: str = "",
        type: type | None = None,
        required: bool = False,
    ):
        self.name = name
        self.default = default
        self.help = help
        self.required = required
        if type is not None:
            self.type = type
        elif default is not None:
            self.type = builtins_type(default)
        else:
            self.type = str

    def parse(self, raw: str) -> Any:
        if self.type is bool:
            return raw.lower() in ("1", "true", "yes", "on")
        return self.type(raw)


def builtins_type(v: Any) -> type:
    for t in (bool, int, float, str):
        if isinstance(v, t):
            return t
    return str


def step(fn: Callable) -> Callable:
    """Mark a method as a flow step."""
    fn.__is_step__ = True
    return fn


@dataclasses.dataclass
class _Transition:
    target: str
    num_parallel: int = 1


class _Trigger:
    """``current.trigger`` — set when a run was event-triggered; ``run`` is
    the upstream ``Run``."""

    def __init__(self, run):
        self.run = run


class _Current:
    """Runtime context singleton: the run, step and task being executed,
    the step's checkpoint area (``tpu_storage_path``) and the runner's
    node-local checkpoint tier (``ckpt_local_dir``, None: none), the
    trigger, the card buffer and the gang member's index and size."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.flow_name: str | None = None
        self.run_id: str | None = None
        self.step_name: str | None = None
        self.task_id: int | None = None
        self.tpu_storage_path: str | None = None
        self.ckpt_local_dir: str | None = None
        self.trigger: _Trigger | None = None
        self.card = None  # CardBuffer when the step has @card
        self.gang_index: int = 0
        self.gang_size: int = 1

    @property
    def pathspec(self) -> str:
        return f"{self.flow_name}/{self.run_id}/{self.step_name}/{self.task_id}"


current = _Current()


class FlowSpec:
    """Base class for flows. Subclasses define @step methods; execution is
    driven by ``tpuflow_torch.flow.runner`` via the generated CLI
    (``main()``)."""

    def __init__(self):
        self.__dict__["_artifacts"] = {}
        self.__dict__["_next"] = None

    # Artifact capture: plain attribute assignment persists.
    def __setattr__(self, name: str, value: Any):
        object.__setattr__(self, name, value)
        if not name.startswith("_"):
            self._artifacts[name] = value

    def next(self, target: Callable, *, num_parallel: int = 1) -> None:
        """Declare the next step (``num_parallel`` > 1: a gang step)."""
        if self._next is not None:
            raise RuntimeError("self.next() called twice in one step")
        name = getattr(target, "__name__", None)
        if name is None or not hasattr(type(self), name):
            raise ValueError(f"next() target must be a step method, got {target!r}")
        object.__setattr__(self, "_next", _Transition(name, num_parallel))

    # ------------------------------------------------------------ class info
    @classmethod
    def parameters(cls) -> dict[str, Parameter]:
        out = {}
        for klass in reversed(cls.__mro__):
            for k, v in vars(klass).items():
                if isinstance(v, Parameter):
                    out[k] = v
        return out

    @classmethod
    def steps(cls) -> dict[str, Callable]:
        out = {}
        for klass in reversed(cls.__mro__):
            for k, v in vars(klass).items():
                if callable(v) and getattr(v, "__is_step__", False):
                    out[k] = v
        return out

    @classmethod
    def main(cls, argv: list[str] | None = None):
        """CLI entry point: ``run|show|trigger|deploy ...`` (see
        ``tpuflow_torch.flow.runner.main``)."""
        from tpuflow_torch.flow.runner import main as runner_main

        return runner_main(cls, argv)
