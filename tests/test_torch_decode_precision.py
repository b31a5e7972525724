"""The decode entry points scope their float32 precision to their own call
(tpuflow_torch.device.f32_matmul_precision): the JAX model pins
``decode_precision`` per dot on the decode path only
(tpuflow/models/gpt2.py:120-128), so nothing else in the process changes.
A caller's TF32 flags and matmul precision are the same after each of
``generate()``, ``beam_search``, ``speculative_generate``, a
``ServeEngine``'s construction and run, and after each call that raises;
inside the call the model's forward sees true float32 (TF32 off)."""

import numpy as np
import pytest
import torch

from torch_parity import one_torch_thread  # noqa: F401
from tpuflow_torch.device import f32_matmul_precision
from tpuflow_torch.infer.beam import beam_search
from tpuflow_torch.infer.generate import generate
from tpuflow_torch.infer.serve import ServeEngine
from tpuflow_torch.infer.speculative import speculative_generate
from tpuflow_torch.models.gpt2 import GPT2, GPT2Config

PINNED = (False, False, "highest")


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


@pytest.fixture
def caller_flags():
    """TF32 on and precision "high", as a caller of the decode entry
    points may set them; the process's own flags restored after."""
    saved = _flags()
    torch.set_float32_matmul_precision("high")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    want = _flags()
    assert want == (True, True, "high")
    yield want
    torch.set_float32_matmul_precision(saved[2])
    torch.backends.cuda.matmul.allow_tf32 = saved[0]
    torch.backends.cudnn.allow_tf32 = saved[1]


@pytest.fixture(scope="module")
def model():
    return GPT2(GPT2Config.small_test(n_ctx=64, dropout=0.0), seed=0,
                device="cpu")


@pytest.fixture
def seen(model, monkeypatch):
    """The flags every forward of ``model`` ran under."""
    out = []
    forward = model.forward

    def spy(*a, **kw):
        out.append(_flags())
        return forward(*a, **kw)

    monkeypatch.setattr(model, "forward", spy)
    return out


PROMPT = np.tile(np.arange(1, 6), (2, 3))  # (2, 15), repeating: drafts hit


def _engine_run(model):
    eng = ServeEngine(model, max_slots=2, buckets=[16], decode_block=2,
                      page_size=8)
    return eng.generate_many(list(PROMPT), max_new_tokens=3)


CALLS = {
    "generate": lambda m: generate(m, PROMPT, max_new_tokens=3,
                                   temperature=0.0),
    "beam_search": lambda m: beam_search(m, PROMPT, beam_size=2,
                                         max_new_tokens=3),
    "speculative_generate": lambda m: speculative_generate(
        m, PROMPT, max_new_tokens=3, draft_len=2),
    "engine_run": _engine_run,
}
RAISING = {
    "generate": lambda m: generate(m, PROMPT, max_new_tokens=0),
    "beam_search": lambda m: beam_search(m, PROMPT, beam_size=0,
                                         max_new_tokens=3),
    "speculative_generate": lambda m: speculative_generate(
        m, PROMPT, max_new_tokens=3, draft_len=0),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_decode_calls_leave_the_callers_flags(name, model, caller_flags,
                                              seen):
    CALLS[name](model)
    assert _flags() == caller_flags
    assert seen and all(f == PINNED for f in seen), seen


@pytest.mark.parametrize("name", sorted(RAISING))
def test_decode_calls_that_raise_leave_the_callers_flags(name, model,
                                                         caller_flags):
    with pytest.raises(ValueError):
        RAISING[name](model)
    assert _flags() == caller_flags


def test_engine_construction_and_a_failing_step_leave_the_flags(
        model, caller_flags, monkeypatch):
    """Construction changes nothing (the engine does not depend on the
    flags staying put until its first step); a step that raises inside its
    scope restores them."""
    eng = ServeEngine(model, max_slots=1, buckets=[16], page_size=8)
    assert _flags() == caller_flags
    eng.submit(PROMPT[0], max_new_tokens=2)

    def fail(*a, **kw):
        assert _flags() == PINNED
        raise RuntimeError("admission failed")

    monkeypatch.setattr(eng, "_admit_one", fail)
    with pytest.raises(RuntimeError, match="admission failed"):
        eng.step()
    assert _flags() == caller_flags


def test_precision_none_and_nested_scopes():
    """``decode_precision=None`` leaves the flags alone; a nested scope
    restores the outer one's pin, not the caller's."""
    before = _flags()
    with f32_matmul_precision(False):
        assert _flags() == before
    with f32_matmul_precision():
        with f32_matmul_precision():
            assert _flags() == PINNED
        assert _flags() == PINNED
    assert _flags() == before
