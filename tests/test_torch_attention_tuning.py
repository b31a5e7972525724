"""The flash ``auto`` thresholds of ``tpuflow_torch/ops/attention.py``: a
tuning (a dict or a JSON file) over the shipped H100 crossovers, held to
the JAX package's ``_flash_min_seq`` precedence (``tpuflow/ops/
attention.py:80-170``) without its environment step: the effective
forward+backward threshold is the largest valid of ``flash_min_seq`` and
``flash_min_seq_bwd``, the forward one ``flash_min_seq_fwd``; a malformed
entry is ignored; no valid entry falls back to the shipped value."""

import importlib
import json

import pytest

from torch_parity import one_torch_thread  # noqa: F401
from tpuflow_torch.ops import attention as tattn

jattn = importlib.import_module("tpuflow.ops.attention")

TUNINGS = {
    "empty": {},
    "fwdbwd_only": {"flash_min_seq": 1024},
    "fwd_only": {"flash_min_seq_fwd": 256},
    "bwd_beats_fwdbwd": {"flash_min_seq": 512, "flash_min_seq_bwd": 2048},
    "fwdbwd_beats_bwd": {"flash_min_seq": 4096, "flash_min_seq_bwd": 1024},
    "bwd_alone": {"flash_min_seq_bwd": 768},
    "all": {"flash_min_seq": 640, "flash_min_seq_fwd": 320,
            "flash_min_seq_bwd": 700},
    "malformed_fwdbwd": {"flash_min_seq": "big", "flash_min_seq_bwd": 900},
    "malformed_all": {"flash_min_seq": -1, "flash_min_seq_fwd": 0,
                      "flash_min_seq_bwd": True},
    "float_entry": {"flash_min_seq": 1024.0, "flash_min_seq_fwd": 64},
    "null_entry": {"flash_min_seq": None, "flash_min_seq_fwd": 96},
}


@pytest.mark.filterwarnings("ignore:flash tuning entry")
@pytest.mark.parametrize("name", sorted(TUNINGS))
def test_thresholds_follow_the_jax_precedence(name, tmp_path, monkeypatch):
    """For each tuning, given as a dict and as a file, both paths'
    thresholds equal the JAX package's from the same tuning file (its env
    knobs unset), except where neither names a valid entry: there each
    package keeps its own shipped default."""
    tuning = TUNINGS[name]
    path = tmp_path / "flash_tuning.json"
    path.write_text(json.dumps(tuning))
    for knob in ("TPUFLOW_FLASH_MIN_SEQ", "TPUFLOW_FLASH_MIN_SEQ_FWD"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setattr(jattn, "_flash_tuning_cache", dict(tuning))
    monkeypatch.setattr(jattn, "_warned_malformed_tuning", True)
    for needs_bwd in (True, False):
        want = jattn._flash_min_seq(needs_bwd=needs_bwd)
        got = {tattn.flash_min_seq(needs_bwd=needs_bwd, tuning=t)
               for t in (tuning, str(path))}
        keys = (("flash_min_seq", "flash_min_seq_bwd") if needs_bwd
                else ("flash_min_seq_fwd",))
        valid = [tuning[k] for k in keys
                 if isinstance(tuning.get(k), int)
                 and not isinstance(tuning.get(k), bool) and tuning[k] > 0]
        if valid:
            assert got == {want} == {max(valid)}, (name, needs_bwd)
        else:
            assert got == {tattn.flash_min_seq(needs_bwd=needs_bwd)}
        start = got.pop()
        for T in (start - 1, start, start + 1):
            assert tattn.resolve_attention_impl(
                "auto", T, needs_bwd=needs_bwd, backend="cuda",
                tuning=tuning) == ("flash" if T >= start else "xla")
            assert tattn.resolve_attention_impl(
                "auto", T, needs_bwd=needs_bwd, backend="cpu",
                tuning=tuning) == "xla"


def test_malformed_entries_warn_and_are_ignored():
    with pytest.warns(UserWarning, match="not a positive integer"):
        assert tattn.flash_min_seq(tuning={"flash_min_seq": "x",
                                           "flash_min_seq_bwd": 300}) == 300
    with pytest.warns(UserWarning, match="not a positive integer"):
        assert tattn.flash_min_seq(
            needs_bwd=False, tuning={"flash_min_seq_fwd": -5}) == \
            tattn.flash_min_seq(needs_bwd=False)


@pytest.mark.parametrize("content", [None, "", "{not json", "[1, 2]",
                                     '"text"'])
def test_unreadable_tuning_files_give_the_shipped_thresholds(tmp_path,
                                                             content):
    """A missing, empty, broken or non-object file is no tuning."""
    path = tmp_path / "t.json"
    if content is not None:
        path.write_text(content)
    assert tattn.load_tuning(str(path)) == {}
    for needs_bwd in (True, False):
        assert tattn.flash_min_seq(needs_bwd=needs_bwd, tuning=str(path)) \
            == tattn.flash_min_seq(needs_bwd=needs_bwd)


def test_shipped_thresholds_are_the_measured_crossovers():
    """No tuning: the H100's crossovers (chip_smoke.py phase 11), flash
    from T = 128 on both paths; the JAX package's TPU values (2048, 512)
    are not the port's."""
    assert tattn.flash_min_seq(needs_bwd=True) == 128
    assert tattn.flash_min_seq(needs_bwd=False) == 128
    assert tattn.load_tuning(None) == {}
    assert (jattn._DEFAULT_FLASH_MIN_SEQ,
            jattn._DEFAULT_FLASH_MIN_SEQ_FWD) == (2048, 512)


@pytest.mark.parametrize("impl", ["flash", "xla", "auto"])
def test_padded_prefill_rows_take_the_dispatch(impl):
    """A left-padded fresh-cache prefill (the serving engine's bucketed
    admission): a row whose real tokens the dispatch sends to flash gets
    exactly the unpadded prompt's flash attention, so an engine answer
    matches a solo ``generate()`` whose dense prefill runs flash; every
    other row, and every pad row, is the masked attention as before."""
    import torch

    from tpuflow_torch.models import gpt2 as tgpt2

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((3, 40, 2, 16), generator=g) for _ in range(3))
    pads = torch.tensor([0, 5, 39])
    masked = tgpt2._left_pad_attention(q, k, v, pads)
    got = tgpt2._padded_prefill_attention(q, k, v, pads, impl)
    for b, pad in enumerate(pads.tolist()):
        if tattn.resolve_attention_impl(impl, 40 - pad, needs_bwd=False,
                                        backend="cpu") != "flash":
            assert torch.equal(got[b], masked[b])
            continue
        want = tattn.attention(q[b:b + 1, pad:], k[b:b + 1, pad:],
                               v[b:b + 1, pad:], causal=True, impl="flash",
                               needs_bwd=False)
        assert torch.equal(got[b:b + 1, pad:], want)
        assert torch.equal(got[b, :pad], masked[b, :pad])


def test_engine_equals_solo_generate_with_flash_prefills():
    """attn_impl="flash" on the CPU (the kernels' plain versions): the
    engine's bucketed, left-padded admissions answer every request with
    the tokens of a solo ``generate()``, whose dense prefill runs flash."""
    import numpy as np
    import torch

    from tpuflow_torch.infer.generate import generate
    from tpuflow_torch.infer.serve import ServeEngine
    from tpuflow_torch.models.gpt2 import GPT2, GPT2Config

    model = GPT2(GPT2Config.small_test(n_ctx=128, attn_impl="flash",
                                       dropout=0.0), seed=3, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 512, size=n) for n in (5, 17, 33, 61)]
    eng = ServeEngine(model, max_slots=4)
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    eng.run_until_idle()
    for p, r in zip(prompts, reqs):
        solo = generate(model, p[None, :], max_new_tokens=6,
                        temperature=0.0)[0].numpy()
        np.testing.assert_array_equal(r.result(), solo)
