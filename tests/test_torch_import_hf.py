"""Port parity for HuggingFace GPT-2 import and export
(``tpuflow_torch/models/import_hf.py``) on a randomly initialised
``transformers`` GPT-2 built from a local config (no download), as
``tests/test_hf_import.py`` does for the JAX package. Tolerances: the
port's logits within atol/rtol 2e-4 of HF's (that test's); the import
bit-equal to the JAX import moved through ``params_from_jax``; the export
round trip bit-equal."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import one_torch_thread  # noqa: F401
from tpuflow.models import import_hf as jhf
from tpuflow_torch.models import import_hf as thf
from tpuflow_torch.models.convert import params_from_jax
from tpuflow_torch.models.gpt2 import GPT2

transformers = pytest.importorskip("transformers")


def _tiny_hf(seed=0, **kw):
    torch.manual_seed(seed)
    cfg = transformers.GPT2Config(
        vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=4,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0, **kw)
    return transformers.GPT2LMHeadModel(cfg).eval(), cfg


@pytest.mark.parametrize("scan_layers", [False, True])
def test_imported_weights_match_hf_logits(scan_layers):
    """The port's forward on the imported weights gives HF's logits (the
    config's scan_layers changes nothing in the port's layout)."""
    hf, hf_cfg = _tiny_hf()
    cfg = thf.config_from_hf(hf_cfg, scan_layers=scan_layers)
    model = GPT2(cfg, seed=None, device="cpu")
    model.load_state_dict(thf.hf_gpt2_to_params(hf, cfg))
    tokens = np.arange(2 * 12).reshape(2, 12) % 128
    with torch.no_grad():
        ours = model(torch.from_numpy(tokens)).numpy()
        theirs = hf(torch.from_numpy(tokens)).logits.numpy()
    np.testing.assert_allclose(ours, theirs, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("source", ["model", "state_dict"])
def test_import_bit_equal_to_the_jax_import(source):
    """From the model or its state_dict: the port's tensors equal the JAX
    import run through params_from_jax, name for name, bit for bit."""
    hf, hf_cfg = _tiny_hf(seed=1)
    src = hf if source == "model" else hf.state_dict()
    got = thf.hf_gpt2_to_params(src, thf.config_from_hf(hf_cfg))
    want = params_from_jax(jhf.hf_gpt2_to_params(src,
                                                 jhf.config_from_hf(hf_cfg)))
    assert got.keys() == want.keys()
    for name in got:
        assert got[name].is_contiguous()
        assert torch.equal(got[name], want[name]), name


def test_export_round_trip():
    """params_to_hf_state_dict is the inverse: HF's own state_dict comes
    back bit-equal (the tied lm_head emitted), HF loads it, and the import
    of the export is the port's weights."""
    hf, hf_cfg = _tiny_hf(seed=2)
    cfg = thf.config_from_hf(hf_cfg)
    model = GPT2(cfg, seed=3, device="cpu")
    sd = thf.params_to_hf_state_dict(model, cfg)
    assert torch.equal(sd["lm_head.weight"], sd["transformer.wte.weight"])
    want = jhf.params_to_hf_state_dict(
        jhf.hf_gpt2_to_params(sd, jhf.config_from_hf(hf_cfg)),
        jhf.config_from_hf(hf_cfg))
    assert sd.keys() == want.keys()
    for k in sd:
        np.testing.assert_array_equal(sd[k].numpy(), want[k])
    back = thf.hf_gpt2_to_params(sd, cfg)
    for name, t in model.state_dict().items():
        assert torch.equal(back[name], t), name
    hf.load_state_dict(sd)
    tokens = torch.arange(16).reshape(1, 16)
    with torch.no_grad():
        np.testing.assert_allclose(model(tokens).numpy(),
                                   hf(tokens).logits.numpy(),
                                   atol=2e-4, rtol=2e-4)
    again = thf.hf_gpt2_to_params(hf.state_dict(), cfg)
    for name, t in model.state_dict().items():
        assert torch.equal(again[name], t), name


@pytest.mark.parametrize("field,value", [
    ("activation_function", "relu"),
    ("scale_attn_by_inverse_layer_idx", True),
    ("reorder_and_upcast_attn", True),
    ("scale_attn_weights", False),
    ("n_inner", 100),
])
def test_config_rejections_match_jax(field, value):
    """Every GPT-2 variant the JAX package refuses, the port refuses with
    the same message (the port names itself where the JAX one says
    "tpuflow")."""
    _, hf_cfg = _tiny_hf()
    setattr(hf_cfg, field, value)
    with pytest.raises(ValueError) as j:
        jhf.config_from_hf(hf_cfg)
    with pytest.raises(ValueError) as t:
        thf.config_from_hf(hf_cfg)
    assert str(t.value).replace("the port's", "the tpuflow") == str(j.value)


def test_config_from_hf_matches_jax():
    _, hf_cfg = _tiny_hf()
    hf_cfg.layer_norm_epsilon = 1e-6
    t = thf.config_from_hf(hf_cfg, n_layer=2)
    j = jhf.config_from_hf(hf_cfg, n_layer=2)
    for f in ("vocab_size", "n_ctx", "n_embd", "n_layer", "n_head",
              "dropout", "ln_eps"):
        assert getattr(t, f) == getattr(j, f), f


@pytest.mark.parametrize("case", ["moe", "moe_export", "untied", "vocab",
                                  "n_ctx", "n_embd", "n_layer"])
def test_import_rejections_match_jax(case):
    """An MoE config, an untied LM head and every shape mismatch raise on
    both sides."""
    hf, hf_cfg = _tiny_hf()
    sd = dict(hf.state_dict())
    cfg_t, cfg_j = thf.config_from_hf(hf_cfg), jhf.config_from_hf(hf_cfg)
    change = {"moe": dict(n_experts=2), "moe_export": dict(n_experts=2),
              "vocab": dict(vocab_size=64), "n_ctx": dict(n_ctx=32),
              "n_embd": dict(n_embd=32, n_head=4),
              "n_layer": dict(n_layer=3)}.get(case, {})
    cfg_t = dataclasses.replace(cfg_t, **change)
    cfg_j = dataclasses.replace(cfg_j, **change)
    if case == "untied":
        sd["lm_head.weight"] = sd["lm_head.weight"] + 1.0
    match = {"moe": "MoE", "moe_export": "MoE", "untied": "untied",
             "vocab": "vocab_size", "n_ctx": "n_ctx", "n_embd": "n_embd",
             "n_layer": "n_layer"}[case]
    if case == "moe_export":
        calls = (lambda: thf.params_to_hf_state_dict({}, cfg_t),
                 lambda: jhf.params_to_hf_state_dict({}, cfg_j))
    else:
        calls = (lambda: thf.hf_gpt2_to_params(sd, cfg_t),
                 lambda: jhf.hf_gpt2_to_params(sd, cfg_j))
    for call in calls:
        with pytest.raises(ValueError, match=match):
            call()
