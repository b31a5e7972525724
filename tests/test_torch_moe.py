"""Port parity for the Switch-MoE blocks (``tpuflow_torch/models/moe.py``
and the MoE block of ``models/gpt2.py``) against the JAX package.

Inputs are seeded numpy arrays, weights JAX-initialised and moved into
the port. Tolerances:
- ``MoEMLP`` output: atol 1e-5 (f32 products summed in another order);
  the load-balance aux: atol 1e-6; the routing (dispatch): exactly equal;
- a train step of a 2-layer GPT-2 with 4 experts: loss atol 1e-5, every
  gradient tensor within 2e-5 of its own max |g| (as the existing step
  parity holds them);
- greedy tokens: exactly equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_and_port_gpt2, one_torch_thread  # noqa: F401
from tpuflow.infer import generate as j_generate
from tpuflow.models.gpt2 import GPT2Config as JConfig
from tpuflow.models.losses import cross_entropy_loss as j_ce
from tpuflow.models.losses import sum_sown_losses as j_sum_sown
from tpuflow.models.moe import MoEMLP as JMoE
from tpuflow_torch.ckpt.tree import params_to_jax
from tpuflow_torch.data.lm import make_lm_loaders
from tpuflow_torch.infer.generate import generate
from tpuflow_torch.models.convert import named_params_from_jax, params_from_jax
from tpuflow_torch.models.gpt2 import GPT2, GPT2Config
from tpuflow_torch.models.losses import cross_entropy_loss, sum_sown_losses
from tpuflow_torch.models.moe import MoEMLP, capacity
from tpuflow_torch.train.gpt import _apply_remat_selector


def _pair(C=32, E=4, cf=1.25, seed=0):
    jm = JMoE(d_model=C, d_ff=4 * C, n_experts=E, capacity_factor=cf)
    x = jnp.zeros((1, 4, C))
    params = jm.init(jax.random.PRNGKey(seed), x, True)["params"]
    tm = MoEMLP(C, 4 * C, E, cf)
    tm.load_state_dict(named_params_from_jax(jax.device_get(params)))
    return jm, params, tm


def _jax_dispatch(jm, params, x):
    """The JAX module's (B, T, E, cap) dispatch tensor for ``x``: its
    first einsum operand, caught by intercepting the einsum."""
    seen = []
    real = jnp.einsum

    def spy(expr, *ops, **kw):
        if expr == "btec,btm->ebcm":
            seen.append(np.asarray(ops[0]))
        return real(expr, *ops, **kw)

    jnp.einsum = spy
    try:
        jm.apply({"params": params}, jnp.asarray(x), True,
                 mutable=["losses"])
    finally:
        jnp.einsum = real
    return seen[0]


@pytest.mark.parametrize("cf", [1.25, 0.5, 2.0])
def test_moe_mlp_matches_jax(cf):
    """Output, aux and routing against the JAX MoEMLP; at capacity 0.5
    tokens overflow their expert and are dropped (their output 0) on both
    sides."""
    B, T, C, E = 2, 24, 32, 4
    x = np.random.default_rng(0).standard_normal((B, T, C)).astype(np.float32)
    jm, params, tm = _pair(C, E, cf)
    out, sown = jm.apply({"params": params}, jnp.asarray(x), True,
                         mutable=["losses"])
    got, aux = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(aux.detach()),
                               float(j_sum_sown(sown)), atol=1e-6, rtol=0)
    _, onehot, dispatch, _ = tm.route(torch.from_numpy(x))
    np.testing.assert_array_equal(dispatch.numpy(),
                                  _jax_dispatch(jm, params, x))
    assert dispatch.shape == (B, T, E, capacity(T, cf, E))
    if cf < 1:
        # Tokens past their expert's buffer: dropped, their output 0.
        dropped = (dispatch.sum((-1, -2)) == 0).numpy()
        assert dropped.any()
        np.testing.assert_array_equal(np.asarray(out)[dropped], 0.0)
        np.testing.assert_array_equal(got.detach().numpy()[dropped], 0.0)


def test_capacity_is_the_jax_expression():
    for T in (1, 5, 7, 64, 543, 1024):
        for cf in (0.5, 1.0, 1.25, 2.0):
            for E in (2, 4, 8):
                assert capacity(T, cf, E) == max(1, int(-(-T * cf // E)))
    assert capacity(1024, 1.25, 8) == 160 and capacity(1, 1.25, 8) == 1


def test_argmax_ties_pick_the_first_expert():
    """A router with zero weights ties every expert: both sides send every
    token to expert 0 (and overflow its buffer)."""
    B, T, C, E = 1, 8, 16, 4
    jm, params, tm = _pair(C, E, 1.0)
    params = jax.tree_util.tree_map(jnp.zeros_like, params)
    with torch.no_grad():
        for p in tm.parameters():
            p.zero_()
    x = np.ones((B, T, C), np.float32)
    _, onehot, dispatch, _ = tm.route(torch.from_numpy(x))
    assert (onehot[..., 0] == 1).all()
    np.testing.assert_array_equal(dispatch.numpy(),
                                  _jax_dispatch(jm, params, x))
    assert int(dispatch.sum()) == capacity(T, 1.0, E)


@pytest.mark.parametrize("scan_layers", [False, True])
def test_gpt2_moe_params_convert_both_ways(scan_layers):
    """The block's moe/{gate/{kernel, bias}, w1, b1, w2, b2} map into the
    port and back, in both JAX layouts, bit for bit."""
    _, params, tm = jax_and_port_gpt2(n_experts=4, scan_layers=scan_layers)
    host = jax.device_get(params)
    back = params_to_jax(tm.state_dict(), scan_layers=scan_layers)
    want = jax.tree_util.tree_flatten_with_path(host)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, w in want:
        np.testing.assert_array_equal(got[path].numpy(), w)
    blk = back["h"]["block"] if scan_layers else back["h0"]
    assert sorted(blk["moe"]) == ["b1", "b2", "gate", "w1", "w2"]
    assert "mlp_fc" not in blk


@pytest.mark.parametrize("remat", [False, True])
def test_gpt2_moe_step_matches_jax(remat):
    """One forward+backward of a 2-layer GPT-2 with 4 experts, the summed
    aux in the loss, from the same weights and batch; under remat the aux
    is counted once (the recompute's aux is not returned)."""
    jm, params, tm = jax_and_port_gpt2(n_experts=4, remat=remat)
    b = list(make_lm_loaders(4, 1, 32, 512)[0])[0]

    def jloss(p):
        logits, upd = jm.apply({"params": p}, jnp.asarray(b["x"]),
                               train=True, rngs={"dropout":
                                                 jax.random.PRNGKey(1)},
                               mutable=["losses"])
        return j_ce(logits, jnp.asarray(b["y"])) + j_sum_sown(upd)

    jl, jg = jax.value_and_grad(jloss)(params)
    logits, aux = tm(torch.from_numpy(b["x"]), train=True, rng=1,
                     losses=True)
    assert len(aux) == 2
    tl = cross_entropy_loss(logits, torch.from_numpy(b["y"])) \
        + sum_sown_losses(aux)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-5, rtol=0)
    want = params_from_jax(jax.device_get(jg))
    for name, p in tm.named_parameters():
        w = want[name]
        err = float((p.grad - w).abs().max() / w.abs().max())
        assert err <= 2e-5, (name, err)


def test_aux_counted_once_under_remat():
    """Full remat re-runs each block in the backward: the forward still
    returns one aux a block, and the loss and gradients equal remat off."""
    cfg = GPT2Config.small_test(n_ctx=64, n_experts=4)
    b = list(make_lm_loaders(4, 1, 32, 512)[0])[0]
    x, y = torch.from_numpy(b["x"]), torch.from_numpy(b["y"])
    out = {}
    for mode in ("none", "full"):
        model = GPT2(_apply_remat_selector(cfg, mode), seed=0, device="cpu")
        logits, aux = model(x, train=True, rng=3, losses=True)
        assert len(aux) == cfg.n_layer
        loss = cross_entropy_loss(logits, y) + sum_sown_losses(aux)
        loss.backward()
        out[mode] = (loss, [p.grad for p in model.parameters()])
    assert torch.equal(out["none"][0], out["full"][0])
    for a, c in zip(out["none"][1], out["full"][1]):
        assert torch.equal(a, c)


@pytest.mark.parametrize("scan_layers", [False, True])
def test_generate_tokens_equal_jax(scan_layers):
    """Greedy decoding of an MoE GPT-2 (prefill at the prompt's T, then one
    token a step: capacity 1) gives the JAX package's tokens."""
    jm, params, tm = jax_and_port_gpt2(n_experts=4, scan_layers=scan_layers)
    prompt = np.random.default_rng(0).integers(0, 512, (2, 9))
    want = np.asarray(j_generate(jm, params, jnp.asarray(prompt, jnp.int32),
                                 max_new_tokens=12, temperature=0.0))
    got = generate(tm, prompt, max_new_tokens=12, temperature=0.0).numpy()
    np.testing.assert_array_equal(got, want)


def test_moe_eval_forward_matches_jax():
    """A train=False forward (the eval step's) returns logits only and
    equals the JAX forward (its sown aux is dropped there too)."""
    jm, params, tm = jax_and_port_gpt2(n_experts=2)
    x = np.random.default_rng(1).integers(0, 512, (2, 16))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_serving_paths_raise_on_moe():
    """The engine, speculative decoding and int8 quantization, which
    raised on an MoE model, accept one (their parity with the JAX package:
    tests/test_torch_moe_serve.py). The engine's row rule: each request of
    a 3-slot engine, speculative and int8 ones among them, equals the same
    request alone in a 1-slot engine; the fused-native leaves hold the
    router's."""
    from tpuflow_torch.infer.quant import quantize_model
    from tpuflow_torch.infer.serve import ServeEngine
    from tpuflow_torch.infer.speculative import speculative_generate

    tm = GPT2(GPT2Config.small_test(n_ctx=64, n_experts=2), device="cpu")
    rng = np.random.default_rng(7)
    prompts = [np.tile(rng.integers(0, 512, 4), 3)[:L] for L in (12, 5, 9)]
    flags = [(False, True), (True, False), (True, True)]
    kw = dict(buckets=[8, 16], decode_block=4, page_size=8,
              quant="fused_native", speculative=2)
    eng = ServeEngine(tm, max_slots=3, **kw)
    reqs = [eng.submit(p, max_new_tokens=6, quantize=q, speculative=sp)
            for p, (q, sp) in zip(prompts, flags)]
    eng.run_until_idle(max_iters=50)
    for p, (q, sp), r in zip(prompts, flags, reqs):
        alone = ServeEngine(tm, max_slots=1, **kw).generate_many(
            [p], max_new_tokens=6, quantize=q, speculative=sp)[0]
        np.testing.assert_array_equal(r.result(), alone)
    toks = speculative_generate(tm, prompts[0][None], max_new_tokens=4,
                                draft_len=2)
    assert toks.shape == (1, 4)
    assert "h.1.moe.gate" in quantize_model(tm, min_size=256).leaves


def test_config_fields_match_jax():
    """capacity_factor and moe_aux_weight default as the JAX config's, and
    the presets carry n_experts."""
    for f in ("n_experts", "capacity_factor", "moe_aux_weight"):
        assert getattr(GPT2Config(), f) == getattr(JConfig(), f)
    for preset in ("test", "gpt2", "medium"):
        t = GPT2Config.from_preset(preset, n_experts=8)
        j = JConfig.from_preset(preset, n_experts=8)
        assert (t.n_experts, t.scan_layers) == (j.n_experts, j.scan_layers)
    model = GPT2(dataclasses.replace(GPT2Config.small_test(), n_experts=2),
                 device="cpu")
    assert isinstance(model.h[0].moe, MoEMLP) and model.sows_losses
    assert not hasattr(model.h[0], "mlp_fc")
