"""Port parity for GPT-2 (tpuflow_torch.models): the JAX model's params move
into the port through ``params_from_jax`` and both models see the same
seeded tokens. Float paths match within atol 1e-4 (f32 through a 2-layer
model; the frameworks sum in different orders)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_and_port_gpt2, one_torch_thread  # noqa: F401
from tpuflow.models.gpt2 import GPT2 as JGPT2
from tpuflow_torch.models.convert import params_from_jax
from tpuflow_torch.models.gpt2 import GPT2, GPT2Config, PagedKVCache

ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    return jax_and_port_gpt2()


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 512, size=shape).astype(
        np.int32
    )


def _apply(model, variables, toks, **kw):
    """``model.apply`` under jit (one compile beats op-by-op dispatch)."""
    static = tuple(k for k, v in kw.items() if isinstance(v, (bool, tuple)))
    fn = jax.jit(lambda var, t, **k: model.apply(var, t, **k),
                 static_argnames=static)
    return fn(variables, jnp.asarray(toks), **kw)


def _close(got, want):
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0
    )


def test_params_from_jax_unrolled_layout(pair):
    jm, params, tm = pair
    sd = params_from_jax(jax.device_get(params))
    assert set(sd) == set(tm.state_dict())
    # Flax Dense kernels are (in, out); nn.Linear weights are (out, in).
    k = np.asarray(params["h1"]["c_attn"]["kernel"])
    np.testing.assert_array_equal(sd["h.1.c_attn.weight"].numpy(), k.T)
    np.testing.assert_array_equal(
        sd["h.0.ln_2.weight"].numpy(), np.asarray(params["h0"]["ln_2"]["scale"])
    )


def test_params_from_jax_scan_layout_logits():
    """scan_layers stacks the blocks on a leading axis; the port reads
    layer i off it into h.<i> and gives the scanned JAX model's logits."""
    jm, params, tm = jax_and_port_gpt2(scan_layers=True)
    assert "h" in params and "h0" not in params
    toks = _tokens((2, 12), 1)
    want = _apply(jm, {"params": params}, toks)
    with torch.no_grad():
        _close(tm(torch.from_numpy(toks).long()), want)


def test_full_forward_logits(pair):
    jm, params, tm = pair
    toks = _tokens((2, 16), 2)
    with torch.no_grad():
        got = tm(torch.from_numpy(toks).long())
    assert got.dtype == torch.float32 and got.shape == (2, 16, 512)
    _close(got, _apply(jm, {"params": params}, toks))
    # Left-padded scoring forward (pad_lens, no cache).
    pads = np.array([0, 5], np.int32)
    want = _apply(jm, {"params": params}, toks, pad_lens=jnp.asarray(pads))
    with torch.no_grad():
        got = tm(torch.from_numpy(toks).long(),
                 pad_lens=torch.from_numpy(pads).long())
    _close(got, want)


@pytest.mark.parametrize("padded", [False, True])
def test_prefill_and_decode_logits(pair, padded):
    """Decode-mode prefill (the fresh-cache T x T path, dense or left-padded)
    then two single-token steps through the shared-index cache."""
    jm, params, tm = pair
    toks = _tokens((2, 10), 3)
    pads = np.array([3, 0], np.int32) if padded else None
    jp = None if pads is None else jnp.asarray(pads)
    tp = None if pads is None else torch.from_numpy(pads).long()
    want, v = _apply(jm, {"params": params}, toks, decode=True,
                     mutable=("cache",), pad_lens=jp, prefill=True)
    with torch.no_grad():
        got, cache = tm(torch.from_numpy(toks).long(), decode=True,
                        pad_lens=tp, prefill=True)
    _close(got, want)
    nxt = np.array(want[:, -1].argmax(-1), np.int32)
    for _ in range(2):
        want, v = _apply(jm, {"params": params, "cache": v["cache"]},
                         nxt[:, None], decode=True, mutable=("cache",),
                         pad_lens=jp)
        with torch.no_grad():
            got, cache = tm(torch.from_numpy(nxt[:, None]).long(),
                            decode=True, cache=cache, pad_lens=tp)
        _close(got, want)
        nxt = np.array(want[:, -1].argmax(-1), np.int32)
    assert cache.index == 12


def test_paged_slot_decode_matches_jax(pair):
    """Paged slot mode under one page table: writes route through the table
    (row 1's frontier crosses a page boundary), reads gather each row's
    logical view; logits and every non-trash pool page match JAX."""
    jm, params, tm = pair
    ps, n_pages = 8, 9
    jpm = JGPT2(dataclasses.replace(jm.config, kv_pages=n_pages,
                                    kv_page_size=ps))
    table = np.zeros((2, 64 // ps), np.int32)
    table[0, :2] = [3, 1]
    table[1, :3] = [2, 5, 7]
    pads = np.zeros((2,), np.int32)
    tcache = tm.init_paged_cache(n_pages, ps)
    assert isinstance(tcache, PagedKVCache) and tcache.page_size == ps
    jcache = None
    calls = [(_tokens((2, 3), 4), np.array([0, 6], np.int32)),
             (_tokens((2, 1), 5), np.array([3, 9], np.int32)),
             (_tokens((2, 1), 6), np.array([4, 10], np.int32))]
    for toks, slot in calls:
        variables = {"params": params}
        if jcache is not None:
            variables["cache"] = jcache
        want, v = _apply(
            jpm, variables, toks, decode=True, mutable=("cache",),
            pad_lens=jnp.asarray(pads), slot_index=jnp.asarray(slot),
            page_table=jnp.asarray(table),
        )
        jcache = v["cache"]
        with torch.no_grad():
            got, tcache = tm(
                torch.from_numpy(toks).long(), decode=True, cache=tcache,
                pad_lens=torch.from_numpy(pads).long(),
                slot_index=torch.from_numpy(slot).long(),
                page_table=torch.from_numpy(table).long(),
            )
        _close(got, want)
    for i in range(2):
        for ours, theirs in ((tcache.k[i], "cached_key"),
                             (tcache.v[i], "cached_value")):
            np.testing.assert_allclose(
                ours[1:].numpy(), np.asarray(jcache[f"h{i}"][theirs])[1:],
                atol=ATOL, rtol=0,
            )


@pytest.mark.parametrize("mode", ["dense", "padded", "int8", "paged"])
def test_decode_chunk_bit_equal_to_single_token_steps(pair, mode):
    """A (B, K+1) decode chunk (speculative decoding's verify forward) gives
    logits bit-equal to K+1 single-token steps through the same cache:
    every fp product of the chunk runs one (row, position) at a time, and
    the int8 matmul's sums are exact at any width."""
    from tpuflow_torch.infer.quant import quantize_model

    _, _, tm = pair
    model = quantize_model(tm, mode="fused_native") if mode == "int8" else tm
    B, K = 3, 4
    prompt = torch.from_numpy(_tokens((B, 9), 7)).long()
    chunk = torch.from_numpy(_tokens((B, K + 1), 8)).long()
    pads = torch.tensor([0, 2, 5]) if mode == "padded" else None
    if mode == "paged":
        table = torch.arange(1, B * 8 + 1).reshape(B, 8)

        def run(toks):
            cache = tm.init_paged_cache(B * 8 + 1, 8)
            slot = torch.zeros(B, dtype=torch.long)
            outs = []
            for t in [prompt] + toks:
                logits, cache = tm(t, decode=True, cache=cache,
                                   slot_index=slot, page_table=table)
                slot = slot + t.shape[1]
                outs.append(logits)
            return torch.cat(outs[1:], dim=1)
    else:
        def run(toks):
            _, cache = model(prompt, decode=True, pad_lens=pads,
                             prefill=True)
            outs = []
            for t in toks:
                logits, cache = model(t, decode=True, cache=cache,
                                      pad_lens=pads)
                outs.append(logits)
            return torch.cat(outs, dim=1)
    with torch.no_grad():
        whole = run([chunk])
        steps = run([chunk[:, j:j + 1] for j in range(K + 1)])
    assert whole.shape == (B, K + 1, 512)
    assert torch.equal(whole, steps)


def test_deferred_modes_raise(pair):
    _, _, tm = pair
    with pytest.raises(NotImplementedError, match="MoE"):
        GPT2(GPT2Config.small_test(n_experts=2), device="cpu")
    # Remat is ported (full and 'dots'); a jax.checkpoint_policies name
    # without a counterpart raises at build.
    with pytest.raises(NotImplementedError, match="remat_policy"):
        GPT2(GPT2Config.small_test(remat=True, remat_policy="nothing_saveable"),
             device="cpu")
    with pytest.raises(NotImplementedError, match="contiguous slot"):
        tm(torch.zeros((1, 1), dtype=torch.long), decode=True,
           slot_index=torch.zeros(1, dtype=torch.long))


def test_config_and_seeded_init():
    cfg = GPT2Config.from_preset("gpt2")
    assert (cfg.n_ctx, cfg.n_layer, cfg.n_embd, cfg.n_head,
            cfg.vocab_size) == (1024, 12, 768, 12, 50257)
    assert cfg.attn_impl == "auto" and cfg.remat
    assert cfg.compute_dtype(True) == torch.float32
    assert GPT2Config(dtype=torch.bfloat16).compute_dtype(False) == \
        torch.bfloat16
    assert GPT2Config(cache_dtype=torch.bfloat16).kv_cache_dtype() == \
        torch.bfloat16
    assert GPT2Config.medium().n_layer == 24
    small = GPT2Config.small_test(n_ctx=64)
    a = GPT2(small, seed=3, device="cpu")
    b = GPT2(small, seed=3, device="cpu")
    for (n, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), n
    # The Flax initialisers' spreads: normal(0.02) wte, normal(0.01) wpe,
    # lecun-normal kernels truncated at 2 std.
    assert abs(float(a.wte.detach().std()) - 0.02) < 2e-3
    assert abs(float(a.wpe.detach().std()) - 0.01) < 1e-3
    w = a.h[0].c_attn.weight.detach()
    assert abs(float(w.std()) - (1 / small.n_embd) ** 0.5) < 0.01
    assert float(w.abs().max()) <= 2 * (1 / small.n_embd) ** 0.5 / 0.8796
