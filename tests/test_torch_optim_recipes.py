"""Port parity for Lion and Adafactor (``tpuflow_torch/train/optim.py``)
against ``optax.lion`` and ``optax.adafactor`` through the JAX factory.

Inputs are seeded numpy arrays handed to both sides. Tolerances:
- params after each of three updates: atol 1e-6 (params of unit scale;
  the port reads the schedule in float64, optax in float32);
- every optimizer state leaf: its shape equal to optax's, its values
  within 1e-6 of the leaf's largest magnitude (f32 arithmetic in another
  order; Lion's momentum mixes signed gradients, so an element near 0
  carries the rounding of the terms that cancelled there). Adafactor's
  statistics are sums of squares: within rtol 1e-6 element by element.

The leaf grouping (``ckpt/tree.py::JaxLeaves``) is held on a GPT-2 in
both JAX param layouts: Adafactor's factored statistics follow the JAX
leaf (Dense kernels (in, out); under ``scan_layers`` one (L, in, out)
leaf a name) and its block RMS spans the whole leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import jax_and_port_gpt2, one_torch_thread  # noqa: F401
from tpuflow.train import optim as joptim
from tpuflow_torch.ckpt.tree import JaxLeaves
from tpuflow_torch.models.convert import params_from_jax
from tpuflow_torch.train import optim as toptim

# A stacked (L, in, out) leaf, a square matrix (argsort picks its axes by
# order), a vector and a small matrix (both unfactored), and a matrix
# whose second largest axis is exactly the 128 that factors.
SHAPES = [(3, 200, 130), (256, 256), (4,), (5, 4), (140, 128)]
RECIPES = {
    "constant": dict(),
    "constant_wd0": dict(weight_decay=0.0),
    "cosine_warmup_clip": dict(schedule="cosine", warmup_steps=1,
                               decay_steps=4, grad_clip_norm=0.5),
    "cosine_clip_wd0": dict(schedule="cosine", decay_steps=4,
                            grad_clip_norm=50.0, weight_decay=0.0),
}


def _inner(state, kw):
    """optax's per-parameter chain state (under the clip when there is
    one)."""
    return state[1] if kw.get("grad_clip_norm") else state


def _state_equal(opt, name, jstate, kw):
    """Every state leaf of ``opt`` has optax's shape and values."""
    first = _inner(jstate, kw)[0]
    assert opt.count == int(first.count)
    slots = {**opt.slots(), **opt.leaf_slots()}
    assert set(slots) == ({"mu"} if name == "lion"
                          else {"v_row", "v_col", "v"})
    for slot, got in slots.items():
        for a, b in zip(got, getattr(first, slot)):
            assert tuple(a.shape) == b.shape, (slot, a.shape, b.shape)
            b = np.asarray(b)
            atol = 1e-6 * np.abs(b).max() if name == "lion" else 0.0
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=atol,
                                       err_msg=slot)


@pytest.mark.parametrize("recipe", sorted(RECIPES))
@pytest.mark.parametrize("name", ["lion", "adafactor"])
def test_matches_optax(name, recipe):
    """Three updates: params after every one, and every state leaf after
    the last, match optax."""
    kw = dict(optimizer=name, **RECIPES[recipe])
    rng = np.random.default_rng(2)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in range(3)]
    tx = joptim.make_optimizer(0.1, **kw)
    jp = [jnp.asarray(p) for p in params]
    jstate = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = toptim.make_optimizer(tp, 0.1, **kw)
    for g in grads:
        updates, jstate = tx.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        opt.update([torch.from_numpy(x) for x in g])
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=0)
    _state_equal(opt, name, jstate, kw)
    assert opt.scheduled == ("schedule" in kw)


@pytest.mark.parametrize("scan_layers", [False, True])
@pytest.mark.parametrize("name", ["lion", "adafactor"])
def test_gpt2_leaves_match_optax(name, scan_layers):
    """Three updates of a 2-layer GPT-2's parameters from seeded gradients:
    the port, its parameters grouped by ``JaxLeaves``, against optax on the
    JAX param tree of either layout: params after every update, and
    Adafactor's statistics leaf for leaf, JAX path by JAX path."""
    _, params, tm = jax_and_port_gpt2(scan_layers=scan_layers)
    host = jax.device_get(params)
    rng = np.random.default_rng(3)
    grads = [jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), host)
        for _ in range(3)]
    kw = dict(optimizer=name, schedule="cosine", decay_steps=4,
              grad_clip_norm=1.0, weight_decay=1e-4)
    tx = joptim.make_optimizer(1e-2, **kw)
    jp = params
    jstate = tx.init(jp)
    leaves = JaxLeaves(tm, scan_layers)
    names = [n for n, _ in tm.named_parameters()]
    opt = toptim.make_optimizer(tm.parameters(), 1e-2, leaves=leaves, **kw)
    for g in grads:
        updates, jstate = tx.update(g, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        sd = params_from_jax(g)
        with torch.no_grad():
            opt.update([sd[n] for n in names])
        want = params_from_jax(jax.device_get(jp))
        for n, p in tm.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                       atol=1e-6, rtol=0, err_msg=n)
    first = jstate[1][0]
    if name == "lion":
        want = params_from_jax(jax.device_get(first.mu))
        for n, m in zip(names, opt.mu):
            w = want[n].numpy()
            np.testing.assert_allclose(m.numpy(), w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max(), err_msg=n)
        return
    for slot in ("v_row", "v_col", "v"):
        got = leaves.tree(getattr(opt, slot))
        flat = jax.tree_util.tree_flatten_with_path(
            jax.device_get(getattr(first, slot)))[0]
        assert len(flat) == len(leaves.paths)
        for path, want in flat:
            node = got
            for key in path:
                node = node[key.key]
            assert tuple(node.shape) == want.shape, (slot, path)
            np.testing.assert_allclose(node.numpy(), want, rtol=1e-6,
                                       atol=0, err_msg=f"{slot} {path}")


def test_factored_dims_follow_optax():
    """argsort's choice of the two factored axes, the 128 floor and the
    vectors, as optax computes them."""
    from optax._src.factorized import _factored_dims

    for shape in [(768, 2304), (2304, 768), (768, 768), (12, 768, 768),
                  (12, 768, 3072), (8, 768, 3072), (127, 4096), (128, 128),
                  (3, 200, 130), (50257, 768), (768,), (12, 768)]:
        assert toptim._factored_dims(shape) == _factored_dims(shape, True,
                                                              128), shape


def test_lion_sign_of_zero_is_zero():
    """A zero gradient on a zero momentum moves nothing (sign(0) = 0)
    beyond the weight decay."""
    p = [torch.ones(3)]
    opt = toptim.make_optimizer(p, 0.1, optimizer="lion", weight_decay=0.0)
    opt.update([torch.zeros(3)])
    assert torch.equal(p[0], torch.ones(3))
    assert torch.equal(opt.mu[0], torch.zeros(3))
