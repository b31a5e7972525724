"""The port's ViT (``tpuflow_torch.models.vit``) against the JAX package's
Flax ViT, on the CPU: 2 layers, 32 wide, 2 heads of 16, patch 4 on
32 x 32 x 3 images, so T = 65 tokens (64 patches and the CLS token).

One set of weights (JAX-initialised, ``pos_embed`` and the CLS token
drawn from a numpy seed so neither is trivial) goes into both through
``vit_params_from_jax``. Per attention implementation:

- ``"xla"``: the einsum attention on both sides;
- ``"flash"``: the JAX Pallas flash kernels in interpret mode (the JAX
  package's own CPU tests run them so; T = 65 is one 65-row block) against
  the port's CPU path, the kernels' plain versions (blockwise forward
  with lse, the fused pair's plain dq and dk/dv), non-causal.

Logits (eval and train forwards) within 1e-5 of the largest |logit|, the
cross-entropy loss within 1e-6 relative, and every gradient within 2e-5
of its tensor's largest |gradient| (f32; the GPT-2 step-parity limits:
the same products summed in another order). bf16 (``dtype``): logits
within 2e-2 of the largest |logit|, a few bf16 ulps (2^-8 = 3.9e-3
each): each side rounds its products to bf16 in its own order, and
either side's bf16 logits lie about as far from its f32 ones. The Flax
tree round-trips through
``vit_params_to_jax`` with the ``model.init`` names and shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpuflow.models import get_model as j_get_model
from tpuflow_torch.models import get_model
from tpuflow_torch.models.convert import vit_params_from_jax, vit_params_to_jax
from tpuflow_torch.models.losses import cross_entropy_loss

KW = dict(num_classes=10, patch_size=4, n_embd=32, n_layer=2, n_head=2)
SHAPE = (4, 32, 32, 3)
LOGIT_RTOL = 1e-5
GRAD_RTOL = 2e-5


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(impl, jdtype=jnp.float32, tdtype=torch.float32):
    jm = j_get_model("vit", attn_impl=impl, dtype=jdtype, **KW)
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, *SHAPE[1:]))))["params"]
    r = np.random.default_rng(0)
    params = dict(params)
    for k in ("cls", "pos_embed"):
        params[k] = (0.5 * r.standard_normal(params[k].shape)).astype(
            np.float32)
    tm = get_model("vit", attn_impl=impl, dtype=tdtype,
                   image_shape=SHAPE[1:], **KW)
    tm.load_state_dict(vit_params_from_jax(params))
    return jm, params, tm


def _batch():
    r = np.random.default_rng(1)
    return (r.standard_normal(SHAPE).astype(np.float32),
            r.integers(0, 10, SHAPE[0]).astype(np.int32))


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_logits_loss_and_gradients_match_jax(impl):
    jm, params, tm = _models(impl)
    x, y = _batch()
    want = np.asarray(jax.jit(jm.apply)({"params": params}, x))
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_RTOL * np.abs(want).max())

    def loss_fn(p):
        logits = jm.apply({"params": p}, x, train=True)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    loss = cross_entropy_loss(tm(torch.from_numpy(x), train=True, rng=0),
                              torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    grads = vit_params_to_jax({n: p.grad for n, p in tm.named_parameters()})
    flat = dict(jax.tree_util.tree_flatten_with_path(
        jax.device_get(jgrads))[0])
    got = jax.tree_util.tree_flatten_with_path(grads)[0]
    assert len(got) == len(flat)
    for path, g in got:
        want = np.asarray(flat[path])
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=GRAD_RTOL * np.abs(want).max(),
                                   err_msg=str(path))


def test_bf16_logits_match_jax():
    jm, params, tm = _models("xla", jnp.bfloat16, torch.bfloat16)
    x, _ = _batch()
    want = np.asarray(jax.jit(jm.apply)({"params": params}, x))
    got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


def test_param_tree_round_trips_with_the_flax_names():
    jm, params, tm = _models("xla")
    tree = vit_params_to_jax(tm.state_dict())
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(params)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(tree)[0],
            jax.tree_util.tree_flatten_with_path(params)[0]):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=str(path))
    with pytest.raises(ValueError, match="patch_size 5 must divide"):
        get_model("vit", patch_size=5, image_shape=SHAPE[1:])
