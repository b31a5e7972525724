"""The port's ResNet-18/50 (``tpuflow_torch.models.resnet``) against the JAX
package's Flax models, on the CPU at width 8.

One set of weights goes into both (JAX-initialised and moved into the
port through ``resnet_params_from_jax``):

- ResNet-18 with the CIFAR stem on 32 x 32 x 3 and ResNet-50 with the
  ImageNet stem on 64 x 64 x 3 (so the 7 x 7/2 stem's (2, 3) padding, the
  3 x 3/2 convolutions' (0, 1) padding and the -inf-padded max pool all
  run), with BatchNorm scales, biases and running statistics perturbed
  from a numpy seed so that no branch is trivial: logits in eval mode
  (running statistics) and train mode (batch statistics), and the moved
  running statistics, within 2e-5 of the largest |logit| and atol 2e-5
  (f32, the same products summed in another order).
- Three SGD-momentum steps (lr 0.05, momentum 0.9) from the JAX
  ``create_train_state``'s own initial state, against its
  ``make_train_step``: every parameter and running statistic within atol
  1e-5; with ``accum_steps=2`` the statistics move once per microbatch
  on both sides. The perturbed weights are left out here: their
  BatchNorms see means far above their spreads, where the fast
  variance's cancellation turns summation-order rounding into loss
  differences beyond these limits within two steps, on either side.
- The Flax trees: the port's ``checkpoint_tree`` has the JAX
  ``_state_tree``'s keys and shapes, ``params`` and ``batch_stats``
  alike, with the auto-names taken from ``model.init``.
- The Flax BatchNorm semantics themselves: momentum 0.99, epsilon 1e-5,
  the biased fast variance, zero-initialised last scales, and that
  torch's symmetric padding is not Flax's ``"SAME"`` at stride 2.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "flows"))

import my_tpu_module as jmod  # noqa: E402
from tpuflow.models import get_model as j_get_model  # noqa: E402
from tpuflow.train.step import create_train_state as j_create_train_state
from tpuflow.train.step import make_train_step as j_make_train_step
from tpuflow_torch.ckpt.tree import checkpoint_tree  # noqa: E402
from tpuflow_torch.models import get_model  # noqa: E402
from tpuflow_torch.models.convert import (  # noqa: E402
    resnet_params_from_jax,
    resnet_params_to_jax,
)
from tpuflow_torch.models.resnet import BatchNorm, Conv  # noqa: E402
from tpuflow_torch.train.step import (  # noqa: E402
    create_train_state,
    make_train_step,
)

CASES = {
    "resnet18": (dict(width=8, small_inputs=True), (8, 32, 32, 3)),
    "resnet50": (dict(width=8, small_inputs=False), (8, 64, 64, 3)),
}
LOGIT_RTOL = 2e-5
STATS_ATOL = 2e-5
STEP_ATOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(name, seed=0, perturbed=True):
    """(jax model, numpy variables, port model) with shared weights: the
    JAX initial ones, BatchNorm leaves perturbed unless told not to."""
    kw, shape = CASES[name]
    jm = j_get_model(name, num_classes=10, **kw)
    v = jax.device_get(jax.jit(jm.init, static_argnames="train")(
        jax.random.PRNGKey(seed), jnp.zeros((1, *shape[1:])), train=False))
    r = np.random.default_rng(seed)

    def perturb(tree, stats):
        out = {}
        for k, x in tree.items():
            if isinstance(x, dict):
                out[k] = perturb(x, stats)
            elif not perturbed:
                out[k] = np.asarray(x)
            elif k in ("scale", "bias", "mean"):
                out[k] = (x + 0.2 * r.standard_normal(x.shape)).astype(
                    np.float32)
            elif k == "var":
                out[k] = (x + 0.5 * r.random(x.shape)).astype(np.float32)
            else:
                out[k] = np.asarray(x)
        return out

    variables = {"params": perturb(v["params"], False),
                 "batch_stats": perturb(v["batch_stats"], True)}
    tm = get_model(name, num_classes=10, in_channels=shape[-1], **kw)
    tm.load_state_dict(resnet_params_from_jax(variables["params"],
                                              variables["batch_stats"]))
    return jm, variables, tm


def _x(name, seed=1):
    shape = CASES[name][1]
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _assert_tree_close(got, want, atol, what):
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_g) == len(flat_w) > 0
    for path, g in flat_g:
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(g, np.asarray(flat_w[path]), rtol=0,
                                   atol=atol, err_msg=f"{what} {path}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_logits_and_moved_statistics_match_jax(name):
    jm, v, tm = _models(name)
    x = _x(name)
    apply = jax.jit(jm.apply, static_argnames=("train", "mutable"))
    want = np.asarray(apply(v, x, train=False))
    got = tm(torch.from_numpy(x), train=False).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_RTOL * np.abs(want).max())
    want, upd = apply(v, x, train=True, mutable=("batch_stats",))
    got = tm(torch.from_numpy(x), train=True).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=LOGIT_RTOL * np.abs(want).max())
    _assert_tree_close(resnet_params_to_jax(tm.state_dict())[1],
                       jax.device_get(upd["batch_stats"]), STATS_ATOL,
                       "batch_stats")


@pytest.mark.parametrize("name,accum", [("resnet18", 1), ("resnet18", 2),
                                        ("resnet50", 1)])
def test_three_sgd_steps_match_jax(name, accum):
    jm, v, tm = _models(name, perturbed=False)
    lr = 0.05
    jstate = j_create_train_state(jm, jax.random.PRNGKey(0),
                                  jnp.zeros((1, *CASES[name][1][1:])),
                                  optax.sgd(lr, momentum=0.9))
    jstate = jstate.replace(
        params=jax.tree_util.tree_map(jnp.asarray, v["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]))
    tstate = create_train_state(tm, lr)
    jstep = j_make_train_step(accum_steps=accum)
    tstep = make_train_step(accum_steps=accum)
    r = np.random.default_rng(2)
    for i in range(3):
        batch = {"x": _x(name, seed=10 + i),
                 "y": r.integers(0, 10, CASES[name][1][0]).astype(np.int32)}
        jstate, jm_ = jstep(jstate, jax.tree_util.tree_map(jnp.asarray,
                                                           batch),
                            jax.random.PRNGKey(1))
        tstate, tm_ = tstep(tstate, batch, 1)
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]),
                                   rtol=1e-5)
    params, stats = resnet_params_to_jax(tstate.model.state_dict())
    _assert_tree_close(params, jax.device_get(jstate.params), STEP_ATOL,
                       "params")
    _assert_tree_close(stats, jax.device_get(jstate.batch_stats), STEP_ATOL,
                       "batch_stats")


@pytest.mark.parametrize("name", sorted(CASES))
def test_checkpoint_tree_has_the_flax_layout(name):
    jm, v, tm = _models(name)
    jstate = j_create_train_state(jm, jax.random.PRNGKey(0),
                                  jnp.zeros((1, *CASES[name][1][1:])),
                                  optax.sgd(0.1, momentum=0.9))
    want = jax.tree_util.tree_map(lambda a: tuple(np.shape(a)),
                                  jmod._state_tree(jstate))
    got = jax.tree_util.tree_map(
        lambda t: tuple(t.shape),
        checkpoint_tree(create_train_state(tm, 0.1), abstract=True),
        is_leaf=lambda t: isinstance(t, torch.Tensor))
    assert sorted(got) == sorted(want) == ["batch_stats", "opt_state",
                                           "params", "step"]
    for key in ("params", "batch_stats"):
        assert jax.tree_util.tree_structure(got[key]) == \
            jax.tree_util.tree_structure(want[key])
        assert got[key] == want[key]
    assert got["opt_state"]["0"]["trace"] == want["params"]


def test_flax_batchnorm_semantics():
    """One train forward of ``BatchNorm`` against Flax ``nn.BatchNorm`` on
    an NHWC input with a large mean (where the fast variance differs most
    from a two-pass one), the running statistics moved by 1 - 0.99 toward
    the biased batch statistics."""
    import flax.linen as nn

    x = (np.random.default_rng(0).standard_normal((4, 5, 5, 3)) * 2 + 3
         ).astype(np.float32)
    fb = nn.BatchNorm(use_running_average=False)
    fv = fb.init(jax.random.PRNGKey(0), x)
    want, upd = fb.apply(fv, x, mutable=["batch_stats"])
    bn = BatchNorm(3)
    assert (bn.momentum, bn.eps) == (0.99, 1e-5)
    got = bn(torch.from_numpy(x).permute(0, 3, 1, 2), True)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(want), rtol=0, atol=1e-5)
    flat = x.reshape(-1, 3)
    np.testing.assert_allclose(bn.mean.numpy(), 0.01 * flat.mean(0),
                               rtol=1e-5)
    np.testing.assert_allclose(bn.var.numpy(), 0.99 + 0.01 * flat.var(0),
                               rtol=1e-5)
    np.testing.assert_allclose(bn.var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-6)
    bn.eval()
    assert torch.equal(bn(torch.zeros(1, 3, 1, 1), False).flatten(),
                       torch.zeros(3) - bn.mean * torch.rsqrt(
                           bn.var + 1e-5))
    m = get_model("resnet18", width=8)
    assert not m.BasicBlock_0.BatchNorm_1.weight.detach().any()
    assert bool((m.BasicBlock_0.BatchNorm_0.weight == 1.0).all())


def test_same_padding_is_not_symmetric_at_stride_two():
    """A 3 x 3/2 convolution on an even input: Flax ``"SAME"`` pads (0, 1),
    which ``Conv`` reproduces; torch's ``padding=1`` samples other rows."""
    import flax.linen as nn

    x = np.random.default_rng(0).standard_normal((2, 8, 8, 4)).astype(
        np.float32)
    fc = nn.Conv(6, (3, 3), strides=(2, 2), use_bias=False)
    fv = fc.init(jax.random.PRNGKey(0), x)
    want = np.asarray(fc.apply(fv, x))
    conv = Conv(4, 6, 3, 2)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.array(
            fv["params"]["kernel"])).permute(3, 2, 0, 1))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = conv(xt).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    sym = torch.nn.functional.conv2d(xt, conv.weight, stride=2, padding=1)
    assert np.abs(sym.permute(0, 2, 3, 1).detach().numpy() - want).max() > 0.1
