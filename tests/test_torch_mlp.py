"""The port's FashionMNIST MLP (tpuflow_torch.models.mlp) against the Flax
``NeuralNetwork`` of the JAX package, its registry entry and its parameter
layout between the two packages.

Weights are made from a seed with numpy and loaded into both models; the
logits agree within 1e-6 of the largest |logit| (f32: the same three
products summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.models.mlp import NeuralNetwork as JNeuralNetwork
from tpuflow_torch.models import NeuralNetwork, get_model
from tpuflow_torch.models.convert import mlp_params_from_jax, mlp_params_to_jax
from torch_parity import one_torch_thread  # noqa: F401


def _jax_params(seed=0, hidden=512, classes=10):
    """Flax MLP params made with numpy (kernels (in, out))."""
    r = np.random.default_rng(seed)
    dims = [(784, hidden), (hidden, hidden), (hidden, classes)]
    return {f"dense{i + 1}": {
        "kernel": (r.standard_normal(d) / np.sqrt(d[0])).astype(np.float32),
        "bias": (0.1 * r.standard_normal(d[1])).astype(np.float32),
    } for i, d in enumerate(dims)}


def _images(n=16, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, 28, 28)).astype(np.float32)


@pytest.mark.parametrize("final_relu", [True, False])
def test_logits_match_flax(final_relu):
    params = _jax_params()
    x = _images()
    jm = JNeuralNetwork(final_relu=final_relu)
    want = np.asarray(jm.apply({"params": jax.tree_util.tree_map(
        jnp.asarray, params)}, jnp.asarray(x), train=False))
    tm = NeuralNetwork(final_relu=final_relu)
    tm.load_state_dict(mlp_params_from_jax(params))
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (16, 10) and got.dtype == np.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)
    if final_relu:
        assert (got >= 0).all()
    else:
        assert (got < 0).any()


def test_params_roundtrip_between_layouts():
    params = _jax_params(seed=3)
    back = mlp_params_to_jax(mlp_params_from_jax(params))
    assert sorted(back) == ["dense1", "dense2", "dense3"]
    for name, leaves in params.items():
        for leaf, arr in leaves.items():
            assert back[name][leaf].shape == arr.shape
            np.testing.assert_array_equal(back[name][leaf].numpy(), arr)


def test_init_shapes_follow_flax():
    """Fresh port weights have the Flax model's shapes (kernels as (in,
    out) in the JAX layout) and zero biases; the same seed gives the same
    weights."""
    jshapes = jax.eval_shape(JNeuralNetwork().init, jax.random.PRNGKey(0),
                             jnp.zeros((1, 28, 28)))["params"]
    tree = mlp_params_to_jax(NeuralNetwork(seed=5).state_dict())
    for name in jshapes:
        for leaf in jshapes[name]:
            assert tuple(tree[name][leaf].shape) == jshapes[name][leaf].shape
        assert torch.count_nonzero(tree[name]["bias"]) == 0
    again = NeuralNetwork(seed=5).state_dict()
    for k, v in NeuralNetwork(seed=5).state_dict().items():
        assert torch.equal(v, again[k])


def test_dropout_masks_follow_the_seed():
    """train=True draws the masks from the seed alone: the same rng gives
    the same output, another rng another one; inference ignores dropout;
    dropout_rate 0 is the identity."""
    tm = NeuralNetwork(final_relu=False)
    x = torch.from_numpy(_images(8))
    a = tm(x, train=True, rng=7)
    assert torch.equal(a, tm(x, train=True, rng=7))
    assert not torch.equal(a, tm(x, train=True, rng=8))
    assert torch.equal(tm(x), tm(x, train=False, rng=7))
    plain = NeuralNetwork(dropout_rate=0.0, final_relu=False)
    plain.load_state_dict(tm.state_dict())
    assert torch.equal(plain(x, train=True, rng=7), tm(x))
    with pytest.raises(ValueError, match="rng"):
        tm(x, train=True)


def test_registry_names():
    for name in ("mlp", "neural_network", "fashion_mnist_mlp"):
        m = get_model(name, hidden_dim=32, num_classes=3)
        assert isinstance(m, NeuralNetwork)
        assert m(torch.zeros(2, 28, 28)).shape == (2, 3)
    from tpuflow_torch.models.resnet import BottleneckBlock, ResNet
    from tpuflow_torch.models.vit import ViT

    for name, block in (("resnet18", "BasicBlock_7"),
                        ("resnet50", "BottleneckBlock_15")):
        m = get_model(name, width=8)
        assert isinstance(m, ResNet) and hasattr(m, block)
    assert isinstance(m.BottleneckBlock_0, BottleneckBlock)
    for name, (C, L, H, P) in (("vit", (192, 6, 3, 4)),
                               ("vit_tiny", (192, 12, 3, 16)),
                               ("vit_small", (384, 12, 6, 16))):
        m = get_model(name, image_shape=(32, 32, 3))
        assert isinstance(m, ViT)
        assert (m.n_embd, len(m.blocks), m.block0.n_head, m.patch_size) == (
            C, L, H, P)
    with pytest.raises(KeyError):
        get_model("nope")
