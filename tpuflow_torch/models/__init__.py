"""The model zoo (counterpart of ``tpuflow/models``): GPT-2 (``gpt2``), the
FashionMNIST MLP (``mlp``), ResNet-18/50 (``resnet``), ViT (``vit``), the
loaders of JAX params (``convert``) and the training losses
(``losses``)."""

from tpuflow_torch.models.mlp import NeuralNetwork

__all__ = ["NeuralNetwork", "get_model"]


def get_model(name: str, **kwargs):
    """Model registry (counterpart of ``tpuflow/models/__init__.py::
    get_model``), with its presets: ``vit_tiny`` (ViT-Ti/16: 192 wide, 12
    layers, 3 heads, patch 16) and ``vit_small`` (ViT-S/16: 384, 12, 6,
    16). The image models also take ``in_channels`` (ResNet) or
    ``image_shape`` (ViT), which Flax infers from the first input."""
    name = name.lower()
    if name in ("mlp", "neural_network", "fashion_mnist_mlp"):
        return NeuralNetwork(**kwargs)
    if name in ("gpt2", "gpt2_medium", "gpt2-medium"):
        from tpuflow_torch.models.gpt2 import GPT2, GPT2Config

        cfg = kwargs.pop("config", None)
        if cfg is None:
            cfg = GPT2Config.medium() if name != "gpt2" else GPT2Config()
        return GPT2(cfg, **kwargs)
    if name in ("resnet18", "resnet50"):
        from tpuflow_torch.models.resnet import ResNet18, ResNet50

        return (ResNet18 if name == "resnet18" else ResNet50)(**kwargs)
    if name in ("vit", "vit_tiny", "vit_small"):
        from tpuflow_torch.models.vit import ViT

        preset = {"vit_tiny": dict(n_embd=192, n_layer=12, n_head=3,
                                   patch_size=16),
                  "vit_small": dict(n_embd=384, n_layer=12, n_head=6,
                                    patch_size=16)}.get(name, {})
        return ViT(**{**preset, **kwargs})
    raise KeyError(
        f"unknown model {name!r}; available: mlp, resnet18, resnet50, "
        "gpt2, gpt2_medium, vit, vit_tiny, vit_small"
    )
