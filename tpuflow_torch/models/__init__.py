"""The model zoo (counterpart of ``tpuflow/models``): GPT-2 (``gpt2``), the
FashionMNIST MLP (``mlp``), the loaders of JAX params (``convert``) and
the training losses (``losses``)."""

from tpuflow_torch.models.mlp import NeuralNetwork

__all__ = ["NeuralNetwork", "get_model"]


def get_model(name: str, **kwargs):
    """Model registry (counterpart of ``tpuflow/models/__init__.py::
    get_model``). The names the port cannot build yet raise
    ``NotImplementedError``."""
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
        raise NotImplementedError(
            f"model {name!r} is not ported yet: ROADMAP Queue 1 item 11")
    if name in ("vit", "vit_tiny", "vit_small"):
        raise NotImplementedError(
            f"model {name!r} is not ported yet: ROADMAP Queue 1 item 14")
    raise KeyError(
        f"unknown model {name!r}; available: mlp, resnet18, resnet50, "
        "gpt2, gpt2_medium, vit, vit_tiny, vit_small"
    )
