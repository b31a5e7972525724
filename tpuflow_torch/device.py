"""Device resolution for the port's entry points.

Every entry point runs on ``cuda`` unless its caller passes
``device="cpu"`` (the CPU tests do). Asking for CUDA on a machine without
it raises: a run that was meant for the card must never quietly land on
the CPU and report CPU numbers under the card's name.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device that is not present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was asked for but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def pin_f32_matmul_precision() -> None:
    """True float32 matrix products on the card (no TF32), the counterpart
    of the JAX model's ``decode_precision='highest'``: a TF32 product keeps
    about three decimal digits, enough to flip a near-tie greedy argmax."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
