"""Device resolution for the port's entry points.

Every entry point runs on ``cuda`` unless its caller passes
``device="cpu"`` (the CPU tests do). Asking for CUDA on a machine without
it raises: a run that was meant for the card must never quietly land on
the CPU and report CPU numbers under the card's name.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

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


@contextlib.contextmanager
def f32_matmul_precision(enabled: bool = True) -> Iterator[None]:
    """True float32 matrix products and convolutions on the card (no TF32)
    inside the block, the caller's three flags restored on exit, exception
    included: the counterpart of the JAX model's per-dot
    ``decode_precision='highest'``. A TF32 product keeps about three
    decimal digits, enough to flip a near-tie greedy argmax. ``enabled``
    False leaves the flags alone."""
    if not enabled:
        yield
        return
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    try:
        precision = torch.get_float32_matmul_precision()
    except RuntimeError:
        # The caller mixed the legacy flags with the fp32_precision API:
        # there is no one precision to read, so only the flags go back.
        precision = None
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        # The precision first: setting it also sets the matmul flag.
        if precision is not None:
            torch.set_float32_matmul_precision(precision)
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
