"""tpuflow_torch: the PyTorch + CUDA port of tpuflow, for an NVIDIA H100.

It sits beside the JAX package ``tpuflow`` (the reference) and imports
none of it. Plain tensor code is PyTorch; every kernel that the JAX
package wrote in Pallas for the TPU is a kernel written by hand for Hopper
under ``csrc/``, built with ``nvcc`` at first use (``ops/_build.py``).

The serving slice: ``models.gpt2`` (GPT-2 with the shared-index, ragged
and paged KV caches), ``infer.generate`` (the ``generate()`` entry point),
``infer.quant`` (fused-native W8A8 int8) and ``infer.serve``
(``ServeEngine``, the paged continuous-batching engine).

The training slice: ``train.gpt`` (``train_gpt``, one device),
``train.step`` and ``train.optim`` (the train and eval steps, AdamW/SGD
with schedules and clipping), ``models.losses``, the ``data`` loaders,
and GPT-2's training modes (remat, seeded dropout) over the flash
forward with lse and the fused backward kernels.
"""

from tpuflow_torch.device import resolve_device

__all__ = ["resolve_device"]
