"""Attention and int8 matmul ops, each a hand-written CUDA kernel beside
its plain PyTorch version (``csrc/``, built by ``_build``)."""
