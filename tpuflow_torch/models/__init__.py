"""GPT-2 (``gpt2``), the loader of JAX params (``convert``) and the
training losses (``losses``)."""
