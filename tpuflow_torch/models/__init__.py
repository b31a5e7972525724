"""GPT-2 (``gpt2``) and the loader of JAX params (``convert``)."""
