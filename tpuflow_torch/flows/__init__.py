"""The port's twins of the JAX package's flow modules: the README main path
(``my_torch_module``, twin of ``flows/my_tpu_module.py``)."""
