"""The port's own copies of the data plumbing the GPT training slice needs
(``datasets``, ``loader``, ``lm``): numpy only, identical batches to the
JAX package's loaders."""
