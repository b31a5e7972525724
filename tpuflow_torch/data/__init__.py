"""The port's own copies of the data plumbing the training slices need
(``datasets``, ``loader``, ``lm``): identical arrays and batches to the
JAX package's loaders, and the prefetcher onto the card."""
