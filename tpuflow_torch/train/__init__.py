"""GPT training on one device: the optimizer factory (``optim``), the
train and eval steps (``step``) and the ``train_gpt`` recipe (``gpt``)."""
