"""Training: the optimizer factory (``optim``), the train and eval steps
and the train state (``step``), the ``Trainer`` runtime (``trainer``) and
the ``train_gpt`` recipe on one device (``gpt``)."""
