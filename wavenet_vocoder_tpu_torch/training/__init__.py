"""Training: optimizer, LR schedules, EMA, the train step, checkpoints and
the loop. Submodules are imported explicitly (``training.train_state``,
``training.loop``, ...)."""
