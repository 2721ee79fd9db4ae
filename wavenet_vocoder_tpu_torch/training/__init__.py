"""Training: optimizer, LR schedules, EMA and the train step. Submodules
are imported explicitly (``training.train_state``, ``training.lrschedule``)."""
