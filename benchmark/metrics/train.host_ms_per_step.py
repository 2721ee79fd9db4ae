"""Mean host ms from the call of train_step to its return (the enqueue of
the step's launches and optimizer and EMA ops), over the untraced steps."""
from benchmark import readers


def read(ctx):
    return readers.mean_span_ms(ctx, "train_step.call")
