"""csrc/train_fwd.cu's share of its roofline over the traced steps: the
stack's forward products at the bf16 peak over its device time (%)."""
from benchmark import readers, yardstick


def read(ctx):
    return readers.train_kernel_roofline_pct(ctx, readers.TRAIN_FWD,
                                             yardstick.stack_forward_step)
