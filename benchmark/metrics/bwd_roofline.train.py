"""csrc/train_bwd.cu's share of its roofline over the traced steps: twice
the stack's forward products (no recompute counted) at the bf16 peak over
the summed device time of its four kernels (%)."""
from benchmark import readers, yardstick


def read(ctx):
    return readers.train_kernel_roofline_pct(ctx, readers.TRAIN_BWD,
                                             yardstick.stack_backward_step)
