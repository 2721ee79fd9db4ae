"""3x the analytic forward FLOPs of the samples trained in the untraced rest
of the window over its seconds and the bf16 peak (%)."""
from benchmark import readers, yardstick


def read(ctx):
    return readers.mfu_pct(ctx, yardstick.train_flops_per_sample(ctx["keys"]))
