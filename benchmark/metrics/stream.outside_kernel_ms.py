"""Median, over the traced segments, of a segment's wall time less the
generate_kernel device time inside it (ms): the windowed upsample net, the
host copy and the decode."""
from benchmark import readers, tracing


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    vals = []
    for name, a, b in tr["spans"]:
        if name in ("feed", "flush"):
            kern = tracing.device_time(tr, readers.GENERATE, within=(a, b))
            vals.append((b - a) / 1e6 - kern * 1e3)
    return readers.median(vals)
