"""The share of the traced window in which nothing ran on the card while the
host was in the program's ``stream.condition`` span (the mel window's copy
to the card and the windowed upsample net) (%); a part of ``idle.stream``."""
from benchmark import port_trace


def read(ctx):
    return port_trace.idle_in_span_pct(ctx, "stream.condition")
