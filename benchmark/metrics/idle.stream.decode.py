"""The share of the traced window in which nothing ran on the card while the
host was in the program's ``stream.decode`` span (the streamed decode of a
segment's samples) (%); a part of ``idle.stream``."""
from benchmark import port_trace


def read(ctx):
    return port_trace.idle_in_span_pct(ctx, "stream.decode")
