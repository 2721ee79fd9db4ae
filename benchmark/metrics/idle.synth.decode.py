"""The share of the traced window in which nothing ran on the card while the
host was in the program's ``synth.decode`` span (the host's decode of a
batch: inverse pre-emphasis, gain, cast) (%); a part of ``idle.synth``."""
from benchmark import port_trace


def read(ctx):
    return port_trace.idle_in_span_pct(ctx, "synth.decode")
