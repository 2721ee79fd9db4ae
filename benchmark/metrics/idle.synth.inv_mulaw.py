"""The share of the traced window in which nothing ran on the card while the
host was in the program's ``synth.inv_mulaw`` span (the inverse mu-law of a
batch's codes, inside ``synth.decode``) (%); a part of ``idle.synth.decode``.
None where the program never entered that span."""
from benchmark import port_trace


def read(ctx):
    if not port_trace.span_seconds("synth.inv_mulaw"):
        return None
    return port_trace.idle_in_span_pct(ctx, "synth.inv_mulaw")
