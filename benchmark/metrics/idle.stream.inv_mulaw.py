"""The share of the traced window in which nothing ran on the card while the
host was in the program's ``stream.inv_mulaw`` span (the inverse mu-law of a
segment's codes, inside ``stream.decode``) (%); a part of
``idle.stream.decode``. None where the program never entered that span."""
from benchmark import port_trace


def read(ctx):
    if not port_trace.span_seconds("stream.inv_mulaw"):
        return None
    return port_trace.idle_in_span_pct(ctx, "stream.inv_mulaw")
