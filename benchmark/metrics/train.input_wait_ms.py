"""Mean host ms an untraced step of the window waited in next() on the
prefetched loader."""
from benchmark import readers


def read(ctx):
    return readers.mean_span_ms(ctx, "loader.next")
