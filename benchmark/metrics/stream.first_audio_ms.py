"""Median ms from an utterance's first feed to its first audio on the host,
over the utterances started in the untraced rest of the window."""
from benchmark import readers


def read(ctx):
    return readers.median([f["ms"] for f in ctx["run"].first_audio
                           if readers.untraced(ctx, f["t"])])
