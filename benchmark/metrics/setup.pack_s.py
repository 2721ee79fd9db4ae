"""Seconds the process spent in the program's ``generator.pack`` span: the
generation kernel's weight packs made at set-up (0.0 where none was made)."""
from benchmark import port_trace


def read(ctx):
    return port_trace.span_seconds("generator.pack")
