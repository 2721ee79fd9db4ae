"""Seconds the process spent in the program's ``kernels.load`` span: the CUDA
libraries loaded, and built with nvcc where no build was found (0.0 where
none was loaded)."""
from benchmark import port_trace


def read(ctx):
    return port_trace.span_seconds("kernels.load")
