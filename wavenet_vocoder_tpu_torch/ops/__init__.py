"""Heads, decoders and the generation kernel's wrapper. Submodules are
imported explicitly (``ops.generate``, ``ops.cuda_generate``)."""
