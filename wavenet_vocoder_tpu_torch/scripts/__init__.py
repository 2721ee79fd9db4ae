"""Checks that run the port end to end (``python -m``): the sampled-audio
quality net (``synthetic_e2e``, ``quality_check``)."""
