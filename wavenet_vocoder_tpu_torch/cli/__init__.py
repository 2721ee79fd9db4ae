"""Command-line entry points of the port: ``python -m
wavenet_vocoder_tpu_torch.cli.{preprocess,synthesis,evaluate}``."""
