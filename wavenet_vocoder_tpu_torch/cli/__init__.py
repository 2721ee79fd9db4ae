"""Command-line entry points of the port: ``python -m
wavenet_vocoder_tpu_torch.cli.{preprocess,compute_meanvar_stats,
preprocess_normalize,mksubset,tojson,train,import_checkpoint,synthesis,
evaluate}``."""
