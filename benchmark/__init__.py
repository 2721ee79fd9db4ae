"""The benchmark of wavenet_vocoder_tpu_torch; see run.py."""
