from wavenet_vocoder_tpu_torch.dsp import audio  # noqa: F401
