from wavenet_vocoder_tpu_torch.models.wavenet import (  # noqa: F401
    WaveNet,
    WaveNetSpec,
    make_generation_fast,
    receptive_field_size,
    spec_from_config,
)
