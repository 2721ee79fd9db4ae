from wavenet_vocoder_tpu_torch.data.dataset import (  # noqa: F401
    Utterance,
    parse_manifest,
)
