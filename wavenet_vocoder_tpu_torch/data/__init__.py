from wavenet_vocoder_tpu_torch.data.dataset import (  # noqa: F401
    DataLoader,
    LengthBucketSampler,
    Utterance,
    WaveNetDataset,
    assert_ready_for_upsampling,
    collate_fn,
    ensure_divisible,
    glob_fallback,
    parse_manifest,
)
