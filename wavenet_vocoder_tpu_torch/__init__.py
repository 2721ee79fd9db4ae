"""PyTorch/CUDA port of wavenet_vocoder_tpu.

The port sits beside the JAX package and imports nothing of it (nor JAX).
Layout is channels-last ``(B, T, C)`` at every public function, as in the
JAX package. Parameter names and layouts follow the reference torch model
(``weight_v (Out, In, K)``, ``weight_g``, ``bias``), so a port
``state_dict()`` is a reference-format state dict.

Importing the package builds and loads no CUDA code: the generation kernel
(``csrc/generate.cu``) is compiled with nvcc the first time it is launched.
"""
from wavenet_vocoder_tpu_torch.version import __version__  # noqa: F401
from wavenet_vocoder_tpu_torch.config import Config, load_config  # noqa: F401
from wavenet_vocoder_tpu_torch.models.wavenet import (  # noqa: F401
    WaveNet,
    WaveNetSpec,
    make_generation_fast,
    receptive_field_size,
    spec_from_config,
)


def __getattr__(name):  # lazy: synthesis pulls in scipy/dsp
    if name == "Synthesizer":
        from wavenet_vocoder_tpu_torch.synthesis import Synthesizer
        return Synthesizer
    raise AttributeError(name)
