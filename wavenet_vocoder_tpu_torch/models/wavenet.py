"""The WaveNet model: static spec + an ``nn.Module`` with the reference's
parameter names.

The port's counterpart of ``wavenet_vocoder_tpu/models/wavenet.py``.
``WaveNetSpec`` and ``spec_from_config`` are copies; ``WaveNet`` holds the
parameters under the reference torch model's names (``first_conv``,
``conv_layers.{i}.*``, ``last_conv_layers.{1,3}``, ``embed_speakers``,
``upsample_net.*``), so its ``state_dict()`` reads as a reference checkpoint.

Layout: channels-last (B, T, C). Scalar input is (B, T, 1); categorical
input is one-hot (B, T, out_channels) (reference: wavenet.py:119-122).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from wavenet_vocoder_tpu_torch.config import Config
from wavenet_vocoder_tpu_torch.models.layers import (
    ResidualConv1dGLU,
    WNConv1d,
    conv1x1,
    copy_to_model,
    remove_weight_norm,
)
from wavenet_vocoder_tpu_torch.models.upsample import (
    ConvInUpsampleNetwork,
    UpsampleNetwork,
)
from wavenet_vocoder_tpu_torch.ops.fused_train import (
    dropout_mask,
    fused_res_stack,
    stack_receptive,
)


def receptive_field_size(total_layers: int, num_cycles: int, kernel_size: int,
                         dilation: Callable[[int], int] = lambda x: 2 ** x) -> int:
    """Receptive field in samples (reference: wavenet.py:42-60).

    e.g. 24 layers / 4 stacks / k=3 -> 505; 30/3/3 -> 6139.
    """
    assert total_layers % num_cycles == 0
    layers_per_cycle = total_layers // num_cycles
    dilations = [dilation(i % layers_per_cycle) for i in range(total_layers)]
    return (kernel_size - 1) * sum(dilations) + 1


@dataclass(frozen=True)
class WaveNetSpec:
    """Static model structure, the JAX package's spec.
    ``fused_train`` runs the residual stack of the batch forward through
    the fused training stack (``ops/fused_train.py``). ``remat``
    recomputes each block of the plain layer loop in the backward
    (``remat_policy == "dots"`` keeps the products' outputs and recomputes
    the elementwise work; any other value the whole block)."""
    out_channels: int = 256
    layers: int = 20
    stacks: int = 2
    residual_channels: int = 512
    gate_channels: int = 512
    skip_out_channels: int = 512
    kernel_size: int = 3
    dropout: float = 1 - 0.95
    cin_channels: int = -1
    gin_channels: int = -1
    n_speakers: Optional[int] = None
    upsample_conditional_features: bool = False
    upsample_net: str = "ConvInUpsampleNetwork"
    upsample_scales: Tuple[int, ...] = (4, 4, 4, 4)
    upsample_activation: str = "none"
    freq_axis_kernel_size: int = 1
    cin_pad: int = 0
    scalar_input: bool = False
    use_speaker_embedding: bool = False
    output_distribution: str = "Logistic"
    remat: bool = False
    remat_policy: str = ""
    fused_train: bool = False

    def __post_init__(self):
        assert self.layers % self.stacks == 0

    @property
    def layers_per_stack(self) -> int:
        return self.layers // self.stacks

    @property
    def dilations(self) -> Tuple[int, ...]:
        """2**(layer % layers_per_stack) (reference: wavenet.py:125)."""
        return tuple(2 ** (i % self.layers_per_stack) for i in range(self.layers))

    @property
    def receptive_field(self) -> int:
        return receptive_field_size(self.layers, self.stacks, self.kernel_size)

    @property
    def in_channels(self) -> int:
        return 1 if self.scalar_input else self.out_channels

    @property
    def has_local_conditioning(self) -> bool:
        return self.cin_channels > 0

    @property
    def has_global_conditioning(self) -> bool:
        return self.gin_channels > 0

    @property
    def has_speaker_embedding(self) -> bool:
        return self.has_global_conditioning and self.use_speaker_embedding


def spec_from_config(cfg: Config) -> WaveNetSpec:
    """Build the spec the way the reference's build_model() does
    (reference: train.py:887-918)."""
    up = dict(cfg.upsample_params)
    return WaveNetSpec(
        out_channels=cfg.out_channels,
        layers=cfg.layers,
        stacks=cfg.stacks,
        residual_channels=cfg.residual_channels,
        gate_channels=cfg.gate_channels,
        skip_out_channels=cfg.skip_out_channels,
        kernel_size=cfg.kernel_size,
        dropout=cfg.dropout,
        cin_channels=cfg.cin_channels,
        gin_channels=cfg.gin_channels,
        n_speakers=cfg.n_speakers,
        upsample_conditional_features=cfg.upsample_conditional_features,
        upsample_net=cfg.upsample_net,
        upsample_scales=tuple(up.get("upsample_scales", (4, 4, 4, 4))),
        upsample_activation=str(up.get("upsample_activation", "none")),
        freq_axis_kernel_size=int(up.get("freq_axis_kernel_size", 1)),
        cin_pad=cfg.cin_pad,
        scalar_input=cfg.is_scalar_input,
        use_speaker_embedding=cfg.use_speaker_embedding,
        output_distribution=cfg.output_distribution,
        remat=cfg.remat,
        remat_policy=cfg.remat_policy,
        fused_train=cfg.fused_train,
    )


class WaveNet(nn.Module):
    """WaveNet with random init drawn from ``generator``
    (reference: wavenet.py:98-156)."""

    def __init__(self, spec: WaveNetSpec, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spec = spec
        R, S = spec.residual_channels, spec.skip_out_channels
        self.first_conv = WNConv1d(spec.in_channels, R, generator=generator)
        self.conv_layers = nn.ModuleList([
            ResidualConv1dGLU(R, spec.gate_channels, spec.kernel_size, S,
                              cin_channels=spec.cin_channels,
                              gin_channels=spec.gin_channels, dilation=d,
                              generator=generator)
            for d in spec.dilations])
        # head: ReLU -> 1x1 -> ReLU -> 1x1 (reference: wavenet.py:136-141)
        self.last_conv_layers = nn.ModuleList([
            nn.ReLU(), WNConv1d(S, S, generator=generator),
            nn.ReLU(), WNConv1d(S, spec.out_channels, generator=generator)])
        if spec.has_speaker_embedding:
            assert spec.n_speakers is not None
            self.embed_speakers = nn.Embedding(spec.n_speakers, spec.gin_channels)
            with torch.no_grad():
                self.embed_speakers.weight.copy_(0.1 * torch.randn(
                    spec.n_speakers, spec.gin_channels, generator=generator))
        else:
            self.embed_speakers = None
        if spec.upsample_conditional_features:
            kw = dict(upsample_activation=spec.upsample_activation,
                      freq_axis_kernel_size=spec.freq_axis_kernel_size,
                      cin_pad=spec.cin_pad)
            if spec.upsample_net == "ConvInUpsampleNetwork":
                self.upsample_net = ConvInUpsampleNetwork(
                    spec.upsample_scales, cin_channels=spec.cin_channels,
                    generator=generator, **kw)
            elif spec.upsample_net == "UpsampleNetwork":
                self.upsample_net = UpsampleNetwork(spec.upsample_scales, **kw)
            else:
                raise ValueError(spec.upsample_net)
        else:
            self.upsample_net = None

    @property
    def model_group(self):
        """The process group the residual blocks are cut over by gate-
        channel tensor parallelism (``parallel.sharding.shard_params_tp``),
        or None."""
        tp = self.conv_layers[0].conv.tp
        return None if tp is None else tp[1]

    # conditioning helpers, shared by the batch forward and the decoders
    def embed_global(self, g: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """Speaker ids (B,)/(B, 1) or floats (B, gin) -> (B, gin) float."""
        if g is None:
            return None
        if self.embed_speakers is not None and not g.is_floating_point():
            g = self.embed_speakers(g.reshape(g.shape[0]).long())
        return g.reshape(g.shape[0], -1)

    def upsample_conditioning(self, c: Optional[torch.Tensor]
                              ) -> Optional[torch.Tensor]:
        """(B, T_mel, C) -> (B, T, C) through the upsample net, if any.

        cuDNN convolutions default to TF32 on the card; they run in full
        f32 here so the conditioning matches the f32 reference."""
        if c is None or self.upsample_net is None:
            return c
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            return self.upsample_net(c)

    def head(self, skips: torch.Tensor) -> torch.Tensor:
        """Summed skips (..., S) -> (..., out_channels)."""
        out = torch.relu(skips * math.sqrt(1.0 / self.spec.layers))
        out = torch.relu(conv1x1(self.last_conv_layers[1], out))
        return conv1x1(self.last_conv_layers[3], out)

    def forward(self, x: torch.Tensor, c: Optional[torch.Tensor] = None,
                g: Optional[torch.Tensor] = None, *, train: bool = False,
                dtype: Optional[torch.dtype] = None,
                seed: Optional[int] = None, b0: int = 0) -> torch.Tensor:
        """Batch forward (reference: wavenet.py:164-213; the JAX package's
        ``apply_wavenet``).

        x: (B, T, 1) scalar or (B, T, out_channels) one-hot; c: (B, T_mel, C)
        with an upsample net, else (B, T, C); g: ids or (B, gin) floats.
        dtype: compute dtype of the network below the head's output (e.g.
        torch.bfloat16); parameters stay f32 masters. train/seed: conv-input
        dropout of ``spec.dropout`` when ``train`` and a seed is given (an
        int32 per step). Both paths draw the fused stack's counter-hash mask,
        keyed on (seed, global batch row, time, layer, channel); b0 is the
        global row of x's row 0 (a data-parallel rank's offset, as JAX's
        ``apply_wavenet(mesh=)`` hands each shard its rows), so a rank drops
        what one device would drop in its rows of the global batch. With
        ``spec.fused_train`` the residual stack runs through
        ``ops.fused_train.fused_res_stack``.
        Returns (B, T, out_channels) float32.
        """
        T = x.shape[1]
        g_vec = self.embed_global(g)
        g_exp = None if g_vec is None else g_vec[:, None, :]
        c = self.upsample_conditioning(c)
        if c is not None and c.shape[1] != T:
            raise ValueError(f"conditioning covers {c.shape[1]} steps, "
                             f"input has {T}")
        drop = self.spec.dropout if (train and seed is not None) else 0.0
        if dtype is not None:
            x = x.to(dtype)
            c = None if c is None else c.to(dtype)
            g_exp = None if g_exp is None else g_exp.to(dtype)
        x = conv1x1(self.first_conv, x)

        if self.spec.fused_train:
            skips = fused_res_stack(
                x, c, self.conv_layers, self.spec,
                g=None if g_vec is None else g_vec.float(),
                dtype=dtype or torch.float32, dropout=drop,
                seed=seed if drop > 0 else None, b0=b0)
            out = skips * math.sqrt(1.0 / self.spec.layers)
            out = torch.relu(out if dtype is None else out.to(dtype))
            out = torch.relu(conv1x1(self.last_conv_layers[1], out))
            return conv1x1(self.last_conv_layers[3], out).float()

        B, R, L = x.shape[0], self.spec.residual_channels, self.spec.layers
        H = stack_receptive(self.spec.dilations, self.spec.kernel_size)
        remat = self.spec.remat and torch.is_grad_enabled()
        if self.model_group is not None:
            # read by the column-parallel products of every block: their
            # gradients are summed over the model group once, here
            c = copy_to_model(c, self.model_group)
            g_exp = copy_to_model(g_exp, self.model_group)
        skips = None
        for l, blk in enumerate(self.conv_layers):
            def run(x, c, g_exp, blk=blk, l=l):
                # the mask is a hash of (seed, row, time, layer, channel),
                # so a recomputation draws it again bit for bit
                m = None
                if drop > 0:
                    m = dropout_mask(seed, B=B, T=T, R=R, L=L, l=l, b0=b0,
                                     t0=H, keep=1.0 - drop, device=x.device)
                return blk(x, c, g_exp, dropout=drop, keep_mask=m)
            if remat:
                x, h = checkpoint(run, x, c, g_exp, use_reentrant=False,
                                  **_remat_context(self.spec.remat_policy))
            else:
                x, h = run(x, c, g_exp)
            skips = h if skips is None else skips + h
        return self.head(skips).float()


# the products whose outputs remat_policy "dots" keeps (the counterpart of
# jax.checkpoint_policies.dots_saveable)
_DOTS = (torch.ops.aten.convolution.default, torch.ops.aten.mm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_context(policy: str) -> dict:
    """``checkpoint`` keywords: selective checkpointing that saves the
    products under "dots", nothing (a whole recompute) otherwise, as
    ``jax.checkpoint(policy=None)``."""
    if policy != "dots":
        return {}
    return {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _save_dots)}


def make_generation_fast(model: WaveNet) -> WaveNet:
    """Fold weight norm into plain weights in place — the analogue of the
    reference's ``make_generation_fast_()`` (wavenet.py:355-361)."""
    return remove_weight_norm(model)
