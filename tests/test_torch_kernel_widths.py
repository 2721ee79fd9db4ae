"""PyTorch port: the kernels take every width the JAX package takes.

* ``ops/cuda_generate.kernel_supports``: the generation kernel pads the gate,
  residual and skip widths to its fragments (``KernelPack``, and a ring
  padded with zero channels where R is not a multiple of 8), so the demo
  presets (residual/gate/skip 4/4/4) are taken like the flagship; only
  buffers past a block's shared memory are refused, with the reason.
  ``--engine auto`` is the kernel, and a 4/4/4 checkpoint runs through the
  CLIs (its plain version here, on the CPU).
* ``ops/cuda_train.kernel_widths``: the bf16 training kernels run a stack
  whose R, GLU halves or S are not fragment multiples at widths padded with
  zero channels; the plain stack at the padded widths, sliced back, equals
  the plain stack at the model's widths (``tests/test_torch_kernels.py``
  runs the kernels at such widths on a GPU).
"""
import os

import numpy as np
import pytest
import torch

from wavenet_vocoder_tpu_torch.cli.evaluate import main as evaluate
from wavenet_vocoder_tpu_torch.cli.synthesis import main as synthesis
from wavenet_vocoder_tpu_torch.cli.synthesis import resolve_engine
from wavenet_vocoder_tpu_torch.config import Config, load_config
from wavenet_vocoder_tpu_torch.models.wavenet import spec_from_config
from wavenet_vocoder_tpu_torch.ops import cuda_generate as cg
from wavenet_vocoder_tpu_torch.ops import cuda_train as ct
from wavenet_vocoder_tpu_torch.ops import fused_train as ft
from wavenet_vocoder_tpu_torch.training import checkpoint as ckpt
from wavenet_vocoder_tpu_torch.training.train_state import create_train_state

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMOS = {name: os.path.join(ROOT, "egs", name, "conf", f"{name}_wavenet_demo.json")
         for name in ("mol", "gaussian", "mulaw256")}


def _demo(name):
    return load_config(DEMOS[name])


@pytest.mark.parametrize("name", sorted(DEMOS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_generation_kernel_takes_the_demo_presets(name, dtype):
    spec = spec_from_config(_demo(name))
    assert (spec.residual_channels, spec.gate_channels,
            spec.skip_out_channels) == (4, 4, 4)
    assert cg.kernel_supports(spec, dtype) == (True, "")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_generation_kernel_takes_the_flagship(dtype):
    spec = spec_from_config(Config())
    assert cg.kernel_supports(spec, dtype) == (True, "")
    for cs in (4, 8):
        assert cg.kernel_supports(spec, dtype, cs) == (True, "")


def test_generation_kernel_refuses_buffers_past_shared_memory():
    spec = spec_from_config(Config(residual_channels=2048, gate_channels=4096,
                                   skip_out_channels=2048))
    takes, why = cg.kernel_supports(spec, torch.float32)
    assert not takes and "shared memory" in why


def test_auto_is_the_kernel():
    assert resolve_engine("auto") == "cuda"
    assert resolve_engine("scan") == "scan"


@pytest.fixture(scope="module")
def demo_ckpt(tmp_path_factory):
    """A mol demo-preset (4/4/4) checkpoint with hparams.json beside it, and
    a mel-only dump dir of two short utterances."""
    root = tmp_path_factory.mktemp("demo_ckpt")
    cfg = _demo("mol")
    state = create_train_state(cfg, device="cpu")
    path = ckpt.save_checkpoint(str(root / "exp"), state, global_step=1)
    (root / "exp" / "hparams.json").write_text(cfg.to_json())
    mels = root / "mels"
    mels.mkdir()
    rs = np.random.RandomState(0)
    for i, n in enumerate((7, 9)):
        np.save(mels / f"utt{i}-feats.npy",
                rs.rand(n, cfg.num_mels).astype(np.float32))
    return dict(ckpt=path, mels=str(mels), hop=cfg.hop_size)


def test_synthesis_cli_auto_runs_a_demo_checkpoint(demo_ckpt, tmp_path):
    mel = os.path.join(demo_ckpt["mels"], "utt0-feats.npy")
    dst = str(tmp_path / "out.wav")
    synthesis([demo_ckpt["ckpt"], dst, "--conditional", mel, "--device", "cpu",
               "--engine", "auto"])
    from scipy.io import wavfile
    x = wavfile.read(dst)[1]
    assert len(x) == 7 * demo_ckpt["hop"] and np.isfinite(x).all()


def test_evaluate_cli_auto_runs_a_demo_checkpoint(demo_ckpt, tmp_path):
    out = str(tmp_path / "eval")
    evaluate([demo_ckpt["mels"], demo_ckpt["ckpt"], out, "--batch-size", "2",
              "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["eval_manifest.txt", "utt0_gen.wav",
                                       "utt1_gen.wav"]


@pytest.mark.parametrize("name", sorted(DEMOS))
def test_training_kernels_pad_the_demo_widths_in_bf16(name):
    cfg = _demo(name)
    R, G, S = (cfg.residual_channels, cfg.gate_channels, cfg.skip_out_channels)
    assert ct.kernel_widths(R, G, S, torch.bfloat16) == (8, 16, 4)
    # the f32 FMA kernels take any widths
    assert ct.kernel_widths(R, G, S, torch.float32) == (R, G, S)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_training_kernels_take_the_flagship_widths(dtype):
    cfg = Config()
    widths = (cfg.residual_channels, cfg.gate_channels, cfg.skip_out_channels)
    assert ct.kernel_widths(*widths, dtype) == widths


# (R, G, S, cin, global conditioning): the demo widths; R, each GLU half
# and S all off their multiples; odd R and S
PAD_WIDTHS = {"demo": (4, 4, 4, 0, False), "ragged": (12, 20, 5, 5, True),
              "odd": (5, 6, 3, 3, False)}


@pytest.mark.parametrize("width", sorted(PAD_WIDTHS))
def test_padded_stack_equals_the_stack(width):
    """The plain stack at the kernels' widths, on operands padded as the
    wrappers pad them, gives the model's skips, stash and gradients once
    sliced back; the padding channels stay exactly zero."""
    R, G, S, cin, glob = PAD_WIDTHS[width]
    L, k, B, T = 3, 3, 2, 40
    rs = np.random.RandomState(0)
    t = lambda *s, sc=1.0: torch.from_numpy((rs.randn(*s) * sc).astype(np.float32))
    x0, ds = t(B, T, R), t(B, T, S)
    c = t(B, T, cin) if cin else None
    gb = t(L, B, G, sc=0.1) if glob else None
    w_in, b_in = t(L, k * R, G, sc=0.3), t(L, G, sc=0.1)
    w_cond = t(L, cin, G, sc=0.3) if cin else None
    w_og, b_og = t(L, G // 2, R + S, sc=0.3), t(L, R + S, sc=0.1)
    pad = ct._padding(R, w_in.to(torch.bfloat16), w_og, k)
    assert (pad.Rp, 2 * pad.G2p, pad.Sp) == ct.kernel_widths(
        R, G, S, torch.bfloat16)
    kw = dict(dils=[1, 2, 4], k=k)
    padded = (c, pad.gate(gb), pad.w_in(w_in, k), pad.gate(b_in),
              pad.gate(w_cond), pad.w_og(w_og), pad.res_skip(b_og))
    skips, xs = ft.fused_res_stack_fwd_plain(
        x0, c, gb, w_in, b_in, w_cond, w_og, b_og, **kw)
    skips_p, xs_p = ft.fused_res_stack_fwd_plain(
        pad.last(x0, pad.Rp), *padded, **kw)
    assert torch.equal(skips_p[..., :S], skips)
    assert torch.equal(xs_p[..., :R], xs)
    assert not skips_p[..., S:].any() and not xs_p[..., R:].any()
    want = ft.fused_res_stack_bwd_plain(
        ds, xs, c, gb, w_in, b_in, w_cond, w_og, b_og, **kw)
    dx0, dc, dgb, dw_in, db_in, dw_cond, dw_og, db_og = \
        ft.fused_res_stack_bwd_plain(pad.last(ds, pad.Sp),
                                     pad.last(xs, pad.Rp), *padded, **kw)
    assert not dx0[..., R:].any()
    dw_in = dw_in.reshape(L, k, pad.Rp, -1)[:, :, :R].reshape(L, k * R, -1)
    got = (dx0[..., :R], dc, pad.ungate(dgb), pad.ungate(dw_in),
           pad.ungate(db_in), pad.ungate(dw_cond),
           pad.unres_skip(dw_og[:, :pad.G2]), pad.unres_skip(db_og))
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            torch.testing.assert_close(g, w, rtol=0, atol=1e-6)
