"""The arithmetic of the log-mel kernel (``csrc/mel.cu``), emulated in plain
PyTorch on the CPU and held to ``chip_smoke.py`` phase 8's limits against
the plain version ``logmelspectrogram_torch`` and the host f64 pipeline.

The emulation follows the kernel: the flattened frames of all batch rows
are staged per frame tile as the kernel stages them (one segment per batch
row, reflect padding by index, the skew after every hop samples) and read
back at each frame's offset; the DFT runs over the used bins only, with the
DFT matrices decoded from the wrapper's fragment-order array and split as
the kernel splits them in registers (big rounded to TF32 by bit masking:
nearest, ties away from zero, 13 bits; small = b - big, truncated as the
mma reads it); the samples split into two rounded halves as staged; the
three passes big*big + big*small + small*big are exact products summed in
f32, each ring stage in fresh accumulators of its k-group (the groups take
the k-steps of a stage in turn); each bin tile's mel sums are partials added in
tile order; the clamp keeps NaN. A single TF32 pass must miss the limits, which shows
the test can see a split that is too short. The card's own run is in
``tests/test_torch_kernels.py``.
"""
import glob
import os

import numpy as np
import pytest

import jax  # noqa: F401  (imported before torch, as the other parity tests do)
import torch

from wavenet_vocoder_tpu.config import Config as JaxConfig
from wavenet_vocoder_tpu.dsp import mel_jax

from wavenet_vocoder_tpu_torch.config import Config, load_config
from wavenet_vocoder_tpu_torch.dsp import audio, mel_torch

torch.set_num_threads(1)

TOL = {"log": 1e-3, "S": 1e-5, "host": 2e-3}   # chip_smoke.py MEL_TOL
# the tiling of csrc/mel.cu: frames a block (kFrames), bins a bin tile
# (kTileBins), samples a ring stage (8 kStage), k-groups (kGroups)
FRAMES, TILE_BINS, DEPTH, GROUPS = 32, 64, 64, 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = sorted(glob.glob(os.path.join(ROOT, "egs", "*", "conf", "*.json")))


def _sig(T, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(T) / 22050.0
    x = (0.5 * np.sin(2 * np.pi * 440 * t)
         + 0.2 * np.sin(2 * np.pi * 1330 * t) + 0.05 * rng.randn(T))
    return x.astype(np.float32)


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """Nearest TF32 value, ties away from zero: cvt.rna.tf32.f32, masked."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _consts(n_fft, win_length, sample_rate, n_mels, fmin, fmax):
    return mel_torch._kernel_consts(n_fft, win_length, sample_rate, n_mels,
                                    fmin, fmax, TILE_BINS)


def _decode(frag, which):
    """(n_fft, tiles * 64) cos (which 0) or sin (1) matrix from the kernel's
    fragment-order array [tile][ks][m-tile][cos | sin][lane = 4 g + t]
    [(pair, half)]: rows 8 ks + 2 t + pair, bins 16 m-tile + g + 8 half."""
    tiles, n_ks = frag.shape[:2]
    f = frag.reshape(tiles, n_ks, 4, 2, 8, 4, 2, 2)[:, :, :, which]
    # (tile, ks, mt, g, t, pair, half) -> rows (ks, t, pair), columns
    # (tile, mt, half, g)
    return np.ascontiguousarray(f.transpose(1, 4, 5, 0, 2, 6, 3)).reshape(
        n_ks * 8, tiles * 64)


def _staged_frames(x, n_fft, hop):
    """(B * n_frames, n_fft): the frames as the kernel's blocks read them,
    from a staging buffer built as mel.cu builds it, tile by tile (the
    kernel's own layout bound is checked on the card)."""
    B, T = x.shape
    n_frames = 1 + T // hop
    skew = 8 if hop % 16 == 0 else 0
    pad, FT = n_fft // 2, FRAMES
    total = B * n_frames
    rows = []
    for g0 in range(0, total, FT):
        nf = min(FT, total - g0)
        buf = np.zeros(FT * (n_fft + skew * (n_fft // hop + 2) + 4)
                       + FT * hop, np.float32)
        written = np.zeros(buf.shape, bool)
        off = np.zeros(FT, np.int64)
        base, i, gf = 0, 0, g0
        while i < nf:
            b, f = divmod(gf, n_frames)
            cnt = min(nf - i, n_frames - f)
            L = (cnt - 1) * hop + n_fft
            off[i:i + cnt] = base + np.arange(cnt) * (hop + skew)
            p = f * hop + np.arange(L)
            s = np.abs(p - pad)
            s = np.where(s >= T, 2 * (T - 1) - s, s)
            v = np.where(p < T + 2 * pad, x[b][np.clip(s, 0, T - 1)], 0.0)
            at = base + np.arange(L) + (skew * (np.arange(L) // hop)
                                        if skew else 0)
            buf[at] = v
            written[at] = True
            Ls = L + (skew * ((L - 1) // hop) if skew else 0)
            base += (Ls + 3) & ~3
            i += cnt
            gf += cnt
        # frame i, sample k: off[i] + k + skew * (k // hop), as the k-steps
        # of 8 samples read it (a k-step never crosses a hop where skew > 0)
        k = np.arange(n_fft)
        cols = k + (skew * (k // hop) if skew else 0)
        at = off[:nf, None] + cols[None, :]
        assert written[at].all()        # no frame reads an unstaged float
        rows.append(buf[at])
    return torch.from_numpy(np.concatenate(rows))


def _trunc(a: torch.Tensor) -> torch.Tensor:
    """The TF32 value mma.sync reads from an f32 register: top 19 bits."""
    return (a.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def emulate(x, cfg, passes=3):
    """The kernel's output for waveforms x (B, T) f32, and its mel sums S."""
    n_fft, hop, win_length = mel_torch._resolve(cfg)
    n_mels = cfg.num_mels
    _, _, tiles, frag, rows, _ = _consts(
        n_fft, win_length, cfg.sample_rate, n_mels, float(cfg.fmin),
        float(cfg.fmax))
    frames = _staged_frames(x, n_fft, hop)
    xb = _tf32(frames)                      # staged halves, both rounded
    xs = _tf32(frames - xb)
    mel_rows = torch.from_numpy(rows)
    depth, groups = DEPTH, GROUPS

    def dft(which, t):
        b = torch.from_numpy(_decode(frag, which))[:, t]
        big = _tf32(b)                      # split in registers: small = b - big,
        small = _trunc(b - big)             # truncated as the mma reads it
        # the k-groups take the k-steps of each stage in turn, each stage in
        # fresh accumulators; the groups' sums are added in group order
        sums = [torch.zeros(frames.shape[0], b.shape[1])
                for _ in range(groups)]
        for k in range(0, n_fft, depth):
            for grp in range(groups):
                sl = torch.tensor([c for c in range(k, min(k + depth, n_fft))
                                   if (c - k) // 8 % groups == grp],
                                  dtype=torch.long)
                if passes == 1:
                    stage = xb[:, sl] @ big[sl]
                else:
                    stage = (xb[:, sl] @ small[sl] + xs[:, sl] @ big[sl]
                             + xb[:, sl] @ big[sl])
                sums[grp] = sums[grp] + stage
        out = sums[0]
        for grp in range(1, groups):
            out = out + sums[grp]
        return out

    S = torch.zeros(frames.shape[0], n_mels)
    for bt in range(tiles):                 # the tiles' sums in tile order
        t = slice(bt * TILE_BINS, (bt + 1) * TILE_BINS)
        re, im = dft(0, t), dft(1, t)
        S = S + torch.sqrt(re * re + im * im) @ mel_rows[t]
    out = torch.log10(torch.where(S < 1e-10, torch.full_like(S, 1e-10), S))
    B = x.shape[0]
    return out.reshape(B, -1, n_mels), S.reshape(B, -1, n_mels)


def _errors(x, cfg, passes=3):
    got, _ = emulate(x, cfg, passes)
    y = torch.from_numpy(x)
    want = mel_torch.logmelspectrogram_torch(y, cfg)
    S = mel_torch.mel_power_torch(y, cfg).double().clamp(min=1e-10)
    host = np.stack([audio.logmelspectrogram(r, cfg) for r in x])
    return dict(
        log=float((got - want).abs().max()),
        S=float((10.0 ** got.double() - S).abs().max() / S.max()),
        host=float(np.abs(got.numpy() - host).max()))


CASES = {
    # (config overrides, batch rows, samples)
    "flagship": ({}, 2, 9000),          # 36 frames a row: tiles span rows
    "flagship_short": ({}, 3, 3000),    # 12 frames a row: 3 rows a tile
    "win_length_800": ({"win_length": 800}, 1, 12000),
    "fft256_hop64_mels40": ({"fft_size": 256, "hop_size": 64,
                             "win_length": 256, "num_mels": 40}, 2, 5000),
    "hop_300": ({"hop_size": 300}, 1, 9000),
    "full_band": ({"fmin": 0, "fmax": 11025}, 1, 9000),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_kernel_meets_the_phase_8_limits(case):
    over, B, T = CASES[case]
    x = np.stack([_sig(T, seed=10 + i) for i in range(B)])
    err = _errors(x, Config(**over))
    assert err["log"] <= TOL["log"], err
    assert err["S"] <= TOL["S"], err
    assert err["host"] <= TOL["host"], err


def test_a_single_tf32_pass_misses_the_limits():
    x = _sig(9000, seed=3)[None]
    err = _errors(x, Config(), passes=1)
    assert err["S"] > TOL["S"], err
    assert _errors(x, Config())["S"] <= TOL["S"]


@pytest.mark.parametrize("n_fft,fmin,fmax,bins,tiles", [
    (1024, 125.0, 7600.0, (6, 353), 6),     # the shipped presets
    (1024, 0.0, 11025.0, (1, 512), 8),      # the full band
    (2048, 0.0, 11025.0, (1, 1024), 16),    # a wider transform
])
def test_used_bins_and_bin_tiles(n_fft, fmin, fmax, bins, tiles):
    got = _consts(n_fft, n_fft, 22050, 80, fmin, fmax)
    assert got[:3] == (*bins, tiles)


def test_fragments_hold_the_dft_of_the_used_bins():
    cfg = Config()
    cos_m, sin_m = mel_torch._dft_mats(1024, 1024)
    k0, k1, tiles, frag, rows, bands = _consts(
        1024, 1024, 22050, 80, 125.0, 7600.0)
    assert frag.shape == (tiles, 128, 4, 2, 32, 4) and frag.dtype == np.float32
    for which, m in ((0, cos_m), (1, sin_m)):
        got = _decode(frag, which)
        assert np.array_equal(got[:, :k1 - k0], m[:, k0:k1])
        assert not got[:, k1 - k0:].any()
    mel = mel_torch._mel_mat(cfg.sample_rate, 1024, 80, 125.0, 7600.0)
    assert np.array_equal(rows[:k1 - k0], mel[k0:k1])
    assert not rows[k1 - k0:].any()
    # each band's weights lie in its [first, last + 1) used bins: the
    # kernel's mel sums skip only exact zeros
    for j, (lo, hi) in enumerate(bands):
        assert 0 <= lo < hi <= k1 - k0
        assert not rows[:lo, j].any() and not rows[hi:, j].any()


def test_tf32_split_keeps_f32_accuracy():
    """big = rna(b) and small = b - big as the mma reads it (truncated):
    big + small is b within 2^-21 of its size, both TF32 values."""
    b = torch.from_numpy(np.random.RandomState(0).randn(4096)
                         .astype(np.float32))
    big = _tf32(b)
    small = _trunc(b - big)
    for h in (big, small):
        assert not (h.view(torch.int32) & 0x1FFF).any()
    assert float(((big + small).double() - b.double()).abs().div(
        b.double().abs()).max()) <= 2.0 ** -21
    # rna: a tie rounds away from zero
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert _tf32(tie).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]


@pytest.mark.parametrize("preset", PRESETS, ids=os.path.basename)
def test_used_bins_are_the_nonzero_rows_of_the_jax_mel_matrix(preset):
    cfg = load_config(preset)
    n_fft = cfg.fft_size
    ref = mel_jax._mel_mat(cfg.sample_rate, n_fft, cfg.num_mels,
                           float(cfg.fmin), float(cfg.fmax))
    nz = np.nonzero(ref.any(axis=1))[0]
    k0, k1 = mel_torch.used_bins(
        mel_torch._mel_mat(cfg.sample_rate, n_fft, cfg.num_mels,
                           float(cfg.fmin), float(cfg.fmax)))
    assert (k0, k1) == (nz[0], nz[-1] + 1) == (6, 353)
    assert np.array_equal(np.arange(k0, k1), nz)


def test_a_nan_sample_gives_the_nan_frames_of_the_jax_package():
    x = _sig(9000, seed=5)
    x[4000] = np.nan
    cfg = Config()
    plain = mel_torch.logmelspectrogram_torch(torch.from_numpy(x), cfg).numpy()
    xla = np.asarray(mel_jax.logmelspectrogram_jax(x, JaxConfig()))
    pallas = np.asarray(mel_jax.logmelspectrogram_pallas(
        x, JaxConfig(), f_blk=16, interpret=True))
    emulated = emulate(x[None], cfg)[0][0].numpy()
    mask = np.isnan(plain)
    # the frames whose window covers sample 4000 (+ 512 of padding), every band
    frames = [f for f in range(plain.shape[0]) if 0 <= 4512 - 256 * f < 1024]
    assert np.array_equal(np.nonzero(mask.all(axis=1))[0], frames)
    assert mask.sum() == len(frames) * 80
    for other in (xla, pallas, emulated):
        assert np.array_equal(np.isnan(other), mask)
        assert np.abs(other[~mask] - plain[~mask]).max() <= TOL["log"]
