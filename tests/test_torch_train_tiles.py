"""The tiling of the tensor-core training kernels (``csrc/train_fwd.cu``,
``csrc/train_bwd.cu``, bf16 path), emulated in plain PyTorch on the CPU and
held against the plain versions ``fused_res_stack_fwd_plain`` /
``fused_res_stack_bwd_plain`` in f32, where the two differ only in the order
of their sums.

The emulation follows the kernels step by step: 64-position tiles whose
operands are gathered with zero fill (taps at t < 0, rows past T, dz of
positions past T in the transposed conv), the z product as matching a- and
b-halves in passes of 128 gate columns with the depth in slices of 16, the
out|skip product in passes of 256 columns, and the weight gradients as the
wrapper's output tiles (``cuda_train.wgrad_tiles``) summed over its position
chunks (``cuda_train.wgrad_chunk``), 32 positions a stage, the last chunk
ragged. The card's own run of the kernels is in ``test_torch_kernels.py``.
"""
import math

import numpy as np
import pytest
import torch

from wavenet_vocoder_tpu_torch.ops import cuda_train as ct
from wavenet_vocoder_tpu_torch.ops import fused_train as ft

TILE = 64          # positions of a position tile
Z_COLS = 128       # a-columns (and b-columns) of a z pass
OG_COLS = 256      # columns of an out|skip pass
SLICE = 16         # depth of a weight slice
SQRT_HALF = math.sqrt(0.5)
SMS = 132          # the H100's SM count, for the wrapper's chunk plan

# (L, dilations, R, G, S, cin), as tests/test_torch_kernels.py
WIDTHS = {"small": (4, (1, 2, 1, 2), 16, 32, 24, 8),
          "wide": (3, (1, 2, 4), 64, 288, 80, 20),
          "flagship": (3, (1, 8, 32), 128, 256, 128, 80)}
CASES = [(True, True, 0.2), (False, False, 0.0)]   # (c, gb, dropout)


def _inputs(width, cond, glob, B=2, T=130, seed=0):
    L, dils, R, G, S, cin = WIDTHS[width]
    rs = np.random.RandomState(seed)
    t = lambda *s, sc=1.0: torch.from_numpy((rs.randn(*s) * sc).astype(np.float32))
    x0 = t(B, T, R, sc=0.5)
    c = t(B, T, cin) if cond else None
    gb = t(L, B, G, sc=0.2) if glob else None
    w_in = t(L, 3 * R, G, sc=(3 * R) ** -0.5)
    w_cond = t(L, cin, G, sc=cin ** -0.5) if cond else None
    w_og = t(L, G // 2, R + S, sc=(G // 2) ** -0.5)
    b_in, b_og = t(L, G, sc=0.1), t(L, R + S, sc=0.1)
    return (x0, c, gb, w_in, b_in, w_cond, w_og, b_og), t(B, T, S), dils


def _sliced(a, w):
    """a @ w with the depth taken in slices of 16, as the ring does."""
    out = torch.zeros(a.shape[0], w.shape[1])
    for s in range(0, a.shape[1], SLICE):
        out += a[:, s:s + SLICE] @ w[s:s + SLICE]
    return out


def _mask(drop, seed, B, T, R, L, l, H):
    if drop <= 0:
        return None
    return ft.dropout_mask(seed, B=B, T=T, R=R, L=L, l=l, t0=H, keep=1.0 - drop)


def _tap_rows(x, mask, b, t, drop, T):
    """Rows t of layer input x[b] as conv input (dropped and rescaled), zero
    where t < 0 or t >= T."""
    out = torch.zeros(len(t), x.shape[-1])
    ok = (t >= 0) & (t < T)
    rows = x[b, t[ok]]
    if mask is not None:
        rows = rows * mask[b, t[ok]] * (1.0 / (1.0 - drop))
    out[ok] = rows
    return out


def _z_operand(x, mask, c, b, t0, d, k, drop, T):
    """The resident [taps | c] operand of a tile: 64 rows, rows past T zero."""
    m = torch.arange(TILE)
    live = (t0 + m < T).float()[:, None]
    parts = [_tap_rows(x, mask, b, t0 + m - (k - 1 - j) * d, drop, T) * live
             for j in range(k)]
    if c is not None:
        parts.append(_tap_rows(c, None, b, t0 + m, 0.0, T) * live)
    return torch.cat(parts, dim=1)


def _z_passes(A, w, bias, G2):
    """z by passes of 128 a-columns with the matching b-columns; yields
    (columns, za, zb) with the bias added."""
    for c0 in range(0, G2, Z_COLS):
        cols = torch.arange(c0, min(c0 + Z_COLS, G2))
        za = _sliced(A, w[:, cols]) + bias[cols]
        zb = _sliced(A, w[:, G2 + cols]) + bias[G2 + cols]
        yield cols, za, zb


def _layer_weights(w_in, w_cond, l):
    return w_in[l] if w_cond is None else torch.cat([w_in[l], w_cond[l]], 0)


def _tile_bias(b_in, gb, l, b):
    return b_in[l] + (0.0 if gb is None else gb[l, b])


def emulate_fwd(x0, c, gb, w_in, b_in, w_cond, w_og, b_og, *, dils, k, drop,
                seed):
    L, (B, T, R) = len(dils), x0.shape
    G2, RS = w_og.shape[1], w_og.shape[2]
    H = ft.stack_receptive(dils, k)
    x = x0.clone()
    skips = torch.zeros(B, T, RS - R)
    xs = []
    for l, d in enumerate(dils):
        xs.append(x.clone())
        mask = _mask(drop, seed, B, T, R, L, l, H)
        xn = torch.zeros_like(x)
        w = _layer_weights(w_in, w_cond, l)
        for b in range(B):
            for t0 in range(0, T, TILE):
                A = _z_operand(xs[l], mask, c, b, t0, d, k, drop, T)
                gated = torch.zeros(TILE, G2)
                for cols, za, zb in _z_passes(A, w, _tile_bias(b_in, gb, l, b), G2):
                    gated[:, cols] = torch.tanh(za) * torch.sigmoid(zb)
                n = min(TILE, T - t0)
                for n0 in range(0, RS, OG_COLS):
                    cols = slice(n0, min(n0 + OG_COLS, RS))
                    y = (_sliced(gated, w_og[l][:, cols]) + b_og[l][cols])[:n]
                    for i, col in enumerate(range(cols.start, cols.stop)):
                        if col < R:
                            xn[b, t0:t0 + n, col] = (y[:, i] + x[b, t0:t0 + n, col]) * SQRT_HALF
                        else:
                            skips[b, t0:t0 + n, col - R] += y[:, i]
        x = xn
    return skips, torch.stack(xs)


def emulate_bwd(dskips, xs, c, gb, w_in, b_in, w_cond, w_og, b_og, *, dils, k,
                drop, seed):
    L, B, T, R = xs.shape
    G = w_in.shape[2]
    G2, RS = G // 2, w_og.shape[2]
    cin = 0 if c is None else c.shape[2]
    H = ft.stack_receptive(dils, k)
    P = B * T
    tiles = ct.wgrad_tiles(k, R, G, RS - R, cin, True)
    chunk = ct.wgrad_chunk(P, len(tiles), SMS, True)
    assert P % chunk, "the emulation should see a ragged last chunk"
    dw_in, db_in = torch.zeros(w_in.shape), torch.zeros(b_in.shape)
    dw_og, db_og = torch.zeros(w_og.shape), torch.zeros(b_og.shape)
    dw_cond = None if c is None else torch.zeros(w_cond.shape)
    dgb = None if gb is None else torch.zeros(gb.shape)
    dc = None if c is None else torch.zeros(c.shape)
    dx = torch.zeros(B, T, R)
    for l in range(L - 1, -1, -1):
        d = dils[l]
        mask = _mask(drop, seed, B, T, R, L, l, H)
        w = _layer_weights(w_in, w_cond, l)
        dz = torch.zeros(B, T, G)
        gated = torch.zeros(B, T, G2)
        dyr = torch.cat([dx * SQRT_HALF, dskips], dim=-1)
        # bwd_dz: per tile, z recomputed by passes, dgated by the same passes
        for b in range(B):
            for t0 in range(0, T, TILE):
                n = min(TILE, T - t0)
                A = _z_operand(xs[l], mask, c, b, t0, d, k, drop, T)
                Ds = torch.zeros(TILE, RS)
                Ds[:n] = dyr[b, t0:t0 + n]
                db_og[l] += Ds.sum(0)
                for cols, za, zb in _z_passes(A, w, _tile_bias(b_in, gb, l, b), G2):
                    ta, sb = torch.tanh(za), torch.sigmoid(zb)
                    gated[b, t0:t0 + n, cols] = (ta * sb)[:n]
                    dg = _sliced(Ds, w_og[l][cols].t())
                    dza, dzb = dg * sb * (1 - ta * ta), dg * ta * sb * (1 - sb)
                    dz[b, t0:t0 + n, cols] = dza[:n]
                    dz[b, t0:t0 + n, G2 + cols] = dzb[:n]
                    for cc, v in ((cols, dza), (G2 + cols, dzb)):
                        db_in[l, cc] += v.sum(0)
                        if dgb is not None:
                            dgb[l, b, cc] += v.sum(0)
        # bwd_wgrad: output tiles, position chunks, stages of 32 positions
        x_l = xs[l]
        flat = lambda a: a.reshape(P, -1)
        taps = torch.cat([torch.stack([_tap_rows(x_l, mask, b, torch.arange(T) - (k - 1 - j) * d,
                                                 drop, T) for b in range(B)])
                          for j in range(k)], dim=-1)
        srcs = [(flat(taps), flat(dz), dw_in[l]),
                (None if c is None else flat(c), flat(dz), None if c is None else dw_cond[l]),
                (flat(gated), flat(dyr), dw_og[l])]
        for which, m0, n0 in tiles:
            a_src, b_src, out = srcs[which]
            rows = slice(m0, min(m0 + 64, out.shape[0]))
            cols = slice(n0, min(n0 + 256, out.shape[1]))
            for p0 in range(0, P, chunk):
                acc = torch.zeros(rows.stop - rows.start, cols.stop - cols.start)
                for q0 in range(p0, min(p0 + chunk, P), 32):
                    q = slice(q0, min(q0 + 32, p0 + chunk, P))
                    acc += a_src[q, rows].t() @ b_src[q, cols]
                out[rows, cols] += acc
        # bwd_dx: shifted dz resident (zero past T), w_in and w_cond as stored
        dx_new = torch.zeros(B, T, R)
        w_in_t = torch.cat([w_in[l, j * R:(j + 1) * R].t() for j in range(k)], 0)
        for b in range(B):
            for t0 in range(0, T, TILE):
                n = min(TILE, T - t0)
                m = torch.arange(TILE)
                live = (t0 + m < T).float()[:, None]
                Xs = torch.cat([_tap_rows(dz, None, b, t0 + m + (k - 1 - j) * d, 0.0, T) * live
                                for j in range(k)], dim=1)
                v = _sliced(Xs, w_in_t)[:n]
                if mask is not None:
                    v = v * mask[b, t0:t0 + n] * (1.0 / (1.0 - drop))
                dx_new[b, t0:t0 + n] = dx[b, t0:t0 + n] * SQRT_HALF + v
                if dc is not None:
                    dc[b, t0:t0 + n] += _sliced(Xs[:, (k - 1) * G:], w_cond[l].t())[:n]
        dx = dx_new
    return dx, dc, dgb, dw_in, db_in, dw_cond, dw_og, db_og


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("cond,glob,drop", CASES)
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_fwd_tiling_matches_plain(width, cond, glob, drop):
    """skips and the x_l stash of the tiled forward within 1e-6 (relative
    to each output's largest value) of the plain forward, in f32."""
    inputs, _, dils = _inputs(width, cond, glob)
    kw = dict(dils=dils, k=3, drop=drop, seed=-12345)
    got = emulate_fwd(*inputs, **kw)
    want = ft.fused_res_stack_fwd_plain(*inputs, **kw)
    for name, g, w in zip(("skips", "xs"), got, want):
        assert _rel_err(g, w) <= 1e-6, (name, _rel_err(g, w))


@pytest.mark.parametrize("cond,glob,drop", CASES)
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_bwd_tiling_matches_plain(width, cond, glob, drop):
    """All eight gradients of the tiled backward (tiles, passes, chunked
    weight gradients with a ragged last chunk) within 1e-6 of the plain
    backward, in f32."""
    inputs, dskips, dils = _inputs(width, cond, glob)
    kw = dict(dils=dils, k=3, drop=drop, seed=-12345)
    _, xs = ft.fused_res_stack_fwd_plain(*inputs, **kw)
    args = (dskips, xs) + inputs[1:]
    got = emulate_bwd(*args, **kw)
    want = ft.fused_res_stack_bwd_plain(*args, **kw)
    names = ("dx0", "dc", "dgb", "dw_in", "db_in", "dw_cond", "dw_og", "db_og")
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None, name
            continue
        assert _rel_err(g, w) <= 1e-6, (name, _rel_err(g, w))


@pytest.mark.parametrize("bf16", [True, False], ids=["tc", "fma"])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_wgrad_tiles_cover_each_gradient_once(width, bf16):
    """The weight-gradient tiles cover every element of dW_in, dW_cond and
    dW_og exactly once, and the chunks are whole stages that cover B*T."""
    _, _, R, G, S, cin = WIDTHS[width]
    tiles = ct.wgrad_tiles(3, R, G, S, cin, bf16)
    rows, cols = ct.WGRAD_TILE[bf16]
    shapes = ((3 * R, G), (cin, G), (G // 2, R + S))
    cover = [torch.zeros(s, dtype=torch.int32) for s in shapes]
    for which, m0, n0 in tiles:
        cover[which][m0:m0 + rows, n0:n0 + cols] += 1
    assert all(bool((cv == 1).all()) for cv in cover)
    for P in (260, 3003, 81920):
        chunk = ct.wgrad_chunk(P, len(tiles), SMS, bf16)
        assert chunk % ct.WGRAD_STAGE == 0
        n = -(-P // chunk)
        assert (n - 1) * chunk < P <= n * chunk
