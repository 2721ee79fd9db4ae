// Backward of the WaveNet residual stack for training, for Hopper (sm_90a):
// three launches per layer, walked from the top layer down.
//
// Replaces: wavenet_vocoder_tpu/ops/pallas_train.py::_make_bwd_kernel (through
// _bwd_call's pl.pallas_call), on its xs_hbm path without the activation
// stash: x_l comes from the forward's stash, z is recomputed, dz walks the
// layers top-down, and the dropout mask is regenerated from the same counter
// hash. Outputs dx0, dc, dgb, dW_in, db_in, dW_cond, dW_og, db_og, all f32.
//
// What bounds it on an H100: per position and layer it recomputes z (464 x
// 256 MACs at the flagship width) and does the dgated, dx, dc and three
// weight-gradient products: 10,125,312 MACs per position for 24 layers,
// 1.66 TFLOP at B=8, T=10240, or 1.68 ms at the bf16 tensor-core rate —
// arithmetic, not bytes.
//
// What this design does about it:
//   * The TPU kernel owns a right-extended time window per tile and masks
//     the weight gradients to its home positions; that relies on its
//     in-order grid and VMEM accumulators. Here each layer is split at the
//     points where a block needs another block's results:
//       1. bwd_dz (blocks over position tiles): recompute z from the x_l
//          stash, dy = [dx_{l+1} * sqrt(1/2) | dskips], dgated = round(dy) @
//          w_og^T, dz; writes round(dz) and round(gated) for the next two
//          launches, and adds the tile's sums of dz (db_in, dgb) and of
//          round(dy) (db_og) with f32 atomics.
//       2. bwd_wgrad: the weight gradients round(taps)^T round(dz),
//          round(c)^T round(dz) and round(gated)^T round(dy), each a product
//          over all B*T positions, split over position chunks; every block
//          sums its chunk in registers and adds its output tile to the f32
//          result with atomics (so the order of the sum changes from run to
//          run).
//       3. bwd_dx (blocks over position tiles): the transposed dilated
//          conv dx_l[t] = dx_{l+1}[t] * sqrt(1/2) + mask * sum_j round(dz)[t
//          + (k-1-j) d] @ w_in_j^T, which reads dz of later positions owned
//          by other blocks (hence the launch boundary), and dc += round(dz)
//          @ w_cond^T.
//   * The rounding points are the TPU kernel's: dgated from round(dy), the
//     weight gradients and dx from round(dz), the bias gradients from f32 dz
//     (db_og from round(dy)).
//   * Dispatch by storage dtype. bf16 storage (the training path) runs the
//     tensor-core kernels bwd_dz_tc, bwd_wgrad_tc, bwd_dx_tc (train_mma.cuh:
//     mma.sync m16n8k16, bf16 in, f32 sums, operands staged by cp.async,
//     weights read as stored, the transposed products taken by ldmatrix.trans):
//       - bwd_dz_tc and bwd_dx_tc take 128 positions a block (16 warps; 64
//         where 128 rows do not fit in shared memory), as the forward.
//       - bwd_dz_tc shares the forward's z product (a- and b-halves in the same
//         registers), keeps (tanh a, sigmoid b) in registers across the
//         dgated product (B = w_og rows as stored), forms dz there, and sums
//         its columns by warp shuffles before one atomic per column and warp.
//         It also writes round(dy) (dyr) for the dW_og product.
//       - bwd_wgrad_tc: 64 x 256 output tiles, each block a chunk of
//         positions (about two blocks per SM), 32 positions a stage in a
//         4-stage ring; A (position-major inputs) goes through
//         ldmatrix.trans; one f32 atomic per output element and block.
//       - bwd_dx_tc keeps the k shifted copies of round(dz) (zero past T)
//         resident and streams w_in and w_cond.
//     f32 storage runs the FMA-tile kernels bwd_dz, bwd_wgrad, bwd_dx
//     (TF32 would break the f32 path's 1e-4 limits); a bf16 launch never
//     takes them.
//   * bf16 widths: R a multiple of 8, G of 16 and S even (the wrapper
//     checks).
#include "train_common.cuh"
#include "train_mma.cuh"

namespace {

using namespace wn;

__device__ __forceinline__ float dy_value(const TrainArgs& a, long long pos, int col) {
  if (col < a.R) return a.dx_next ? a.dx_next[pos * a.R + col] * kSqrtHalf : 0.0f;
  return a.dskips[pos * a.S + (col - a.R)];
}

__global__ void __launch_bounds__(kThreads) bwd_dz(TrainArgs a) {
  extern __shared__ float smem[];
  float* zs = smem;                          // BM x G: z, then (tanh a | sigmoid b), then dz
  float* tile = smem + BM * a.G;
  const int b = blockIdx.y, t0 = blockIdx.x * BM;
  const int G = a.G, G2 = G / 2, R = a.R, RS = R + a.S;
  const int rows = min(BM, a.T - t0);

  compute_z(a, b, t0, zs, tile);

  for (int e = threadIdx.x; e < BM * G2; e += kThreads) {
    const int m = e / G2, g = e - m * G2;
    const float ta = tanhf(zs[m * G + g]), sb = sigmoidf_(zs[m * G + G2 + g]);
    zs[m * G + g] = ta;
    zs[m * G + G2 + g] = sb;
    if (m < rows)
      static_cast<float*>(a.gated)[((long long)b * a.T + t0 + m) * G2 + g] = (ta * sb);
  }
  __syncthreads();

  // dgated = round(dy) @ w_og^T -> dz, in place over (ta | sb)
  const long long wofs = (long long)a.l * RS * G2;
  for (int n0 = 0; n0 < G2; n0 += BN) {
    float acc[TM][TN];
    tile_product<true>(
        acc, RS, tile,
        [&](int m, int kk) -> float {
          if (m >= rows) return 0.0f;
          return (dy_value(a, (long long)b * a.T + t0 + m, kk));
        },
        [&](int kk, int n) -> float {
          const int col = n0 + n;
          return col < G2 ? ldf(a.w_og, wofs + (long long)col * RS + kk) : 0.0f;
        });
    tile_store(acc, [&](int m, int n, float dg) {
      const int g = n0 + n;
      if (g >= G2) return;
      const float ta = zs[m * G + g], sb = zs[m * G + G2 + g];
      zs[m * G + g] = dg * sb * (1.0f - ta * ta);
      zs[m * G + G2 + g] = dg * ta * sb * (1.0f - sb);
    });
  }
  __syncthreads();

  // round(dz) out; f32 column sums of dz -> db_in, dgb
  for (int col = threadIdx.x; col < G; col += kThreads) {
    float sum = 0.0f;
    for (int m = 0; m < rows; ++m) {
      const float v = zs[m * G + col];
      sum += v;
      static_cast<float*>(a.dz)[((long long)b * a.T + t0 + m) * G + col] = (v);
    }
    atomicAdd(&a.db_in[a.l * G + col], sum);
    if (a.dgb) atomicAdd(&a.dgb[((long long)a.l * a.B + b) * G + col], sum);
  }
  // column sums of round(dy) -> db_og
  for (int col = threadIdx.x; col < RS; col += kThreads) {
    float sum = 0.0f;
    for (int m = 0; m < rows; ++m) sum += (dy_value(a, (long long)b * a.T + t0 + m, col));
    atomicAdd(&a.db_og[a.l * RS + col], sum);
  }
}

// Weight gradients of layer l. blockIdx.x enumerates the output tiles of the
// three products (dW_in: k*R x G, dW_cond: cin x G, dW_og: G/2 x (R+S), each
// cut into BM x BN tiles); blockIdx.y the chunk of positions [y*chunk,
// (y+1)*chunk) of the flattened (b, t) axis.
__global__ void __launch_bounds__(kThreads) bwd_wgrad(TrainArgs a) {
  extern __shared__ float smem[];
  const int G = a.G, G2 = G / 2, R = a.R, RS = R + a.S, kR = a.k * R;
  const int cin = a.c ? a.cin : 0;
  const long long P = (long long)a.B * a.T;
  const long long p0 = (long long)blockIdx.y * a.chunk;
  if (p0 >= P) return;
  const int K = (int)min((long long)a.chunk, P - p0);

  const int nG = (G + BN - 1) / BN, nRS = (RS + BN - 1) / BN;
  const int t_in = (kR + BM - 1) / BM * nG;
  const int t_cond = (cin + BM - 1) / BM * nG;
  int tile_id = blockIdx.x, which;
  if (tile_id < t_in) {
    which = 0;
  } else if (tile_id < t_in + t_cond) {
    which = 1;
    tile_id -= t_in;
  } else {
    which = 2;
    tile_id -= t_in + t_cond;
  }
  const int ncols = which == 2 ? nRS : nG;
  const int m0 = tile_id / ncols * BM, n0 = tile_id % ncols * BN;
  const int M = which == 0 ? kR : which == 1 ? cin : G2;
  const int N = which == 2 ? RS : G;

  float acc[TM][TN];
  tile_product<false>(
      acc, K, smem,
      [&](int m, int kk) -> float {
        const int row = m0 + m;
        if (row >= M) return 0.0f;
        const long long pos = p0 + kk;
        if (which == 0) {
          const int b = (int)(pos / a.T), t = (int)(pos - (long long)b * a.T);
          const int j = row / R, r = row - j * R;
          return conv_input(a, b, t - (a.k - 1 - j) * a.d, r);
        }
        if (which == 1) return ldf(a.c, pos * a.cin + row);
        return ldf(a.gated, pos * G2 + row);
      },
      [&](int kk, int n) -> float {
        const int col = n0 + n;
        if (col >= N) return 0.0f;
        const long long pos = p0 + kk;
        if (which == 2) return (dy_value(a, pos, col));
        return ldf(a.dz, pos * G + col);
      });
  float* out = which == 0 ? a.dw_in + (long long)a.l * kR * G
             : which == 1 ? a.dw_cond + (long long)a.l * a.cin * G
                          : a.dw_og + (long long)a.l * G2 * RS;
  tile_store(acc, [&](int m, int n, float v) {
    const int row = m0 + m, col = n0 + n;
    if (row < M && col < N) atomicAdd(&out[(long long)row * N + col], v);
  });
}

__global__ void __launch_bounds__(kThreads) bwd_dx(TrainArgs a) {
  extern __shared__ float smem[];
  const int b = blockIdx.y, t0 = blockIdx.x * BM;
  const int G = a.G, R = a.R, k = a.k;
  const long long row0 = (long long)b * a.T + t0;

  // dxin = sum_j round(dz)[t + (k-1-j) d] @ w_in_j^T, over K = k*G
  const long long wofs = (long long)a.l * k * R * G;
  for (int n0 = 0; n0 < R; n0 += BN) {
    float acc[TM][TN];
    tile_product<true>(
        acc, k * G, smem,
        [&](int m, int kk) -> float {
          const int j = kk / G, g = kk - j * G;
          const int t = t0 + m + (k - 1 - j) * a.d;
          if (t0 + m >= a.T || t >= a.T) return 0.0f;
          return ldf(a.dz, ((long long)b * a.T + t) * G + g);
        },
        [&](int kk, int n) -> float {
          const int col = n0 + n;
          if (col >= R) return 0.0f;
          const int j = kk / G, g = kk - j * G;
          return ldf(a.w_in, wofs + (long long)(j * R + col) * G + g);
        });
    tile_store(acc, [&](int m, int n, float v) {
      const int col = n0 + n, t = t0 + m;
      if (col >= R || t >= a.T) return;
      const long long i = (row0 + m) * R + col;
      if (a.has_drop) v *= keep_bit(a, b, t, col) ? a.inv_keep : 0.0f;
      a.dx_out[i] = (a.dx_next ? a.dx_next[i] * kSqrtHalf : 0.0f) + v;
    });
  }
  if (!a.dc) return;
  // dc += round(dz) @ w_cond^T
  const long long cofs = (long long)a.l * a.cin * G;
  for (int n0 = 0; n0 < a.cin; n0 += BN) {
    float acc[TM][TN];
    tile_product<true>(
        acc, G, smem,
        [&](int m, int kk) -> float {
          return t0 + m < a.T ? ldf(a.dz, (row0 + m) * G + kk) : 0.0f;
        },
        [&](int kk, int n) -> float {
          const int col = n0 + n;
          return col < a.cin ? ldf(a.w_cond, cofs + (long long)col * G + kk) : 0.0f;
        });
    tile_store(acc, [&](int m, int n, float v) {
      const int col = n0 + n;
      if (col < a.cin && t0 + m < a.T) a.dc[(row0 + m) * a.cin + col] += v;
    });
  }
}

// ============================================== bf16: tensor-core kernels
using tc::bf16;

constexpr int kStages = 3;               // ring stages of the position-tile kernels

// bwd_dz_tc shared memory: the z operand, round(dy) ([rows][d_ld]), the ring
// (a stage holds a z weight slice or a w_og^T slice).
constexpr int kDzBK = 16;                // depth of a weight slice
constexpr int kDzStage = kDzBK * tc::kZld > tc::kWtCols * (kDzBK + 8) ? kDzBK * tc::kZld
                                                                    : tc::kWtCols * (kDzBK + 8);
struct DzLayout {
  tc::ZLayout z;
  int RSp, d_ld;
  __host__ __device__ explicit DzLayout(const TrainArgs& a) : z(a, kDzBK) {
    RSp = tc::round_up(a.R + a.S, kDzBK);
    d_ld = tc::pad_ld(RSp);
  }
  __host__ __device__ size_t smem_elems(int rows) const {
    return (size_t)rows * (z.a_ld + d_ld) + (size_t)kStages * kDzStage;
  }
};

// kDzRows positions a block (128, or 64 where 128 rows do not fit)
template <int kDzRows>
__global__ void __launch_bounds__(tc::Tile<kDzRows>::kThreads, 1) bwd_dz_tc(TrainArgs a) {
  using DzTile = tc::Tile<kDzRows>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const DzLayout L(a);
  bf16* As = reinterpret_cast<bf16*>(smem_raw);       // [rows][a_ld]: taps | c
  bf16* Ds = As + kDzRows * L.z.a_ld;                 // [rows][d_ld]: round(dy)
  bf16* ring = Ds + kDzRows * L.d_ld;
  const int b = blockIdx.y, t0 = blockIdx.x * kDzRows;
  const int G = a.G, G2 = G / 2, RS = a.R + a.S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const tc::Frag fr;

  tc::issue_z_operand<kDzRows>(a, L.z, b, t0, As);
  // round(dy) while the copies fly: to shared memory (zero past T and RS)
  // and to dyr for bwd_wgrad's dW_og. Two rows of 256 columns a round: the
  // loads first, then the stores.
  for (int m0 = warp; m0 < kDzRows; m0 += 2 * DzTile::kWarps) {
    for (int c0 = lane; c0 < L.RSp; c0 += 256) {
      float v[2][8];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int t = t0 + m0 + h * DzTile::kWarps, col = c0 + 32 * i;
          v[h][i] = t < a.T && col < RS ? dy_value(a, (long long)b * a.T + t, col) : 0.0f;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int m = m0 + h * DzTile::kWarps, t = t0 + m, col = c0 + 32 * i;
          if (col >= L.RSp) continue;
          const bf16 r = __float2bfloat16(v[h][i]);
          Ds[m * L.d_ld + col] = r;
          if (t < a.T && col < RS) static_cast<bf16*>(a.dyr)[((long long)b * a.T + t) * RS + col] = r;
        }
    }
  }
  tc::finish_z_operand<kDzRows>(a, L.z, b, t0, As);
  // column sums of round(dy) -> db_og
  for (int col = threadIdx.x; col < RS; col += DzTile::kThreads) {
    float sum = 0.0f;
    for (int m = 0; m < kDzRows; ++m) sum += __bfloat162float(Ds[m * L.d_ld + col]);
    atomicAdd(&a.db_og[a.l * RS + col], sum);
  }

  const bf16* w_og = static_cast<const bf16*>(a.w_og) + (long long)a.l * G2 * RS;
  float* dgb = a.dgb ? a.dgb + ((long long)a.l * a.B + b) * G : nullptr;
  for (int c0 = 0; c0 < G2; c0 += tc::kZCols) {
    float acc[2][8][4];
    tc::z_product<kDzRows, kDzBK, kStages>(acc, a, L.z, As, ring, c0);
    tc::add_z_bias(acc, a, b, c0);
    // (tanh a | sigmoid b) in place; round(gated) out
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          acc[mi][j][v] = tc::tanh_fast(acc[mi][j][v]);
          acc[mi][j + 4][v] = tc::sigmoid_fast(acc[mi][j + 4][v]);
        }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = c0 + 32 * fr.wn + 8 * j + 2 * fr.t;
      if (gc >= G2) continue;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = t0 + fr.row(mi, 2 * h);
          if (t >= a.T) continue;
          tc::store2(static_cast<bf16*>(a.gated) + ((long long)b * a.T + t) * G2 + gc,
                     acc[mi][j][2 * h] * acc[mi][j + 4][2 * h],
                     acc[mi][j][2 * h + 1] * acc[mi][j + 4][2 * h + 1]);
        }
    }
    // dgated = round(dy) @ w_og^T for the pass's 128 columns: B is w_og rows
    // as stored ([g][rs], the contraction axis contiguous)
    float dg[2][4][4];
    auto load = [&](int s, bf16* stage) {
      tc::stage_wt<kDzBK, DzTile::kThreads>(stage, s, c0, RS, [&](int g, int kk) {
        return g < G2 ? w_og + (long long)g * RS + kk : nullptr;
      });
    };
    tc::ring_product<4, kDzBK, kStages, false, false>(
        dg, Ds, L.d_ld, L.RSp / kDzBK, ring, kDzStage, 0, kDzBK + 8, load, tc::NoPrep(),
        [&](int j) { return 32 * fr.wn + 8 * j; });
    // dz = [dg * sb * (1 - ta^2) | dg * ta * sb * (1 - sb)], in place
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float ta = acc[mi][j][v], sb = acc[mi][j + 4][v], d = dg[mi][j][v];
          acc[mi][j][v] = d * sb * (1.0f - ta * ta);
          acc[mi][j + 4][v] = d * ta * sb * (1.0f - sb);
        }
    // round(dz) out; f32 column sums -> db_in, dgb (rows past T hold 0)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gc = c0 + 32 * fr.wn + 8 * (j & 3) + 2 * fr.t;
      const int col = (j >> 2) * G2 + gc;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = t0 + fr.row(mi, 2 * h);
          if (t >= a.T || gc >= G2) continue;
          tc::store2(static_cast<bf16*>(a.dz) + ((long long)b * a.T + t) * G + col,
                     acc[mi][j][2 * h], acc[mi][j][2 * h + 1]);
        }
      const float2 sum = tc::warp_col_sum<8>(acc, j);
      if (lane < 4 && gc < G2) {
        atomicAdd(&a.db_in[a.l * G + col], sum.x);
        atomicAdd(&a.db_in[a.l * G + col + 1], sum.y);
        if (dgb) {
          atomicAdd(&dgb[col], sum.x);
          atomicAdd(&dgb[col + 1], sum.y);
        }
      }
    }
  }
}

// bwd_wgrad_tc: blockIdx.x enumerates 64-row x 256-column output tiles of
// dW_in (k*R x G), dW_cond (cin x G) and dW_og (G/2 x (R+S)) in that order,
// blockIdx.y the chunk [y*chunk, (y+1)*chunk) of the flattened (b, t) axis.
// A stage holds 32 positions: A = the rows' 64 input channels ([32][72], the
// contraction axis slow: ldmatrix.trans) and B = their 256 gradient columns
// ([32][264]).
constexpr int kWgBK = 32, kWgStages = 4, kWgRows = 64, kWgCols = 256;
constexpr int kWgAld = 72, kWgBld = 264;             // pad_ld(64), pad_ld(256)
constexpr int kWgStage = kWgBK * (kWgAld + kWgBld);

struct WgradTiles {
  int nG, nRS, t_in, t_cond, t_og;
  __host__ __device__ explicit WgradTiles(const TrainArgs& a) {
    const int cin = a.c ? a.cin : 0;
    nG = (a.G + kWgCols - 1) / kWgCols;
    nRS = (a.R + a.S + kWgCols - 1) / kWgCols;
    t_in = (a.k * a.R + kWgRows - 1) / kWgRows * nG;
    t_cond = (cin + kWgRows - 1) / kWgRows * nG;
    t_og = (a.G / 2 + kWgRows - 1) / kWgRows * nRS;
  }
};

__global__ void __launch_bounds__(kThreads) bwd_wgrad_tc(TrainArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  const int G = a.G, G2 = G / 2, R = a.R, RS = R + a.S, kR = a.k * R;
  const int cin = a.c ? a.cin : 0;
  const long long P = (long long)a.B * a.T;
  const long long p0 = (long long)blockIdx.y * a.chunk;
  if (p0 >= P) return;
  const long long pend = min(p0 + a.chunk, P);

  const WgradTiles tl(a);
  int tile = blockIdx.x, which = 0;
  if (tile >= tl.t_in) {
    tile -= tl.t_in;
    which = 1;
    if (tile >= tl.t_cond) {
      tile -= tl.t_cond;
      which = 2;
    }
  }
  const int ncol = which == 2 ? tl.nRS : tl.nG;
  const int m0 = tile / ncol * kWgRows, n0 = tile % ncol * kWgCols;
  const int M = which == 0 ? kR : which == 1 ? cin : G2;
  const int N = which == 2 ? RS : G;
  const bf16* xs = static_cast<const bf16*>(a.xs_l);
  const bf16* asrc = which == 1 ? static_cast<const bf16*>(a.c) : static_cast<const bf16*>(a.gated);
  const int a_row = which == 1 ? cin : G2;
  const bf16* bsrc = static_cast<const bf16*>(which == 2 ? a.dyr : a.dz);

  auto load = [&](int s, bf16* stage) {
    {  // A: one 8-channel piece a thread
      const int r = threadIdx.x >> 3, x = (threadIdx.x & 7) * 8, ch = m0 + x;
      const long long q = p0 + (long long)s * kWgBK + r;
      const bf16* src = xs;
      int n = 0;
      if (q < pend && ch < M) {
        if (which == 0) {
          const int j = ch / R, rr = ch - j * R;
          const int bq = (int)(q / a.T), t = (int)(q - (long long)bq * a.T) - (a.k - 1 - j) * a.d;
          if (t >= 0) {
            src = xs + ((long long)bq * a.T + t) * R + rr;
            n = 8;
          }
        } else {
          src = asrc + q * a_row + ch;
          n = M - ch;
        }
      }
      tc::stage8(stage + r * kWgAld + x, src, n);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // B: four pieces a thread
      const int e = threadIdx.x + i * kThreads, r = e >> 5, x = (e & 31) * 8;
      const long long q = p0 + (long long)s * kWgBK + r;
      const int col = n0 + x;
      tc::stage8(stage + kWgBK * kWgAld + r * kWgBld + x, bsrc + q * N + col,
                 q < pend ? N - col : 0);
    }
  };
  // dropout on the staged taps (the conv input as the forward saw it)
  auto prep = [&](int s, bf16* stage) -> bool {
    if (which != 0 || !a.has_drop) return false;
    for (int e = threadIdx.x; e < kWgBK * kWgRows; e += kThreads) {
      const int r = e >> 6, x = e & 63, ch = m0 + x;
      const long long q = p0 + (long long)s * kWgBK + r;
      if (q >= pend || ch >= M) continue;
      const int j = ch / R, rr = ch - j * R;
      const int bq = (int)(q / a.T), t = (int)(q - (long long)bq * a.T) - (a.k - 1 - j) * a.d;
      if (t < 0) continue;
      bf16* p = stage + r * kWgAld + x;
      *p = keep_bit(a, bq, t, rr) ? __float2bfloat16(__bfloat162float(*p) * a.inv_keep)
                                  : __float2bfloat16(0.0f);
    }
    return true;
  };
  const tc::Frag fr;
  float acc[2][8][4];
  tc::ring_product<8, kWgBK, kWgStages, true, true>(
      acc, nullptr, kWgAld, (int)((pend - p0 + kWgBK - 1) / kWgBK), ring, kWgStage,
      kWgBK * kWgAld, kWgBld, load, prep, [&](int j) { return 64 * fr.wn + 8 * j; });

  float* out = which == 0 ? a.dw_in + (long long)a.l * kR * G
             : which == 1 ? a.dw_cond + (long long)a.l * cin * G
                          : a.dw_og + (long long)a.l * G2 * RS;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int row = m0 + fr.row(mi, v), col = n0 + 64 * fr.wn + 8 * j + 2 * fr.t + (v & 1);
        if (row < M && col < N) atomicAdd(&out[(long long)row * N + col], acc[mi][j][v]);
      }
}

// bwd_dx_tc: the k shifted copies of round(dz) for the tile's positions
// ([rows][x_ld]: tap j at columns [j G, j G + G), zero past T) stay resident;
// w_in and w_cond stream as stored ([r][g] rows, the contraction axis
// contiguous), 128 output columns a pass.
constexpr int kDxBK = 16;                // depth of a weight slice
constexpr int kDxStage = tc::kWtCols * (kDxBK + 8);
struct DxLayout {
  int kG, Kx, x_ld;  // depth of the dx product; staged columns (zero past kG)
  __host__ __device__ explicit DxLayout(const TrainArgs& a) : kG(a.k * a.G) {
    const int dx = tc::round_up(kG, kDxBK), dc = kG - a.G + tc::round_up(a.G, kDxBK);
    Kx = dx > dc ? dx : dc;
    x_ld = tc::pad_ld(Kx);
  }
  __host__ __device__ size_t smem_elems(int rows) const {
    return (size_t)rows * x_ld + (size_t)kStages * kDxStage;
  }
};

// kDxRows positions a block (128, or 64 where 128 rows do not fit)
template <int kDxRows>
__global__ void __launch_bounds__(tc::Tile<kDxRows>::kThreads, 1) bwd_dx_tc(TrainArgs a) {
  using DxTile = tc::Tile<kDxRows>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const DxLayout L(a);
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = Xs + kDxRows * L.x_ld;
  const int b = blockIdx.y, t0 = blockIdx.x * kDxRows;
  const int G = a.G, R = a.R, k = a.k, kR = k * R, cin = a.cin;
  const long long row0 = (long long)b * a.T + t0;
  const bf16* dz = static_cast<const bf16*>(a.dz);
  const int np = L.Kx / 8;
  for (int e = threadIdx.x; e < kDxRows * np; e += DxTile::kThreads) {
    const int m = e / np, col = 8 * (e - m * np), j = col / G, g = col - j * G;
    const int t = t0 + m + (k - 1 - j) * a.d;
    const bool in = col < L.kG && t0 + m < a.T && t < a.T;
    tc::stage8(Xs + m * L.x_ld + col, dz + ((long long)b * a.T + (in ? t : 0)) * G + g,
               in ? 8 : 0);
  }
  tc::cp_async_commit();
  const tc::Frag fr;

  // dxin = sum_j round(dz)[t + (k-1-j) d] @ w_in_j^T
  const bf16* w_in = static_cast<const bf16*>(a.w_in) + (long long)a.l * kR * G;
  for (int n0 = 0; n0 < R; n0 += tc::kWtCols) {
    float acc[2][4][4];
    auto load = [&](int s, bf16* stage) {
      tc::stage_wt<kDxBK, DxTile::kThreads>(stage, s, n0, L.kG, [&](int r, int kk) {
        const int j = kk / G;
        return r < R ? w_in + (long long)(j * R + r) * G + (kk - j * G) : nullptr;
      });
    };
    tc::ring_product<4, kDxBK, kStages, false, false>(
        acc, Xs, L.x_ld, tc::round_up(L.kG, kDxBK) / kDxBK, ring, kDxStage, 0, kDxBK + 8, load,
        tc::NoPrep(), [&](int j) { return 32 * fr.wn + 8 * j; });
    // dx_next of every output first, then the sums and stores; a thread's
    // two neighbouring columns go as one 8-byte access
    float2 prev[2][4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = fr.row(mi, 2 * h), col = n0 + 32 * fr.wn + 8 * j + 2 * fr.t;
          float2 p = make_float2(0.0f, 0.0f);
          if (a.dx_next && col < R && t0 + m < a.T)
            p = *reinterpret_cast<const float2*>(a.dx_next + (row0 + m) * R + col);
          prev[mi][j][h] = make_float2(p.x * kSqrtHalf, p.y * kSqrtHalf);
        }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = fr.row(mi, 2 * h), t = t0 + m, col = n0 + 32 * fr.wn + 8 * j + 2 * fr.t;
          if (col >= R || t >= a.T) continue;
          float x0 = acc[mi][j][2 * h], x1 = acc[mi][j][2 * h + 1];
          if (a.has_drop) {
            x0 *= keep_bit(a, b, t, col) ? a.inv_keep : 0.0f;
            x1 *= keep_bit(a, b, t, col + 1) ? a.inv_keep : 0.0f;
          }
          *reinterpret_cast<float2*>(a.dx_out + (row0 + m) * R + col) =
              make_float2(prev[mi][j][h].x + x0, prev[mi][j][h].y + x1);
        }
  }
  if (!a.dc) return;
  // dc += round(dz) @ w_cond^T: the unshifted tap (j = k-1) is round(dz)
  const bf16* w_cond = static_cast<const bf16*>(a.w_cond) + (long long)a.l * cin * G;
  for (int n0 = 0; n0 < cin; n0 += tc::kWtCols) {
    float acc[2][4][4];
    auto load = [&](int s, bf16* stage) {
      tc::stage_wt<kDxBK, DxTile::kThreads>(stage, s, n0, G, [&](int col, int kk) {
        return col < cin ? w_cond + (long long)col * G + kk : nullptr;
      });
    };
    tc::ring_product<4, kDxBK, kStages, false, false>(
        acc, Xs + (k - 1) * G, L.x_ld, tc::round_up(G, kDxBK) / kDxBK, ring, kDxStage, 0,
        kDxBK + 8, load, tc::NoPrep(), [&](int j) { return 32 * fr.wn + 8 * j; });
    // dc of every output first, then the sums and stores (a thread's two
    // neighbouring columns as one 8-byte access where cin is even)
    const bool pairs = !(cin & 1);
    float2 prev[2][4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = fr.row(mi, 2 * h), col = n0 + 32 * fr.wn + 8 * j + 2 * fr.t;
          const float* p = a.dc + (row0 + m) * cin + col;
          float2 v = make_float2(0.0f, 0.0f);
          if (t0 + m < a.T && col < cin)
            v = pairs ? *reinterpret_cast<const float2*>(p)
                      : make_float2(p[0], col + 1 < cin ? p[1] : 0.0f);
          prev[mi][j][h] = v;
        }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = fr.row(mi, 2 * h), col = n0 + 32 * fr.wn + 8 * j + 2 * fr.t;
          if (t0 + m >= a.T || col >= cin) continue;
          float* p = a.dc + (row0 + m) * cin + col;
          const float2 v = make_float2(prev[mi][j][h].x + acc[mi][j][2 * h],
                                       prev[mi][j][h].y + acc[mi][j][2 * h + 1]);
          if (pairs) {
            *reinterpret_cast<float2*>(p) = v;
          } else {
            p[0] = v.x;
            if (col + 1 < cin) p[1] = v.y;
          }
        }
  }
}

template <typename K>
cudaError_t launch_tc(K kernel, dim3 grid, int threads, size_t elems, const TrainArgs& a,
                      cudaStream_t s) {
  const size_t smem = sizeof(bf16) * elems;
  if (smem > tc::kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(a);
  return cudaGetLastError();
}

// A position-tile kernel at 128 rows a block, or at 64 where 128 rows do not
// fit in shared memory.
template <template <int> class Kernel, typename Layout>
cudaError_t launch_tile(const TrainArgs& a, cudaStream_t s) {
  const Layout L(a);
  if (sizeof(bf16) * L.smem_elems(128) <= tc::kSmemLimit)
    return launch_tc(Kernel<128>::fn(), dim3((a.T + 127) / 128, a.B), tc::Tile<128>::kThreads,
                     L.smem_elems(128), a, s);
  return launch_tc(Kernel<64>::fn(), dim3((a.T + 63) / 64, a.B), tc::Tile<64>::kThreads,
                   L.smem_elems(64), a, s);
}
template <int R> struct DzKernel { static auto fn() { return bwd_dz_tc<R>; } };
template <int R> struct DxKernel { static auto fn() { return bwd_dx_tc<R>; } };

// ================================================== f32: FMA tile launches
cudaError_t launch_dz(const TrainArgs& a, cudaStream_t s) {
  const size_t smem = tile_kernel_smem(a.G);
  cudaError_t err = allow_smem(bwd_dz, smem);
  if (err != cudaSuccess) return err;
  bwd_dz<<<dim3((a.T + BM - 1) / BM, a.B), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_wgrad(const TrainArgs& a, cudaStream_t s) {
  const int nG = (a.G + BN - 1) / BN, nRS = (a.R + a.S + BN - 1) / BN;
  const int cin = a.c ? a.cin : 0;
  const int tiles = (a.k * a.R + BM - 1) / BM * nG + (cin + BM - 1) / BM * nG
                    + (a.G / 2 + BM - 1) / BM * nRS;
  const long long P = (long long)a.B * a.T;
  const int chunks = (int)((P + a.chunk - 1) / a.chunk);
  const size_t smem = sizeof(float) * kTileSmemFloats;
  bwd_wgrad<<<dim3(tiles, chunks), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_dx(const TrainArgs& a, cudaStream_t s) {
  const size_t smem = sizeof(float) * kTileSmemFloats;
  bwd_dx<<<dim3((a.T + BM - 1) / BM, a.B), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The three kernels of layer a->l's backward, in the order they must run:
// the tensor-core kernels for bf16 storage, the FMA kernels for f32. Each
// returns a CUDA error code, 0 on a clean launch.
extern "C" int wn_train_bwd_dz(const TrainArgs* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!a->bf16) return (int)launch_dz(*a, s);
  return (int)launch_tile<DzKernel, DzLayout>(*a, s);
}

extern "C" int wn_train_bwd_wgrad(const TrainArgs* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!a->bf16) return (int)launch_wgrad(*a, s);
  const WgradTiles tl(*a);
  const long long P = (long long)a->B * a->T;
  const dim3 grid(tl.t_in + tl.t_cond + tl.t_og, (unsigned)((P + a->chunk - 1) / a->chunk));
  return (int)launch_tc(bwd_wgrad_tc, grid, kThreads, (size_t)kWgStages * kWgStage, *a, s);
}

extern "C" int wn_train_bwd_dx(const TrainArgs* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!a->bf16) return (int)launch_dx(*a, s);
  return (int)launch_tile<DxKernel, DxLayout>(*a, s);
}
