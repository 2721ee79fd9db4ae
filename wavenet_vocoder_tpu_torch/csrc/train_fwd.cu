// Forward of the WaveNet residual stack for training, one layer per launch,
// for Hopper (sm_90a).
//
// Replaces: wavenet_vocoder_tpu/ops/pallas_train.py::_make_fwd_kernel (through
// _fwd_call's pl.pallas_call), with its xs_hbm stash of every layer's input.
// Per layer l and position t: the k dilated taps of x_l (dropout on the conv
// input, counter-hash mask), [taps | c] @ [w_in; w_cond] + b_in (+ gb), GLU,
// gated @ w_og + b_og -> x_{l+1} = (out + x_l) * sqrt(1/2) carried in f32,
// skips += skip in f32. Writes x_{l+1} rounded to the storage type as the
// stash the backward reads.
//
// What bounds it on an H100: the flagship stack (24 layers, 128/256/128,
// cin 80) does 3,637,248 MACs per position against ~1.5 KB of activations
// per position and layer, so it is bound by arithmetic: at B=8, T=10240,
// 596 GFLOP, 0.60 ms at the bf16 tensor-core rate, against ~0.18 ms of
// HBM traffic.
//
// What this design does about it:
//   * The TPU kernel walks the whole stack per time tile and carries the
//     last (k-1)*max_dilation columns of every layer from one tile to the
//     next; that needs the TPU's in-order grid. GPU blocks run in any order,
//     so this kernel is layer-major: one launch per layer, blocks over
//     (position tile, batch row), each reading its taps' history straight
//     from the previous layer's stash in global memory (zero for t < 0). No
//     halo is recomputed and no tile order is assumed.
//   * The residual chain stays f32 between launches (two ping-pong f32
//     carriers); only the conv input is rounded to the storage type, as in
//     the TPU kernel.
//   * Dispatch by storage dtype. bf16 storage (the training path) runs
//     fwd_tc: tensor-core products (train_mma.cuh, mma.sync m16n8k16 bf16 in,
//     f32 sums), 128 positions a block (16 warps; 64 where 128 rows of the
//     operands do not fit in shared memory), so that each weight slice read
//     from L2 serves 128 positions. The tile's [taps | c] operand is staged
//     once in shared memory by cp.async (dropout applied as one pass over the
//     staged taps), the weights stream through a 3-stage ring in slices of
//     16 rows; z comes out as matching a- and b-halves, so the GLU runs in
//     registers (one __expf and a fast divide each for tanh and sigmoid) and
//     round(gated) is stored once to shared memory as the A operand of the
//     out|skip product. Its epilogue writes x_{l+1}, its stash and the skips
//     with the reads batched ahead of the writes and column pairs as 8-byte
//     accesses. f32 storage runs fwd_layer, the shared-memory FP32 FMA tiles
//     of train_common.cuh (TF32 would break the f32 path's 1e-4 limits); a
//     bf16 launch never takes it.
//   * bf16 widths: R a multiple of 8, G of 16 and S even (the wrapper
//     checks); cin is free (c rows whose stride is not 16-byte aligned are
//     staged element by element).
#include "train_common.cuh"
#include "train_mma.cuh"

namespace {

using namespace wn;

__global__ void __launch_bounds__(kThreads) fwd_layer(TrainArgs a) {
  extern __shared__ float smem[];
  float* zs = smem;                          // BM x G
  float* tile = smem + BM * a.G;
  const int b = blockIdx.y, t0 = blockIdx.x * BM;
  const int G = a.G, G2 = G / 2, R = a.R, S = a.S, RS = R + S;

  compute_z(a, b, t0, zs, tile);

  // GLU in place: zs[m][g] <- round(tanh(a) * sigmoid(b)) for g < G/2
  for (int e = threadIdx.x; e < BM * G2; e += kThreads) {
    const int m = e / G2, g = e - m * G2;
    zs[m * G + g] = (tanhf(zs[m * G + g]) * sigmoidf_(zs[m * G + G2 + g]));
  }
  __syncthreads();

  const long long wofs = (long long)a.l * G2 * RS;
  for (int n0 = 0; n0 < RS; n0 += BN) {
    float acc[TM][TN];
    tile_product<true>(
        acc, G2, tile, [&](int m, int kk) -> float { return zs[m * G + kk]; },
        [&](int kk, int n) -> float {
          const int col = n0 + n;
          return col < RS ? ldf(a.w_og, wofs + (long long)kk * RS + col) : 0.0f;
        });
    tile_store(acc, [&](int m, int n, float v) {
      const int col = n0 + n, t = t0 + m;
      if (col >= RS || t >= a.T) return;
      v += a.b_og[a.l * RS + col];
      const long long pos = (long long)b * a.T + t;
      if (col < R) {
        if (!a.xnext) return;  // the last layer's residual output is unused
        const float x = a.xres ? a.xres[pos * R + col] : ldf(a.xs_l, pos * R + col);
        const float xn = (v + x) * kSqrtHalf;
        a.xnext[pos * R + col] = xn;
        static_cast<float*>(a.xs_next)[pos * R + col] = (xn);
      } else {
        a.skips[pos * S + (col - R)] += v;
      }
    });
  }
}

// ------------------------------------------------- bf16: tensor-core layer
constexpr int kBK = 16;                  // weight rows a ring stage
constexpr int kStages = 3;

struct FwdLayout {
  tc::ZLayout z;
  int Gp, g_ld;
  __host__ __device__ explicit FwdLayout(const TrainArgs& a) : z(a, kBK) {
    Gp = tc::round_up(a.G / 2, kBK);
    g_ld = tc::pad_ld(Gp);
  }
  __host__ __device__ size_t smem_elems(int rows) const {
    return (size_t)rows * (z.a_ld + g_ld) + (size_t)kStages * kBK * tc::kZld;
  }
};

// kRows positions a block (128, or 64 where 128 rows do not fit)
template <int kRows>
__global__ void __launch_bounds__(tc::Tile<kRows>::kThreads, 1) fwd_tc(TrainArgs a) {
  using FwdTile = tc::Tile<kRows>;
  using tc::bf16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const FwdLayout L(a);
  bf16* As = reinterpret_cast<bf16*>(smem_raw);       // [rows][a_ld]: taps | c
  bf16* Gs = As + kRows * L.z.a_ld;                   // [rows][g_ld]: round(gated)
  bf16* ring = Gs + kRows * L.g_ld;
  const int b = blockIdx.y, t0 = blockIdx.x * kRows;
  const int G2 = a.G / 2, R = a.R, S = a.S, RS = R + S;
  const tc::Frag fr;

  tc::issue_z_operand<kRows>(a, L.z, b, t0, As);
  tc::finish_z_operand<kRows>(a, L.z, b, t0, As);
  for (int c0 = 0; c0 < G2; c0 += tc::kZCols) {
    float acc[2][8][4];
    tc::z_product<kRows, kBK, kStages>(acc, a, L.z, As, ring, c0);
    tc::add_z_bias(acc, a, b, c0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = c0 + 32 * fr.wn + 8 * j + 2 * fr.t;
      if (gc >= L.Gp) continue;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float g0 = 0.0f, g1 = 0.0f;
          if (gc < G2) {
            g0 = tc::tanh_fast(acc[mi][j][2 * h]) * tc::sigmoid_fast(acc[mi][j + 4][2 * h]);
            g1 = tc::tanh_fast(acc[mi][j][2 * h + 1]) * tc::sigmoid_fast(acc[mi][j + 4][2 * h + 1]);
          }
          tc::store2(Gs + fr.row(mi, 2 * h) * L.g_ld + gc, g0, g1);
        }
    }
  }
  __syncthreads();

  // [out | skip] = round(gated) @ w_og, 256 columns a pass
  const bf16* w_og = static_cast<const bf16*>(a.w_og) + (long long)a.l * G2 * RS;
  for (int n0 = 0; n0 < RS; n0 += 256) {
    float acc[2][8][4];
    auto load = [&](int s, bf16* stage) {
      for (int e = threadIdx.x; e < kBK * 32; e += FwdTile::kThreads) {
        const int r = e >> 5, x = (e & 31) * 8, g = s * kBK + r;
        tc::stage8(stage + r * tc::kZld + x, w_og + (long long)g * RS + n0 + x,
                   g < G2 ? RS - (n0 + x) : 0);
      }
    };
    tc::ring_product<8, kBK, kStages, false, true>(
        acc, Gs, L.g_ld, L.Gp / kBK, ring, kBK * tc::kZld, 0, tc::kZld, load, tc::NoPrep(),
        [&](int j) { return 64 * fr.wn + 8 * j; });
    // epilogue, four column tiles at a time: first every global value the
    // outputs add to (x_l, or the skips so far), then the sums and stores, so
    // that a thread's loads are in flight together; a thread's two
    // neighbouring columns go as one 8-byte (4-byte bf16) access
    const float* bo = a.b_og + (long long)a.l * RS;
#pragma unroll
    for (int jb = 0; jb < 8; jb += 4) {
      float2 prev[4][2][2];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int t = t0 + fr.row(mi, 2 * h);
            const int col = n0 + 64 * fr.wn + 8 * (jb + jj) + 2 * fr.t;
            const long long pos = (long long)b * a.T + t;
            float2 p = make_float2(0.0f, 0.0f);
            if (t < a.T && col < RS) {
              if (col >= R)
                p = *reinterpret_cast<const float2*>(a.skips + pos * S + (col - R));
              else if (a.xres)
                p = *reinterpret_cast<const float2*>(a.xres + pos * R + col);
              else if (a.xnext)
                p = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(static_cast<const bf16*>(a.xs_l) + pos * R + col));
            }
            prev[jj][mi][h] = p;
          }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int t = t0 + fr.row(mi, 2 * h);
            const int col = n0 + 64 * fr.wn + 8 * (jb + jj) + 2 * fr.t;
            if (t >= a.T || col >= RS) continue;
            const float y0 = acc[mi][jb + jj][2 * h] + bo[col];
            const float y1 = acc[mi][jb + jj][2 * h + 1] + bo[col + 1];
            const float2 p = prev[jj][mi][h];
            const long long pos = (long long)b * a.T + t;
            if (col >= R) {
              *reinterpret_cast<float2*>(a.skips + pos * S + (col - R)) =
                  make_float2(p.x + y0, p.y + y1);
            } else if (a.xnext) {  // the last layer's residual output is unused
              const float2 xn = make_float2((y0 + p.x) * kSqrtHalf, (y1 + p.y) * kSqrtHalf);
              *reinterpret_cast<float2*>(a.xnext + pos * R + col) = xn;
              tc::store2(static_cast<bf16*>(a.xs_next) + pos * R + col, xn.x, xn.y);
            }
          }
    }
  }
}

template <int kRows>
cudaError_t launch_rows(const TrainArgs& a, size_t smem, cudaStream_t s) {
  cudaError_t err = allow_smem(fwd_tc<kRows>, smem);
  if (err != cudaSuccess) return err;
  fwd_tc<kRows><<<dim3((a.T + kRows - 1) / kRows, a.B), tc::Tile<kRows>::kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_tc(const TrainArgs& a, cudaStream_t s) {
  const FwdLayout L(a);
  const size_t big = sizeof(tc::bf16) * L.smem_elems(128), small = sizeof(tc::bf16) * L.smem_elems(64);
  if (big <= tc::kSmemLimit) return launch_rows<128>(a, big, s);
  if (small <= tc::kSmemLimit) return launch_rows<64>(a, small, s);
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------ f32: FMA tiles
cudaError_t launch_fma(const TrainArgs& a, cudaStream_t s) {
  const size_t smem = tile_kernel_smem(a.G);
  cudaError_t err = allow_smem(fwd_layer, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.T + BM - 1) / BM, a.B);
  fwd_layer<<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// One layer of the forward (layer a->l): the tensor-core kernel for bf16
// storage, the FMA kernel for f32. Returns a CUDA error code, 0 on a clean
// launch.
extern "C" int wn_train_fwd_layer(const TrainArgs* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a->bf16 ? (int)launch_tc(*a, s) : (int)launch_fma(*a, s);
}
