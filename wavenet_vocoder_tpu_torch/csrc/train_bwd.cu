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
// What this design does about it (simple first version):
//   * The TPU kernel owns a right-extended time window per tile and masks
//     the weight gradients to its home positions; that relies on its
//     in-order grid and VMEM accumulators. Here each layer is split at the
//     points where a block needs another block's results:
//       1. bwd_dz (blocks over 64-position tiles): recompute z from the x_l
//          stash, dy = [dx_{l+1} * sqrt(1/2) | dskips], dgated = round(dy) @
//          w_og^T, dz; writes round(dz) and round(gated) for the next two
//          launches, and adds the tile's sums of dz (db_in, dgb) and of
//          round(dy) (db_og) with f32 atomics.
//       2. bwd_wgrad: the weight gradients round(taps)^T round(dz),
//          round(c)^T round(dz) and round(gated)^T round(dy), each a product
//          over all B*T positions, split over position chunks; every block
//          sums its chunk in registers and adds its 64 x 128 tile to the f32
//          result with atomics (so the order of the sum changes from run to
//          run).
//       3. bwd_dx (blocks over 64-position tiles): the transposed dilated
//          conv dx_l[t] = dx_{l+1}[t] * sqrt(1/2) + mask * sum_j round(dz)[t
//          + (k-1-j) d] @ w_in_j^T, which reads dz of later positions owned
//          by other blocks (hence the launch boundary), and dc += round(dz)
//          @ w_cond^T.
//   * The rounding points are the TPU kernel's: dgated from round(dy), the
//     weight gradients and dx from round(dz), the bias gradients from f32 dz
//     (db_og from round(dy)).
//   * Products are the shared-memory FP32 tiles of train_common.cuh, with
//     the weights pre-transposed by the wrapper where the product reads
//     them transposed. Tensor cores are the next step.
#include "train_common.cuh"

namespace {

using namespace wn;

__device__ __forceinline__ float dy_value(const TrainArgs& a, long long pos, int col) {
  if (col < a.R) return a.dx_next ? a.dx_next[pos * a.R + col] * kSqrtHalf : 0.0f;
  return a.dskips[pos * a.S + (col - a.R)];
}

template <typename W>
__global__ void __launch_bounds__(kThreads) bwd_dz(TrainArgs a) {
  extern __shared__ float smem[];
  float* zs = smem;                          // BM x G: z, then (tanh a | sigmoid b), then dz
  float* tile = smem + BM * a.G;
  const int b = blockIdx.y, t0 = blockIdx.x * BM;
  const int G = a.G, G2 = G / 2, R = a.R, RS = R + a.S;
  const int rows = min(BM, a.T - t0);

  compute_z<W>(a, b, t0, zs, tile);

  for (int e = threadIdx.x; e < BM * G2; e += kThreads) {
    const int m = e / G2, g = e - m * G2;
    const float ta = tanhf(zs[m * G + g]), sb = sigmoidf_(zs[m * G + G2 + g]);
    zs[m * G + g] = ta;
    zs[m * G + G2 + g] = sb;
    if (m < rows)
      static_cast<W*>(a.gated)[((long long)b * a.T + t0 + m) * G2 + g] = from_f<W>(ta * sb);
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
          return rnd<W>(dy_value(a, (long long)b * a.T + t0 + m, kk));
        },
        [&](int kk, int n) -> float {
          const int col = n0 + n;
          return col < G2 ? ld<W>(a.w_og_t, wofs + (long long)kk * G2 + col) : 0.0f;
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
      static_cast<W*>(a.dz)[((long long)b * a.T + t0 + m) * G + col] = from_f<W>(v);
    }
    atomicAdd(&a.db_in[a.l * G + col], sum);
    if (a.dgb) atomicAdd(&a.dgb[((long long)a.l * a.B + b) * G + col], sum);
  }
  // column sums of round(dy) -> db_og
  for (int col = threadIdx.x; col < RS; col += kThreads) {
    float sum = 0.0f;
    for (int m = 0; m < rows; ++m) sum += rnd<W>(dy_value(a, (long long)b * a.T + t0 + m, col));
    atomicAdd(&a.db_og[a.l * RS + col], sum);
  }
}

// Weight gradients of layer l. blockIdx.x enumerates the output tiles of the
// three products (dW_in: k*R x G, dW_cond: cin x G, dW_og: G/2 x (R+S), each
// cut into BM x BN tiles); blockIdx.y the chunk of positions [y*chunk,
// (y+1)*chunk) of the flattened (b, t) axis.
template <typename W>
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
          return conv_input<W>(a, b, t - (a.k - 1 - j) * a.d, r);
        }
        if (which == 1) return ld<W>(a.c, pos * a.cin + row);
        return ld<W>(a.gated, pos * G2 + row);
      },
      [&](int kk, int n) -> float {
        const int col = n0 + n;
        if (col >= N) return 0.0f;
        const long long pos = p0 + kk;
        if (which == 2) return rnd<W>(dy_value(a, pos, col));
        return ld<W>(a.dz, pos * G + col);
      });
  float* out = which == 0 ? a.dw_in + (long long)a.l * kR * G
             : which == 1 ? a.dw_cond + (long long)a.l * a.cin * G
                          : a.dw_og + (long long)a.l * G2 * RS;
  tile_store(acc, [&](int m, int n, float v) {
    const int row = m0 + m, col = n0 + n;
    if (row < M && col < N) atomicAdd(&out[(long long)row * N + col], v);
  });
}

template <typename W>
__global__ void __launch_bounds__(kThreads) bwd_dx(TrainArgs a) {
  extern __shared__ float smem[];
  const int b = blockIdx.y, t0 = blockIdx.x * BM;
  const int G = a.G, R = a.R, k = a.k;
  const long long row0 = (long long)b * a.T + t0;

  // dxin = sum_j round(dz)[t + (k-1-j) d] @ w_in_j^T, over K = k*G
  const long long wofs = (long long)a.l * k * G * R;
  for (int n0 = 0; n0 < R; n0 += BN) {
    float acc[TM][TN];
    tile_product<true>(
        acc, k * G, smem,
        [&](int m, int kk) -> float {
          const int j = kk / G, g = kk - j * G;
          const int t = t0 + m + (k - 1 - j) * a.d;
          if (t0 + m >= a.T || t >= a.T) return 0.0f;
          return ld<W>(a.dz, ((long long)b * a.T + t) * G + g);
        },
        [&](int kk, int n) -> float {
          const int col = n0 + n;
          return col < R ? ld<W>(a.w_in_t, wofs + (long long)kk * R + col) : 0.0f;
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
  const long long cofs = (long long)a.l * G * a.cin;
  for (int n0 = 0; n0 < a.cin; n0 += BN) {
    float acc[TM][TN];
    tile_product<true>(
        acc, G, smem,
        [&](int m, int kk) -> float {
          return t0 + m < a.T ? ld<W>(a.dz, (row0 + m) * G + kk) : 0.0f;
        },
        [&](int kk, int n) -> float {
          const int col = n0 + n;
          return col < a.cin ? ld<W>(a.w_cond_t, cofs + (long long)kk * a.cin + col) : 0.0f;
        });
    tile_store(acc, [&](int m, int n, float v) {
      const int col = n0 + n;
      if (col < a.cin && t0 + m < a.T) a.dc[(row0 + m) * a.cin + col] += v;
    });
  }
}

template <typename W>
cudaError_t launch_dz(const TrainArgs& a, cudaStream_t s) {
  const size_t smem = tile_kernel_smem(a.G);
  cudaError_t err = allow_smem(bwd_dz<W>, smem);
  if (err != cudaSuccess) return err;
  bwd_dz<W><<<dim3((a.T + BM - 1) / BM, a.B), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename W>
cudaError_t launch_wgrad(const TrainArgs& a, cudaStream_t s) {
  const int nG = (a.G + BN - 1) / BN, nRS = (a.R + a.S + BN - 1) / BN;
  const int cin = a.c ? a.cin : 0;
  const int tiles = (a.k * a.R + BM - 1) / BM * nG + (cin + BM - 1) / BM * nG
                    + (a.G / 2 + BM - 1) / BM * nRS;
  const long long P = (long long)a.B * a.T;
  const int chunks = (int)((P + a.chunk - 1) / a.chunk);
  const size_t smem = sizeof(float) * kTileSmemFloats;
  bwd_wgrad<W><<<dim3(tiles, chunks), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename W>
cudaError_t launch_dx(const TrainArgs& a, cudaStream_t s) {
  const size_t smem = sizeof(float) * kTileSmemFloats;
  bwd_dx<W><<<dim3((a.T + BM - 1) / BM, a.B), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The three kernels of layer a->l's backward, in the order they must run.
// Each returns a CUDA error code, 0 on a clean launch.
extern "C" int wn_train_bwd_dz(const TrainArgs* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a->bf16 ? (int)launch_dz<__nv_bfloat16>(*a, s) : (int)launch_dz<float>(*a, s);
}

extern "C" int wn_train_bwd_wgrad(const TrainArgs* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a->bf16 ? (int)launch_wgrad<__nv_bfloat16>(*a, s) : (int)launch_wgrad<float>(*a, s);
}

extern "C" int wn_train_bwd_dx(const TrainArgs* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a->bf16 ? (int)launch_dx<__nv_bfloat16>(*a, s) : (int)launch_dx<float>(*a, s);
}
