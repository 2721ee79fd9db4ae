// Shared pieces of the residual-stack training kernels (train_fwd.cu,
// train_bwd.cu): the argument block both sides fill, storage-type helpers,
// the counter-hash dropout mask, and the shared-memory tiled FP32 product of
// the f32 storage path (the bf16 path's tensor-core pieces are in
// train_mma.cuh).
//
// Layouts are channels-last and row-major: activations (B, T, C), stacked
// weights (L, In, Out). "storage" is the compute dtype of the stack (float
// or bf16): taps, conditioning, weights and the x_l stash are stored in it;
// every product reads storage values widened to f32 and accumulates in f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Filled by ops/cuda_train.py (a ctypes.Structure with the same fields in
// the same order). Pointers are null where a tensor is absent.
struct TrainArgs {
  const void* xs_l;       // (B, T, R) storage: layer l's input (conv taps)
  const float* xres;      // (B, T, R) f32 residual carrier of layer l; null: read xs_l
  float* xnext;           // fwd: (B, T, R) f32 carrier of layer l+1, or null
  void* xs_next;          // fwd: (B, T, R) storage stash of layer l+1, or null
  const void* c;          // (B, T, cin) storage, or null
  const float* gb;        // (L, B, G) global-conditioning bias, or null
  const void* w_in;       // (L, k*R, G) storage; row j*R + r = tap j, channel r
  const float* b_in;      // (L, G)
  const void* w_cond;     // (L, cin, G) storage, or null
  const void* w_og;       // (L, G/2, R+S) storage: [out | skip]
  const float* b_og;      // (L, R+S)
  float* skips;           // fwd: (B, T, S) f32, accumulated over layers
  const float* dskips;    // bwd: (B, T, S) f32
  const float* dx_next;   // bwd: (B, T, R) f32 gradient of x_{l+1}; null at the top
  float* dx_out;          // bwd: (B, T, R) f32 gradient of x_l
  void* dz;               // bwd: (B, T, G) storage, rounded dz of layer l
  void* gated;            // bwd: (B, T, G/2) storage, recomputed gate output
  void* dyr;              // bwd, bf16 path: (B, T, R+S) storage, round(dy) of layer l
  float* dc;              // bwd: (B, T, cin) f32, accumulated over layers, or null
  float* dgb;             // bwd: (L, B, G) f32, or null
  float* dw_in;           // bwd: (L, k*R, G) f32 (atomic sums)
  float* db_in;           // bwd: (L, G)
  float* dw_cond;         // bwd: (L, cin, G), or null
  float* dw_og;           // bwd: (L, G/2, R+S)
  float* db_og;           // bwd: (L, R+S)
  int B, T, R, G, S, cin, k, d, L, l, H;
  int has_drop;
  unsigned int seed;      // dropout seed (int32 bits)
  unsigned int thresh;    // keep iff (hash >> 8) < thresh
  float inv_keep;         // f32(1 / keep)
  int bf16;               // storage is bf16 (else f32)
  int chunk;              // bwd weight gradients: positions per block
  int key_R;              // R of the dropout key: the model's residual width, which
                          // the wrapper's zero padding of R leaves out
};

namespace wn {

constexpr int kThreads = 256;
// Tile of the FP32 product: BM x BN outputs per block, BK deep per stage;
// each of the 256 threads owns TM rows x TN columns (columns strided by 16).
constexpr int BM = 64, BN = 128, BK = 16, TM = 4, TN = 8;
constexpr int AS_STRIDE = BM + 1;      // padded: column-wise stores hit distinct banks
constexpr int kTileSmemFloats = BK * AS_STRIDE + BK * BN;
constexpr float kSqrtHalf = 0.70710678118654752440f;

__device__ __forceinline__ float ldf(const void* p, long long i) {
  return static_cast<const float*>(p)[i];
}

// _mix_bits of the JAX kernel (pallas_train.py): int32 wrapping multiplies
// and logical shifts, which are exactly uint32 arithmetic.
__device__ __forceinline__ uint32_t mix_bits(uint32_t x) {
  x ^= x >> 16;
  x *= 0x45d9f3bU;
  x ^= x >> 15;
  x *= 0x119de1f3U;
  x ^= x >> 16;
  return x;
}

// dropout_mask of the JAX kernel at one element: row key mix(b ^ seed), then
// mix(key ^ ((t_key*L + l)*R + r)), kept iff its top 24 bits < thresh, with
// the model's R (key_R). The time key is the absolute time plus H (the JAX
// kernels' window offset).
__device__ __forceinline__ bool keep_bit(const TrainArgs& a, int b, int t, int r) {
  const uint32_t bkey = mix_bits((uint32_t)b ^ a.seed);
  const uint32_t idx =
      ((uint32_t)(t + a.H) * (uint32_t)a.L + (uint32_t)a.l) * (uint32_t)a.key_R + (uint32_t)r;
  return (mix_bits(bkey ^ idx) >> 8) < a.thresh;
}

// The conv input of layer l at (b, t, r) on the f32 path: the stashed x_l,
// dropped and rescaled. Zero for t < 0 (causal padding).
__device__ __forceinline__ float conv_input(const TrainArgs& a, int b, int t, int r) {
  if (t < 0) return 0.0f;
  const float v = ldf(a.xs_l, ((long long)b * a.T + t) * a.R + r);
  return a.has_drop ? (keep_bit(a, b, t, r) ? v * a.inv_keep : 0.0f) : v;
}

// acc[TM][TN] = sum_kk A(m, kk) * B(kk, n) for the block's BM x BN tile,
// with m = ty*TM + i and n = tx + 16*j (tx = tid % 16, ty = tid / 16).
// aload/bload return the (f32-widened) operand or 0 outside the matrix; they
// are called once per element per stage and the stage is staged in shared
// memory. A_KFAST picks the load order of A: true when A's contiguous axis
// is kk (activations, position-major rows), false when it is m (weight
// gradients, where kk runs over positions). Ends with a barrier, so the
// caller may reuse `smem` right after.
template <bool A_KFAST, typename ALoad, typename BLoad>
__device__ __forceinline__ void tile_product(float (&acc)[TM][TN], int K, float* smem,
                                             ALoad aload, BLoad bload) {
  float* As = smem;
  float* Bs = smem + BK * AS_STRIDE;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int q = 0; q < BK * BM / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int kk = A_KFAST ? e % BK : e / BM;
      const int m = A_KFAST ? e / BK : e % BM;
      As[kk * AS_STRIDE + m] = (k0 + kk < K) ? aload(m, k0 + kk) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < BK * BN / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int n = e % BN, kk = e / BN;
      Bs[kk * BN + n] = (k0 + kk < K) ? bload(k0 + kk, n) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk * AS_STRIDE + ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk * BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Calls epi(m, j_col, value) for every output the thread owns, where j_col
// is the column inside the BN tile.
template <typename Epi>
__device__ __forceinline__ void tile_store(const float (&acc)[TM][TN], Epi epi) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) epi(ty * TM + i, tx + 16 * j, acc[i][j]);
}

// z = [taps | c] @ [w_in; w_cond] + b_in (+ gb) for the BM positions
// [t0, t0+BM) of batch row b, into zs (BM x G, f32, shared memory). The same
// function feeds the forward and the backward's recompute, so both see
// identical z.
__device__ void compute_z(const TrainArgs& a, int b, int t0, float* zs, float* tile) {
  const int kR = a.k * a.R, K = kR + (a.c ? a.cin : 0), G = a.G;
  const long long wofs = (long long)a.l * kR * G, cofs = (long long)a.l * a.cin * G;
  for (int n0 = 0; n0 < G; n0 += BN) {
    float acc[TM][TN];
    tile_product<true>(
        acc, K, tile,
        [&](int m, int kk) -> float {
          const int t = t0 + m;
          if (t >= a.T) return 0.0f;
          if (kk < kR) {
            const int j = kk / a.R, r = kk - j * a.R;
            return conv_input(a, b, t - (a.k - 1 - j) * a.d, r);
          }
          return ldf(a.c, ((long long)b * a.T + t) * a.cin + (kk - kR));
        },
        [&](int kk, int n) -> float {
          const int col = n0 + n;
          if (col >= G) return 0.0f;
          return kk < kR ? ldf(a.w_in, wofs + (long long)kk * G + col)
                         : ldf(a.w_cond, cofs + (long long)(kk - kR) * G + col);
        });
    tile_store(acc, [&](int m, int n, float v) {
      const int col = n0 + n;
      if (col < G) {
        float bias = a.b_in[a.l * G + col];
        if (a.gb) bias += a.gb[((long long)a.l * a.B + b) * G + col];
        zs[m * G + col] = v + bias;
      }
    });
  }
  __syncthreads();
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

// Shared memory of a position-tile kernel: z (BM x G) plus the product's
// staging tile.
inline size_t tile_kernel_smem(int G) {
  return sizeof(float) * ((size_t)BM * G + kTileSmemFloats);
}

template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace wn
