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
// What this design does about it (simple first version):
//   * The TPU kernel walks the whole stack per time tile and carries the
//     last (k-1)*max_dilation columns of every layer from one tile to the
//     next; that needs the TPU's in-order grid. GPU blocks run in any order,
//     so this kernel is layer-major: one launch per layer, blocks over
//     (64-position tile, batch row), each reading its taps' history straight
//     from the previous layer's stash in global memory (zero for t < 0). No
//     halo is recomputed and no tile order is assumed.
//   * The residual chain stays f32 between launches (two ping-pong f32
//     carriers); only the conv input is rounded to the storage type, as in
//     the TPU kernel.
//   * Every product is computed here: shared-memory tiles of 64 positions x
//     128 columns, 16 deep, plain FP32 FMA with f32 accumulation (each thread
//     4 x 8 outputs). z stays in shared memory for the GLU, and the gated
//     tile feeds the out|skip product from shared memory. Tensor cores
//     (wgmma over bf16 tiles) are the next step; the FP32 path runs far below
//     the bound, and PERF.md records by how much.
#include "train_common.cuh"

namespace {

using namespace wn;

template <typename W>
__global__ void __launch_bounds__(kThreads) fwd_layer(TrainArgs a) {
  extern __shared__ float smem[];
  float* zs = smem;                          // BM x G
  float* tile = smem + BM * a.G;
  const int b = blockIdx.y, t0 = blockIdx.x * BM;
  const int G = a.G, G2 = G / 2, R = a.R, S = a.S, RS = R + S;

  compute_z<W>(a, b, t0, zs, tile);

  // GLU in place: zs[m][g] <- round(tanh(a) * sigmoid(b)) for g < G/2
  for (int e = threadIdx.x; e < BM * G2; e += kThreads) {
    const int m = e / G2, g = e - m * G2;
    zs[m * G + g] = rnd<W>(tanhf(zs[m * G + g]) * sigmoidf_(zs[m * G + G2 + g]));
  }
  __syncthreads();

  const long long wofs = (long long)a.l * G2 * RS;
  for (int n0 = 0; n0 < RS; n0 += BN) {
    float acc[TM][TN];
    tile_product<true>(
        acc, G2, tile, [&](int m, int kk) -> float { return zs[m * G + kk]; },
        [&](int kk, int n) -> float {
          const int col = n0 + n;
          return col < RS ? ld<W>(a.w_og, wofs + (long long)kk * RS + col) : 0.0f;
        });
    tile_store(acc, [&](int m, int n, float v) {
      const int col = n0 + n, t = t0 + m;
      if (col >= RS || t >= a.T) return;
      v += a.b_og[a.l * RS + col];
      const long long pos = (long long)b * a.T + t;
      if (col < R) {
        if (!a.xnext) return;  // the last layer's residual output is unused
        const float x = a.xres ? a.xres[pos * R + col] : ld<W>(a.xs_l, pos * R + col);
        const float xn = (v + x) * kSqrtHalf;
        a.xnext[pos * R + col] = xn;
        static_cast<W*>(a.xs_next)[pos * R + col] = from_f<W>(xn);
      } else {
        a.skips[pos * S + (col - R)] += v;
      }
    });
  }
}

template <typename W>
cudaError_t launch(const TrainArgs& a, cudaStream_t s) {
  const size_t smem = tile_kernel_smem(a.G);
  cudaError_t err = allow_smem(fwd_layer<W>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.T + BM - 1) / BM, a.B);
  fwd_layer<W><<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// One layer of the forward (layer a->l). Returns a CUDA error code, 0 on a
// clean launch.
extern "C" int wn_train_fwd_layer(const TrainArgs* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a->bf16 ? (int)launch<__nv_bfloat16>(*a, s) : (int)launch<float>(*a, s);
}
