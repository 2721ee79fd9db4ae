// Log10-mel spectrogram of a batch of waveforms, for Hopper (sm_90a).
//
// Replaces: wavenet_vocoder_tpu/dsp/mel_jax.py::_mel_kernel (through
// _logmel_pallas's pl.pallas_call). Per frame f of a reflect-padded signal:
//   re[k] = sum_n x[f*hop + n] * cos_m[n][k],  im[k] likewise with sin_m
//   (the periodic Hann window is folded into both matrices),
//   mag[k] = sqrt(re^2 + im^2),  S[j] = sum_k mag[k] * mel_m[k][j],
//   out[f][j] = log10(max(S[j], 1e-10)).
// All in f32 with FP32 FMA; nothing is computed by a library.
//
// What bounds it on an H100: the flagship transform (n_fft 1024, hop 256,
// 513 bins, 80 mel bins) does 1,091,664 MACs per frame against 1 KB of new
// samples and 320 B of output per frame, and 4.4 MB of constant matrices in
// all, so it is bound by arithmetic: 30 s of audio (2,584 frames) is 5.64
// GFLOP, 0.084 ms at the 67 TFLOP/s FP32 rate, against ~0.002 ms of HBM
// traffic. Split-TF32 products on the tensor cores would lower that bound.
//
// What this design does about it (simple first version):
//   * The TPU kernel gets non-overlapping (f_blk, hop) row blocks plus a
//     parallel array of "tail" rows, because a Pallas BlockSpec cannot
//     overlap. Here a block just stages the (kFrames - 1) * hop + n_fft
//     samples its kFrames frames cover into shared memory once; frame f then
//     starts at offset f * hop. Reflect padding is done by index while
//     staging, and positions past the padded signal read as zero, so neither
//     the padded signal nor the framed signal nor the magnitudes reach
//     global memory.
//   * One block per kFrames = 32 frames and batch row. It walks the bins in
//     tiles of kBins = 128. Each of 512 threads owns one bin of the tile and 8
//     frames: 16 FP32 accumulators (re, im), fed by two coalesced matrix
//     loads per sample index (the matrices stay in L2; the loads run 8 rows
//     ahead of their use) and broadcast float4 reads of the samples. The tile's magnitudes and its 128 rows of the mel
//     matrix go to shared memory, and every thread adds the tile's share to
//     its slice of the (kFrames, n_mels) mel sums, which it keeps in
//     registers over all tiles. log10 at the end.
//   * The last bin tile holds one valid bin (513 = 4 * 128 + 1); its other
//     lanes skip the products.
#include <cuda_runtime.h>

namespace {

constexpr int kFrames = 32;    // frames per block
constexpr int kBins = 128;     // frequency bins per tile
constexpr int kThreads = 512;  // kBins x (kFrames / kPerThread)
constexpr int kPerThread = 8;  // frames per thread in the DFT products
constexpr int kDepth = 8;      // matrix rows per step of the DFT products
constexpr int kMaxOut = 8;     // mel sums per thread: kFrames * n_mels <= 4096

__global__ void __launch_bounds__(kThreads)
logmel(const float* __restrict__ y, const float* __restrict__ cos_m,
       const float* __restrict__ sin_m, const float* __restrict__ mel_m,
       float* __restrict__ out, int T, int n_frames, int n_fft, int hop,
       int n_bins, int n_mels) {
  extern __shared__ __align__(16) float smem[];
  const int n_stage = (kFrames - 1) * hop + n_fft;
  float* xs = smem;                          // n_stage samples
  float* mag_s = xs + n_stage;               // kFrames x kBins
  float* mel_s = mag_s + kFrames * kBins;    // kBins x n_mels

  const int b = blockIdx.y, f0 = blockIdx.x * kFrames;
  const int pad = n_fft / 2;
  const float* yb = y + (long long)b * T;

  // stage the block's samples: padded index p -> reflect -> y, zero past the
  // padded signal's end
  const long long p0 = (long long)f0 * hop;
  for (int i = threadIdx.x; i < n_stage; i += kThreads) {
    const long long p = p0 + i;
    float v = 0.0f;
    if (p < (long long)T + 2 * pad) {
      long long s = p - pad;
      if (s < 0) s = -s;
      if (s >= T) s = 2LL * (T - 1) - s;
      v = yb[s];
    }
    xs[i] = v;
  }
  __syncthreads();

  const int lane_bin = threadIdx.x % kBins;
  const int fg = threadIdx.x / kBins;        // frame group: frames fg*8..fg*8+7
  const float* xr = xs + fg * kPerThread * hop;
  const int n_out = kFrames * n_mels;

  float acc[kMaxOut];
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) acc[i] = 0.0f;

  for (int b0 = 0; b0 < n_bins; b0 += kBins) {
    const int bin = b0 + lane_bin;
    float re[kPerThread], im[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) re[i] = im[i] = 0.0f;
    if (bin < n_bins) {
      // kDepth rows of both matrices per step, loaded one step ahead of the
      // products that use them, so the L2 latency hides behind the FMAs
      const float* cp = cos_m + bin;
      const float* sp = sin_m + bin;
      float cw[kDepth], sw[kDepth];
#pragma unroll
      for (int j = 0; j < kDepth; ++j) {
        cw[j] = cp[(long long)j * n_bins];
        sw[j] = sp[(long long)j * n_bins];
      }
      for (int n = 0; n < n_fft; n += kDepth) {
        float cn[kDepth], sn[kDepth];
        if (n + kDepth < n_fft) {
#pragma unroll
          for (int j = 0; j < kDepth; ++j) {
            cn[j] = cp[(long long)(n + kDepth + j) * n_bins];
            sn[j] = sp[(long long)(n + kDepth + j) * n_bins];
          }
        }
#pragma unroll
        for (int j = 0; j < kDepth; j += 4) {
#pragma unroll
          for (int i = 0; i < kPerThread; ++i) {
            const float4 x =
                *reinterpret_cast<const float4*>(xr + i * hop + n + j);
            re[i] = fmaf(x.x, cw[j + 0], re[i]);
            im[i] = fmaf(x.x, sw[j + 0], im[i]);
            re[i] = fmaf(x.y, cw[j + 1], re[i]);
            im[i] = fmaf(x.y, sw[j + 1], im[i]);
            re[i] = fmaf(x.z, cw[j + 2], re[i]);
            im[i] = fmaf(x.z, sw[j + 2], im[i]);
            re[i] = fmaf(x.w, cw[j + 3], re[i]);
            im[i] = fmaf(x.w, sw[j + 3], im[i]);
          }
        }
#pragma unroll
        for (int j = 0; j < kDepth; ++j) {
          cw[j] = cn[j];
          sw[j] = sn[j];
        }
      }
    }
    __syncthreads();  // the previous tile's mel sums are done with mag_s, mel_s
#pragma unroll
    for (int i = 0; i < kPerThread; ++i)
      mag_s[(fg * kPerThread + i) * kBins + lane_bin] =
          sqrtf(re[i] * re[i] + im[i] * im[i]);
    for (int e = threadIdx.x; e < kBins * n_mels; e += kThreads) {
      const int row = b0 + e / n_mels;
      mel_s[e] = row < n_bins ? mel_m[(long long)b0 * n_mels + e] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxOut; ++i) {
      const int o = threadIdx.x + i * kThreads;
      if (o < n_out) {
        const int f = o / n_mels, j = o - f * n_mels;
        float a = acc[i];
        for (int k = 0; k < kBins; ++k)
          a = fmaf(mag_s[f * kBins + k], mel_s[k * n_mels + j], a);
        acc[i] = a;
      }
    }
  }

  float* ob = out + (long long)b * n_frames * n_mels;
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) {
    const int o = threadIdx.x + i * kThreads;
    if (o < n_out) {
      const int f = o / n_mels, j = o - f * n_mels;
      if (f0 + f < n_frames)
        ob[(long long)(f0 + f) * n_mels + j] = log10f(fmaxf(acc[i], 1e-10f));
    }
  }
}

}  // namespace

// y (B, T) f32; cos_m, sin_m (n_fft, n_bins) f32; mel_m (n_bins, n_mels) f32;
// out (B, n_frames, n_mels) f32, n_frames = 1 + T / hop. Needs n_fft % hop ==
// 0, hop % 8 == 0, T > n_fft / 2 and kFrames * n_mels <= 4096; the caller
// checks. Returns a CUDA error code, 0 on a clean launch.
extern "C" int wn_logmel(const void* y, const void* cos_m, const void* sin_m,
                         const void* mel_m, void* out, int B, int T,
                         int n_frames, int n_fft, int hop, int n_bins,
                         int n_mels, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)(kFrames - 1) * hop + n_fft +
                                       kFrames * kBins + (size_t)kBins * n_mels);
  cudaError_t err = cudaFuncSetAttribute(
      logmel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_frames + kFrames - 1) / kFrames, B);
  logmel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(cos_m),
      static_cast<const float*>(sin_m), static_cast<const float*>(mel_m),
      static_cast<float*>(out), T, n_frames, n_fft, hop, n_bins, n_mels);
  return (int)cudaGetLastError();
}
