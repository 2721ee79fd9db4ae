// Log10-mel spectrogram of a batch of waveforms, for Hopper (sm_90a).
//
// Replaces: wavenet_vocoder_tpu/dsp/mel_jax.py::_mel_kernel (through
// _logmel_pallas's pl.pallas_call). Per frame f of a reflect-padded signal:
//   re[k] = sum_n x[f*hop + n] * cos_m[n][k],  im[k] likewise with sin_m
//   (the periodic Hann window is folded into both matrices),
//   mag[k] = sqrt(re^2 + im^2),  S[j] = sum_k mag[k] * mel_m[k][j],
//   out[f][j] = log10(max(S[j], 1e-10)), NaN kept (as jnp.maximum keeps it).
// Nothing is computed by a library.
//
// What bounds it on an H100. The function needs little: a real FFT of each
// frame (2.5 n_fft log2 n_fft, 25,600 operations at n_fft 1024) and the mel
// weights (two non-zero per used bin) in FP32, against 1 KB of new samples
// and 320 B of output a frame at 3.35 TB/s: 8 x 1 s (696 frames) is 0.0003
// ms, bound by bytes (chip_smoke.py mel_bound). This kernel does far more
// arithmetic than that: it computes the DFT as matrix products, 2 x 1024 x
// 347 MACs a frame over the used bins (6..352 in the shipped presets; fmin
// 125, fmax 7600), 28 times the FFT's operations, in three TF32 passes on
// the tensor cores: 3.0 GFLOP at 8 x 1 s, 0.0066 ms at the 495 TFLOP/s TF32
// rate (the same products over all 513 bins in FP32 FMA are 0.023 ms).
// mma.sync reaches about half the TF32 rate on this card (a block's 12,288
// m16n8k8 products take ~26k cycles, PERF.md), so ~0.013 ms is the floor of
// this design at 8 x 1 s; an FFT is the way below it (PERF.md).
//
// What this design does about it:
//   * Only the used bins [k0, k1) are computed, read from the mel matrix once
//     per config by the wrapper (mel_torch.used_bins); a skipped bin's mel
//     weights are all 0.0, so the sums are exact.
//   * The frames of all batch rows are one dimension, cut into tiles of
//     kFrames; the used bins into tiles of kTileBins. One block per (frame
//     tile, bin tile): 8 x 1 s is 22 x 6 = 132 blocks, one wave on 132 SMs.
//   * A block stages the samples its frames cover, reflect padding done by
//     index, once per batch row its frames span; frame i is then the row at
//     off[i], for any hop. Where hop % 16 == 0, 8 floats of skew follow every
//     hop samples, so the 8 frames an mma fragment reads start in different
//     banks. The samples are staged as two TF32 halves, big = rna(x) and
//     small = rna(x - big), low 13 bits cleared: mma.sync reads a .tf32
//     operand's top 19 bits and truncates the rest, so the split rounds
//     explicitly. An even hop lets a thread load its two samples of a k-step
//     as one 8-byte word (the k-step's depth is permuted so that they are
//     adjacent); an odd hop takes two 4-byte loads. The rounding is two
//     integer operations on the bits, as cvt.rna.tf32.f32 rounds.
//   * DFT products: mma.sync m16n8k8 TF32, a*b = big*big + big*small +
//     small*big into f32 accumulators ("3xTF32", f32 accuracy). The DFT
//     matrices stream from L2 in B-fragment order through a ring of kRing
//     stages of kStage k-steps (cp.async) and are split in registers. Each
//     ring stage sums into fresh accumulators: mma.sync truncates as it
//     accumulates, and a sum carried through all 3 x n_fft / 8 products
//     drifts toward zero (8.5e-6 of the largest mel sum against 1.1e-6).
//     The products are C[bin][frame] = DFT^T x frames: the DFT is the A
//     operand, laid out on the host as the quads a lane holds, and a frame's
//     two samples of a k-step are the B operand's register pair as one
//     load. 16 warps: 4 k-groups (k-step kk of a stage is group kk % 4's) x 4
//     columns of 16 bins, each warp all 32 frames; group 0 adds the others'
//     sums in group order.
//   * The mel sums of a tile run over each band's used bins only (the zeros
//     between add exactly 0.0: the dense product's sum, in its order); a
//     frame with a non-finite magnitude is NaN in every band, as in the
//     dense product, where NaN or Inf times a zero weight is NaN.
//   * The bin tiles' partial sums go to a scratch buffer, and logmel_finish
//     adds them in tile order (no atomics), then applies the clamp and log10.
//     A first version summed them in a thread-block cluster of the frame
//     tile's bin tiles through distributed shared memory: clusters of 6 do
//     not pack the card's GPCs, so 8 x 1 s took two waves and about twice
//     the time of the scratch buffer and its second launch (PERF.md).
//   * The layout of a block's shared memory is decided here alone
//     (mel_layout); the wrapper asks wn_logmel_layout for it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFrames = 32;     // frames a block: two 16-row mma tiles
constexpr int kTileBins = 64;   // bins a bin tile: 8 n-tiles of 8
constexpr int kStage = 8;       // k-steps (8 samples deep) a ring stage
constexpr int kRing = 2;        // ring stages
constexpr int kNT = kFrames / 8;        // 8-frame n-tiles: a warp takes all of the block's
constexpr int kCols = kTileBins / 16;   // warps across the bins, one 16-bin m-tile each
constexpr int kGroups = 4;      // k-groups: k-step kk of a stage is group kk % kGroups's
constexpr int kWarps = kGroups * kCols;
constexpr int kThreads = 32 * kWarps;
constexpr int kStep4 = kCols * 2 * 32;  // float4s of one k-step's A fragments (cos, sin)
constexpr int kSums = kNT * 4;          // re (and im) accumulators a thread holds
constexpr int kMagLd = kTileBins + 4;   // = 4 mod 32: frame rows 2t apart in other banks
constexpr int kBatch = 8;             // staged samples a thread loads before storing
static_assert(kStage % kGroups == 0, "the k-groups take the k-steps of a stage in turn");
static_assert(kRing * kStage * kStep4 * 4 >= (kGroups - 1) * kCols * 2 * kSums * 32,
              "the k-groups' sums are added through the ring's memory");

// A block's shared memory for one shape: the skew (floats inserted after
// every hop samples where hop % 16 == 0, so that the 8 frames an mma fragment
// reads start in different banks), the staged floats of each TF32 half (the
// samples of kFrames frames, once per batch row they span: a segment of
// (frames - 1) hops + n_fft samples, 16-byte aligned), and the bytes of the
// whole layout that logmel_tc carves.
struct Layout {
  int skew, staged;
  size_t smem;
};
inline Layout mel_layout(int n_fft, int hop, int n_mels, int B,
                                             int n_frames) {
  Layout l;
  l.skew = hop % 16 == 0 ? 8 : 0;
  int most = 1 + (kFrames - 1 + n_frames - 1) / n_frames;  // batch rows a tile spans
  most = most < kFrames ? most : kFrames;
  most = most < B ? most : B;
  auto floats = [&](int segs) {
    return (long long)(kFrames - segs) * hop + (long long)segs * n_fft + 4 * segs +
           (long long)l.skew * (kFrames - segs + segs * ((n_fft + hop - 1) / hop));
  };
  const long long a = floats(1), b = floats(most);
  l.staged = (int)(((a > b ? a : b) + 3) / 4 * 4);
  l.smem = sizeof(float) * ((size_t)kRing * kStage * kStep4 * 4 + 2 * (size_t)l.staged +
                            kFrames * kMagLd + (size_t)kTileBins * n_mels +
                            (size_t)kFrames * n_mels + 2 * kFrames + 2 * (size_t)n_mels);
  return l;
}

struct MelArgs {
  const float* y;       // (B, T)
  const float4* frag;   // (tiles, n_fft / 8, 4, 2, 32) float4: DFT A fragments
  const float* rows;    // (tiles * kTileBins, n_mels): mel rows of the used bins
  const int* bands;     // (n_mels, 2): [first, last + 1) used bin of each band's weights
  float* out;           // (B, n_frames, n_mels)
  float* scratch;       // (B * n_frames, tiles, n_mels): the tiles' partial mel sums
  int B, T, n_frames, n_fft, hop, n_mels, tiles, skew, staged;  // skew, staged: mel_layout
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// the TF32 value nearest x, ties away from zero, low 13 bits cleared: what
// cvt.rna.tf32.f32 gives, in two integer operations on the bits (adding half
// a TF32 ulp to the magnitude carries into the kept bits; NaN stays NaN and
// Inf stays Inf)
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// sample p of the reflect-padded row (pad = n_fft / 2), zero past its end
__device__ __forceinline__ float padded_sample(const float* yb, int p, int T, int pad) {
  if (p >= T + 2 * pad) return 0.0f;
  int s = p - pad;
  if (s < 0) s = -s;
  if (s >= T) s = 2 * (T - 1) - s;
  return yb[s];
}
// max(S, 1e-10) that keeps NaN, as jnp.maximum and torch.clamp do (a
// comparison with NaN is false; fmaxf would return 1e-10), then log10
__device__ __forceinline__ float log_clamped(float S) {
  return log10f(S < 1e-10f ? 1e-10f : S);
}

template <bool kPairs>
__global__ void __launch_bounds__(kThreads) logmel_tc(MelArgs a) {
  extern __shared__ __align__(16) float smem[];
  float4* ring = reinterpret_cast<float4*>(smem);
  float* red = smem;                                 // the k-groups' sums (after the ring)
  float* xb = smem + kRing * kStage * kStep4 * 4;   // big halves of the samples
  float* xsm = xb + a.staged;                        // small halves
  float* mag = xsm + a.staged;                       // kFrames x kMagLd
  float* melr = mag + kFrames * kMagLd;              // kTileBins x n_mels
  float* part = melr + kTileBins * a.n_mels;         // kFrames x n_mels
  int* off = reinterpret_cast<int*>(part + kFrames * a.n_mels);  // kFrames
  int* bad = off + kFrames;                          // kFrames: a non-finite magnitude
  int* bands = bad + kFrames;                        // n_mels x 2

  const int bt = blockIdx.x % a.tiles;               // bin tile
  const long long g0 = (long long)(blockIdx.x / a.tiles) * kFrames;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kg = warp / kCols, wn = warp % kCols;
  const int nf = (int)min((long long)kFrames, (long long)a.B * a.n_frames - g0);
  const int n_out = kFrames * a.n_mels;
  const int n_ks = a.n_fft / 8;
  const int n_st = (n_ks + kStage - 1) / kStage;

  // one ring stage: kStage k-steps of the bin tile's B fragments
  auto issue = [&](int s) {
    if (s < n_st) {
      const int nk = min(kStage, n_ks - s * kStage);
      const float4* src = a.frag + ((long long)bt * n_ks + s * kStage) * kStep4;
      float4* dst = ring + (s % kRing) * kStage * kStep4;
      for (int i = tid; i < nk * kStep4; i += kThreads) cp_async16(dst + i, src + i);
    }
    cp_async_commit();
  };
  {  // the tile's mel rows ride in stage 0's group
    const float4* src =
        reinterpret_cast<const float4*>(a.rows + (long long)bt * kTileBins * a.n_mels);
    float4* dst = reinterpret_cast<float4*>(melr);
    for (int i = tid; i < kTileBins * a.n_mels / 4; i += kThreads) cp_async16(dst + i, src + i);
  }
  for (int s = 0; s < kRing - 1; ++s) issue(s);

  for (int j = tid; j < 2 * a.n_mels; j += kThreads) bands[j] = a.bands[j];
  // stage the tile's frames, one segment per batch row they span; each thread
  // loads kBatch samples before it converts and stores them
  {
    const int pad = a.n_fft / 2;
    // e / hop for the skew, by a reciprocal: (e + 0.5) / hop is at least
    // 0.5 / hop from an integer, far above the float's rounding
    const float inv_hop = 1.0f / (float)a.hop;
    int base = 0, i = 0;
    long long gf = g0;
    while (i < nf) {
      const int b = (int)(gf / a.n_frames);
      const int f = (int)(gf - (long long)b * a.n_frames);
      const int cnt = min(nf - i, a.n_frames - f);
      const int L = (cnt - 1) * a.hop + a.n_fft;
      for (int j = tid; j < cnt; j += kThreads) off[i + j] = base + j * (a.hop + a.skew);
      const float* yb = a.y + (long long)b * a.T;
      const int p0 = f * a.hop;
      for (int e0 = tid; e0 < L; e0 += kThreads * kBatch) {
        float v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * kThreads;
          v[u] = e < L ? padded_sample(yb, p0 + e, a.T, pad) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * kThreads;
          if (e < L) {
            const int at =
                base + e + (a.skew ? a.skew * (int)(((float)e + 0.5f) * inv_hop) : 0);
            const uint32_t big = tf32_bits(v[u]);
            xb[at] = __uint_as_float(big);
            xsm[at] = __uint_as_float(tf32_bits(v[u] - __uint_as_float(big)));
          }
        }
      }
      const int Ls = L + (a.skew ? a.skew * ((L - 1) / a.hop) : 0);
      base += (Ls + 3) & ~3;
      i += cnt;
      gf += cnt;
    }
    for (int j = tid; j < kFrames; j += kThreads) {
      if (j >= nf) off[j] = 0;  // rows not written out
      bad[j] = 0;
    }
  }
  __syncthreads();
  // the B operand: frame 8 n + g of each n-tile, samples 2t and 2t + 1
  int coloff[kNT];
#pragma unroll
  for (int n = 0; n < kNT; ++n) coloff[n] = off[n * 8 + g] + 2 * t;

  // C[bin][frame] = DFT^T (16 bins x 8 samples, A) x frames (8 samples x 8
  // frames, B): accumulator n holds bins 16 wn + g (v < 2) and + 8 (v >= 2),
  // frames 8 n + 2t + (v & 1)
  float re[kNT][4], im[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int v = 0; v < 4; ++v) re[n][v] = im[n][v] = 0.0f;

  // the skew of the hop-chunk that holds samples k..k+7 of the k-steps this
  // k-group takes (hop % 16 == 0 where the skew is not 0: one chunk)
  int skewed = 0, edge = a.hop;
  for (int s = 0; s < n_st; ++s) {
    cp_async_wait<kRing - 2>();
    __syncthreads();
    issue(s + kRing - 1);
    const float4* rb = ring + (s % kRing) * kStage * kStep4 + wn * 2 * 32 + lane;
    const int nk = min(kStage, n_ks - s * kStage);
    float pre[kNT][4], pim[kNT][4];  // this stage's sums
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) pre[n][v] = pim[n][v] = 0.0f;
#pragma unroll
    for (int q = 0; q < kStage / kGroups; ++q) {
      const int kk = kg + q * kGroups;
      if (kk < nk) {
        const int k = (s * kStage + kk) * 8;
        while (k >= edge) {
          skewed += a.skew;
          edge += a.hop;
        }
        const int col = k + skewed;
        // this lane's A quads (bins g, g + 8 x samples 2t, 2t + 1) of cos and
        // sin, split into big = rna(a) and small = a - big (read truncated by
        // the mma: an error of 2^-21 of a at most)
        uint32_t cb[4], cs[4], sb[4], ss[4];
        const float4 cw = rb[kk * kStep4], sw = rb[kk * kStep4 + 32];
        const float cv[4] = {cw.x, cw.y, cw.z, cw.w}, sv[4] = {sw.x, sw.y, sw.z, sw.w};
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          cb[v] = tf32_bits(cv[v]);
          cs[v] = __float_as_uint(cv[v] - __uint_as_float(cb[v]));
          sb[v] = tf32_bits(sv[v]);
          ss[v] = __float_as_uint(sv[v] - __uint_as_float(sb[v]));
        }
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const int at = coloff[n] + col;
          uint32_t xb0, xb1, xs0, xs1;
          if (kPairs) {
            const float2 u = *reinterpret_cast<const float2*>(xb + at);
            const float2 w = *reinterpret_cast<const float2*>(xsm + at);
            xb0 = __float_as_uint(u.x); xb1 = __float_as_uint(u.y);
            xs0 = __float_as_uint(w.x); xs1 = __float_as_uint(w.y);
          } else {
            xb0 = __float_as_uint(xb[at]); xb1 = __float_as_uint(xb[at + 1]);
            xs0 = __float_as_uint(xsm[at]); xs1 = __float_as_uint(xsm[at + 1]);
          }
#ifdef WN_MEL_NO_PRODUCTS  // a timing aid: the loop without its products
          pre[n][0] += __uint_as_float(cb[0] ^ cs[1] ^ xb0 ^ xs1);
          pim[n][0] += __uint_as_float(sb[2] ^ ss[3] ^ xb1 ^ xs0);
          continue;
#endif
          mma_tf32(pre[n], cs, xb0, xb1);
          mma_tf32(pre[n], cb, xs0, xs1);
          mma_tf32(pre[n], cb, xb0, xb1);
          mma_tf32(pim[n], ss, xb0, xb1);
          mma_tf32(pim[n], sb, xs0, xs1);
          mma_tf32(pim[n], sb, xb0, xb1);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        re[n][v] += pre[n][v];
        im[n][v] += pim[n][v];
      }
  }
  cp_async_wait<0>();

  // k-groups 1.. hand their sums to group 0 through the ring's memory (the
  // last issues were empty), lane by lane, which adds them in group order
  __syncthreads();
  if (kg > 0) {
    float* mine = red + ((kg - 1) * kCols + wn) * 2 * kSums * 32 + lane;
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        mine[(n * 4 + v) * 32] = re[n][v];
        mine[(kSums + n * 4 + v) * 32] = im[n][v];
      }
  }
  __syncthreads();
  if (kg == 0) {
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        float r = re[n][v], m = im[n][v];
#pragma unroll
        for (int q = 0; q < kGroups - 1; ++q) {
          const float* theirs = red + (q * kCols + wn) * 2 * kSums * 32 + lane;
          r += theirs[(n * 4 + v) * 32];
          m += theirs[(kSums + n * 4 + v) * 32];
        }
        const int f = n * 8 + 2 * t + (v & 1), b = wn * 16 + g + 8 * (v >> 1);
        const float mg = sqrtf(r * r + m * m);
        mag[f * kMagLd + b] = mg;
        if (!isfinite(mg)) bad[f] = 1;
      }
  }
  __syncthreads();
  // the tile's mel sums over each band's used bins only
  const int b0 = bt * kTileBins;
  for (int o = tid; o < n_out; o += kThreads) {
    const int f = o / a.n_mels, j = o - f * a.n_mels;
    const int lo = max(bands[2 * j] - b0, 0), hi = min(bands[2 * j + 1] - b0, kTileBins);
    const float* mr = mag + f * kMagLd;
    float acc = 0.0f;
    for (int b = lo; b < hi; ++b) acc = fmaf(mr[b], melr[b * a.n_mels + j], acc);
    part[o] = bad[f] ? __int_as_float(0x7fffffff) : acc;
  }
  // logmel_finish adds the tiles' sums in tile order
  __syncthreads();
  for (int o = tid; o < nf * a.n_mels; o += kThreads) {
    const int f = o / a.n_mels;
    a.scratch[((g0 + f) * a.tiles + bt) * a.n_mels + (o - f * a.n_mels)] = part[o];
  }
}

// the bin tiles' mel sums, added in tile order, clamped and log10'd
__global__ void logmel_finish(const float* scratch, float* out, long long n, int tiles,
                              int n_mels) {
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n) return;
  const long long f = o / n_mels;
  const float* p = scratch + f * tiles * n_mels + (o - f * n_mels);
  float S = 0.0f;
  for (int q = 0; q < tiles; ++q) S += p[(long long)q * n_mels];
  out[o] = log_clamped(S);
}

}  // namespace

// What the wrapper needs of the layout for one shape: out = {bins a bin
// tile (the DFT fragments are laid out per tile), skew, staged floats,
// shared-memory bytes of a block}.
extern "C" void wn_logmel_layout(int n_fft, int hop, int n_mels, int B, int n_frames,
                                 long long* out) {
  const Layout l = mel_layout(n_fft, hop, n_mels, B, n_frames);
  out[0] = kTileBins;
  out[1] = l.skew;
  out[2] = l.staged;
  out[3] = (long long)l.smem;
}

// y (B, T) f32; frag, rows and bands as made by mel_torch._kernel_consts; out
// (B, n_frames, n_mels) f32, n_frames = 1 + T / hop; scratch (B * n_frames,
// tiles, n_mels) f32. Needs n_fft % 8 == 0, T > n_fft / 2 and the layout's
// shared memory within a block's; the caller checks. Two launches on
// `stream`. Returns a CUDA error code, 0 on clean launches.
extern "C" int wn_logmel(const void* y, const void* frag, const void* rows, const void* bands,
                         void* out, void* scratch, int B, int T, int n_frames, int n_fft, int hop,
                         int n_mels, int tiles, void* stream) {
  const Layout l = mel_layout(n_fft, hop, n_mels, B, n_frames);
  MelArgs a{static_cast<const float*>(y),  static_cast<const float4*>(frag),
            static_cast<const float*>(rows), static_cast<const int*>(bands),
            static_cast<float*>(out),      static_cast<float*>(scratch),
            B, T, n_frames, n_fft, hop, n_mels, tiles, l.skew, l.staged};
  const bool pairs = hop % 2 == 0;
  void (*kern)(MelArgs) = pairs ? logmel_tc<true> : logmel_tc<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
  if (err != cudaSuccess) return (int)err;
  const long long frame_tiles = ((long long)B * n_frames + kFrames - 1) / kFrames;
  const unsigned grid = (unsigned)(frame_tiles * tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pairs)
    logmel_tc<true><<<grid, kThreads, l.smem, st>>>(a);
  else
    logmel_tc<false><<<grid, kThreads, l.smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)B * n_frames * n_mels;
  logmel_finish<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(scratch), static_cast<float*>(out), n, tiles, n_mels);
  return (int)cudaGetLastError();
}
