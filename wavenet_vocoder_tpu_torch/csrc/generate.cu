// Fused autoregressive WaveNet generation for Hopper (sm_90a).
//
// Replaces: wavenet_vocoder_tpu/ops/pallas_generate.py::_make_kernel, variant
// "fused" (launched by _pallas_generate_jit through pl.pallas_call). One launch
// runs steps [t0, t0+n) of the whole AR decoder for B streams: first 1x1 conv
// -> per layer, the k dilated taps gathered from the packed ring buffer,
// [taps | cond] @ w_in + b_in (+ global gate), GLU, gated @ w_og + b_og ->
// residual * sqrt(1/2) and summed skips -> head (ReLU, 1x1, ReLU, 1x1) ->
// categorical / mixture-of-logistics / Gaussian sample (or argmax / mean when
// deterministic) fed back as the next input.
//
// What bounds it on an H100: per step and stream the network is a chain of
// 2*L+3 dependent matrix-vector products (flagship: ~3.66 MFLOP a stream, bf16
// weights 7.3 MB). Across streams the work is a (B x K) @ (K x N) product, so
// at B=256 a step is ~1.87 GFLOP against 7.3 MB of weights: the card's bound
// is its tensor-core rate, but only if the weights are read once a step for
// all streams. The TPU kernel kept all weights in VMEM; one SM's 227 KB of
// shared memory cannot hold 7.3 MB.
//
// What this design does about it (simple first version):
//   * Parallel over streams, not over weights: grid = ceil(B / BT) blocks, each
//     owning BT streams and walking every step and layer in a loop inside the
//     block. AR chains of different streams are independent, so blocks never
//     synchronise with each other. A loop replaces the TPU's sequential grid.
//   * Weights stay in global memory and every block rereads them each step;
//     they fit the 50 MB L2, so the rereads are L2 traffic. With BT streams a
//     block does BT FMAs per weight it loads, so BT trades L2 traffic
//     (ceil(B/BT) * 7.3 MB a step) against how many SMs are busy.
//   * A step is a chain of dependent products, so a block's time per step is
//     set by the rounds of L2 loads its threads wait for and by the 7.3 MB it
//     pulls through its one SM's port to L2 — not by the card's totals,
//     which is why this design stays far from the bound (PERF.md). Products
//     are plain FP32 FMAs: the BT input vectors sit in
//     shared memory; each of 512 threads owns 8 adjacent output columns and
//     a strided slice of the rows, issues 8 independent 16-byte weight loads
//     before it uses any, and the slices' partial sums are added after a
//     barrier. A warp reads whole row segments. Tensor cores (mma/wgmma) and
//     weights split across a thread-block cluster are later redesigns.
//   * Ring buffers (rows, B, R) and the current input (B, C_in) live in global
//     memory, allocated by the caller, so state survives between launches.
//     Ring indexing is the JAX kernel's read-before-write modular scheme.
//   * Random numbers come from a counter-based hash of (seed, stream, absolute
//     step, draw index): results do not depend on BT or on launch boundaries,
//     and the plain PyTorch version in ops/cuda_generate.py computes the same
//     bits with int64 tensor ops.
//
// Numerics: products accumulate in f32; inputs of every product are rounded to
// the pack dtype first (as the JAX kernel's .astype before each jnp.dot); GLU,
// skips and heads run in f32. f32 packs use tanh(a)*sigmoid(b); bf16 packs use
// the one-divide exp form (e^{2a}-1)/((e^{2a}+1)(1+e^{-b})) of the JAX bf16
// production kernel. log_scale_min is not applied (as in the JAX kernel).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kInFlight = 8;  // independent weight loads per thread per round

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename W> __device__ __forceinline__ W from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// round to the pack dtype and back
template <typename W> __device__ __forceinline__ float rnd(float x) { return to_f(from_f<W>(x)); }

template <typename W> __device__ __forceinline__ float glu(float a, float b);
template <> __device__ __forceinline__ float glu<float>(float a, float b) {
  return tanhf(a) * (1.0f / (1.0f + expf(-b)));
}
template <> __device__ __forceinline__ float glu<__nv_bfloat16>(float a, float b) {
  float u = expf(2.0f * fminf(fmaxf(a, -15.0f), 15.0f));
  float v = expf(fminf(fmaxf(-b, -30.0f), 30.0f));
  return (u - 1.0f) / ((u + 1.0f) * (1.0f + v));
}

// 32-bit avalanche hash; both multipliers are below 2^31 so that the plain
// version can evaluate it exactly in int64.
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352dU;
  x ^= x >> 15;
  x *= 0x2c1b3c6dU;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float uniform(uint32_t key, uint32_t draw) {
  float u = (float)(mix32(key ^ draw) >> 8) * (1.0f / 16777216.0f);
  return fminf(fmaxf(u, 1e-5f), 1.0f - 1e-5f);
}

// V consecutive weights of one row, loaded raw (16 bytes for V=8 bf16, 32
// for V=8 f32, one element for V=1) and widened to floats.
template <typename W, int V> struct Row;
template <> struct Row<__nv_bfloat16, 8> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void get(float* w) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(h[q]);
      w[2 * q] = f.x;
      w[2 * q + 1] = f.y;
    }
  }
};
template <> struct Row<float, 8> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void get(float* w) const {
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  }
};
template <typename W> struct Row<W, 1> {
  W v;
  __device__ __forceinline__ void load(const W* p) { v = *p; }
  __device__ __forceinline__ void get(float* w) const { w[0] = to_f(v); }
};

// Partial products of x (BT rows of K, stride xs, in shared memory) with
// w (K x N, row-major, N % V == 0; V=8 needs 16-byte aligned rows). Thread
// (c, s) owns columns [V*c, V*c+V) and rows s, s+KS, ..., loaded kInFlight
// at a time before any is used, so a round costs one L2 latency; with V=8
// a warp reads whole row segments. Partial sums go to
// red[(s*BT + bi)*N + col]; the caller sums over s after a barrier.
// KS*N <= V*kThreads floats per stream.
template <typename W, int BT, int V>
__device__ __forceinline__ void matvec_partial(const W* __restrict__ w, int K, int N,
                                               const float* x, int xs, float* red) {
  const int NC = N / V, KS = kThreads / NC;
  const int c = threadIdx.x % NC, s = threadIdx.x / NC;
  if (s >= KS) return;
  float acc[BT][V];
#pragma unroll
  for (int bi = 0; bi < BT; ++bi)
#pragma unroll
    for (int q = 0; q < V; ++q) acc[bi][q] = 0.0f;
  const W* wp = w + c * V;
  for (int i0 = s; i0 < K; i0 += KS * kInFlight) {
    Row<W, V> rows[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = i0 + u * KS;
      if (i < K) rows[u].load(wp + (long long)i * N);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = i0 + u * KS;
      if (i < K) {
        float wv[V];
        rows[u].get(wv);
#pragma unroll
        for (int bi = 0; bi < BT; ++bi) {
          const float xv = x[bi * xs + i];
#pragma unroll
          for (int q = 0; q < V; ++q) acc[bi][q] += xv * wv[q];
        }
      }
    }
  }
#pragma unroll
  for (int bi = 0; bi < BT; ++bi)
#pragma unroll
    for (int q = 0; q < V; ++q) red[(s * BT + bi) * N + c * V + q] = acc[bi][q];
}

// Sum of the partials of column col for stream bi.
template <int BT, int V>
__device__ __forceinline__ float reduce_partial(const float* red, int N, int bi, int col) {
  const int KS = kThreads / (N / V);
  float v = 0.0f;
  for (int s = 0; s < KS; ++s) v += red[(s * BT + bi) * N + col];
  return v;
}

struct Params {
  const void* w_first; const float* b_first;  // (C_in, R), (R)
  const void* w_in; const float* b_in;        // (L, Kin, G), (L, G)
  const void* w_og; const float* b_og;        // (L, G2, R+S), (L, R+S)
  const void* w_h1; const float* b_h1;        // (S, S), (S)
  const void* w_h2; const float* b_h2;        // (S, C_out), (C_out)
  const void* cond; long long cond_sb;        // step j of stream b: cond + b*cond_sb + j*cin
  const float* g_gate;                        // (L, B, G) or null
  void* ring;                                 // (rows, B, R), pack dtype
  float* x_cur;                               // (B, C_in)
  void* out; long long out_sb;                // step j of stream b: out + b*out_sb + j
  int B, n, t0;
  uint32_t seed;
  int L, lps, k, R, G, S, C_in, C_out, cin;
  int head;           // 0 categorical, 1 logistic mixture, 2 normal
  int deterministic;
};

template <typename W, int BT>
__global__ void __launch_bounds__(kThreads, 1) generate_kernel(Params p) {
  extern __shared__ float smem[];
  const int R = p.R, G = p.G, G2 = p.G / 2, S = p.S, RS = p.R + p.S;
  const int k = p.k, cin = p.cin, C_in = p.C_in, C_out = p.C_out;
  const int Kin = k * R + cin;
  float* red = smem;                 // BT * 8 * kThreads (product partials)
  float* xin = red + BT * 8 * kThreads;  // BT * Kin
  float* gt = xin + BT * Kin;        // BT * G2
  float* hb = gt + BT * G2;          // BT * R
  float* sk = hb + BT * R;           // BT * S
  float* o1 = sk + BT * S;           // BT * S
  float* lo = o1 + BT * S;           // BT * C_out
  float* xc = lo + BT * C_out;       // BT * C_in

  const int tid = threadIdx.x;
  const int base = blockIdx.x * BT;
  const W* w_first = static_cast<const W*>(p.w_first);
  const W* w_in = static_cast<const W*>(p.w_in);
  const W* w_og = static_cast<const W*>(p.w_og);
  const W* w_h1 = static_cast<const W*>(p.w_h1);
  const W* w_h2 = static_cast<const W*>(p.w_h2);
  const W* cond = static_cast<const W*>(p.cond);
  W* ring = static_cast<W*>(p.ring);
  const float sqrt_half = 0.70710678118654752440f;
  const float sqrt_inv_L = (float)sqrt(1.0 / (double)p.L);

  for (int e = tid; e < BT * C_in; e += kThreads) {
    int b = base + e / C_in;
    xc[e] = b < p.B ? p.x_cur[(long long)b * C_in + e % C_in] : 0.0f;
  }
  __syncthreads();

  for (int j = 0; j < p.n; ++j) {
    const int t = p.t0 + j;

    // first 1x1 conv; zero inputs (the one-hot case) are skipped uniformly
    for (int r = tid; r < R; r += kThreads) {
      float acc[BT];
#pragma unroll
      for (int bi = 0; bi < BT; ++bi) acc[bi] = 0.0f;
      for (int i = 0; i < C_in; ++i) {
        bool any = false;
#pragma unroll
        for (int bi = 0; bi < BT; ++bi) any |= xc[bi * C_in + i] != 0.0f;
        if (!any) continue;
        float w = to_f(w_first[i * R + r]);
#pragma unroll
        for (int bi = 0; bi < BT; ++bi) acc[bi] += rnd<W>(xc[bi * C_in + i]) * w;
      }
#pragma unroll
      for (int bi = 0; bi < BT; ++bi) hb[bi * R + r] = acc[bi] + p.b_first[r];
    }
    for (int e = tid; e < BT * S; e += kThreads) sk[e] = 0.0f;
    __syncthreads();

    int off = 0;
    for (int l = 0; l < p.L; ++l) {
      const int d = 1 << (l % p.lps);
      const int Ll = (k - 1) * d;
      // gather [taps oldest..newest | cond] in the pack dtype
      for (int e = tid; e < BT * Kin; e += kThreads) {
        const int bi = e / Kin, i = e % Kin, b = base + bi;
        float v = 0.0f;
        if (i < (k - 1) * R) {
          const int jd = (k - 1 - i / R) * d;
          const int row = off + (((t - jd) % Ll) + Ll) % Ll;
          if (b < p.B) v = to_f(ring[((long long)row * p.B + b) * R + i % R]);
        } else if (i < k * R) {
          v = rnd<W>(hb[bi * R + i - (k - 1) * R]);
        } else if (b < p.B) {
          v = to_f(cond[b * p.cond_sb + (long long)j * cin + (i - k * R)]);
        }
        xin[e] = v;
      }
      __syncthreads();

      // [taps | cond] @ w_in; write this layer's input to the ring after all
      // its reads (evicts x[t-Ll])
      matvec_partial<W, BT, 8>(w_in + (long long)l * Kin * G, Kin, G, xin, Kin, red);
      for (int e = tid; e < BT * R; e += kThreads) {
        const int b = base + e / R;
        if (b < p.B)
          ring[((long long)(off + t % Ll) * p.B + b) * R + e % R] = from_f<W>(hb[e]);
      }
      __syncthreads();

      // + b_in (+ global gate), GLU
      for (int e = tid; e < BT * G2; e += kThreads) {
        const int bi = e / G2, q = e % G2, b = base + bi;
        float za = reduce_partial<BT, 8>(red, G, bi, q) + p.b_in[l * G + q];
        float zg = reduce_partial<BT, 8>(red, G, bi, G2 + q) + p.b_in[l * G + G2 + q];
        if (p.g_gate != nullptr && b < p.B) {
          const float* gg = p.g_gate + ((long long)l * p.B + b) * G;
          za += gg[q];
          zg += gg[G2 + q];
        }
        gt[e] = rnd<W>(glu<W>(za, zg));
      }
      __syncthreads();

      // gated @ [w_out | w_skip] -> residual and skip
      matvec_partial<W, BT, 8>(w_og + (long long)l * G2 * RS, G2, RS, gt, G2, red);
      __syncthreads();
      for (int e = tid; e < BT * RS; e += kThreads) {
        const int bi = e / RS, col = e % RS;
        const float y = reduce_partial<BT, 8>(red, RS, bi, col) + p.b_og[l * RS + col];
        if (col < R)
          hb[bi * R + col] = (y + hb[bi * R + col]) * sqrt_half;
        else
          sk[bi * S + col - R] += y;
      }
      __syncthreads();
      off += Ll;
    }

    // head: ReLU -> 1x1 -> ReLU -> 1x1
    for (int e = tid; e < BT * S; e += kThreads)
      sk[e] = rnd<W>(fmaxf(sk[e] * sqrt_inv_L, 0.0f));
    __syncthreads();
    matvec_partial<W, BT, 8>(w_h1, S, S, sk, S, red);
    __syncthreads();
    for (int e = tid; e < BT * S; e += kThreads) {
      const int bi = e / S, col = e % S;
      o1[e] = rnd<W>(fmaxf(reduce_partial<BT, 8>(red, S, bi, col) + p.b_h1[col], 0.0f));
    }
    __syncthreads();
    matvec_partial<W, BT, 1>(w_h2, S, C_out, o1, S, red);
    __syncthreads();
    for (int e = tid; e < BT * C_out; e += kThreads) {
      const int bi = e / C_out, col = e % C_out;
      lo[e] = reduce_partial<BT, 1>(red, C_out, bi, col) + p.b_h2[col];
    }
    __syncthreads();

    // sampling: warp bi owns stream base + bi
    const int warp = tid / 32, lane = tid % 32;
    const int b = base + warp;
    if (warp < BT && b < p.B) {
      const float* o = lo + warp * C_out;
      const uint32_t key = mix32(mix32(mix32(p.seed) ^ (uint32_t)b) ^ (uint32_t)t);
      if (p.head == 0) {
        // argmax of logits (+ Gumbel noise); ties go to the lowest index
        float best = -INFINITY;
        int arg = C_out;
        for (int c = lane; c < C_out; c += 32) {
          float v = o[c];
          if (!p.deterministic) v -= logf(-logf(uniform(key, (uint32_t)c)));
          if (v > best || arg == C_out) { best = v; arg = c; }
        }
        for (int m = 16; m > 0; m >>= 1) {
          float ob = __shfl_xor_sync(0xffffffffu, best, m);
          int oa = __shfl_xor_sync(0xffffffffu, arg, m);
          if (ob > best || (ob == best && oa < arg)) { best = ob; arg = oa; }
        }
        if (lane == 0)
          static_cast<int*>(p.out)[b * p.out_sb + j] = arg;
        for (int c = lane; c < C_in; c += 32)
          xc[warp * C_in + c] = c == arg ? 1.0f : 0.0f;
      } else if (lane == 0) {
        float mean, ls;
        int nr = 1;
        if (C_out == 2) {
          mean = o[0];
          ls = o[1];
        } else {
          nr = C_out / 3;
          float best = -INFINITY;
          int sel = 0;
          for (int c = 0; c < nr; ++c) {
            float v = o[c];
            if (!p.deterministic) v -= logf(-logf(uniform(key, (uint32_t)c)));
            if (c == 0 || v > best) { best = v; sel = c; }
          }
          mean = o[nr + sel];
          ls = o[2 * nr + sel];
        }
        float x = mean;
        if (!p.deterministic) {
          if (p.head == 2) {
            const uint32_t d0 = C_out == 2 ? 0u : (uint32_t)nr;
            float u0 = uniform(key, d0), u1 = uniform(key, d0 + 1);
            x = mean + expf(ls) * (sqrtf(-2.0f * logf(u0)) * cosf(6.28318530717958647692f * u1));
          } else if (C_out != 2) {
            float u = uniform(key, (uint32_t)nr);
            x = mean + expf(ls) * (logf(u) - logf(1.0f - u));
          }
        }
        x = fminf(fmaxf(x, -1.0f), 1.0f);
        static_cast<float*>(p.out)[b * p.out_sb + j] = x;
        xc[warp * C_in] = x;
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < BT * C_in; e += kThreads) {
    int b = base + e / C_in;
    if (b < p.B) p.x_cur[(long long)b * C_in + e % C_in] = xc[e];
  }
}

template <typename W, int BT>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int Kin = p.k * p.R + p.cin;
  size_t floats = (size_t)BT * (8 * kThreads + Kin + p.G / 2 + p.R + 2 * p.S + p.C_out + p.C_in);
  size_t bytes = floats * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        generate_kernel<W, BT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((p.B + BT - 1) / BT);
  generate_kernel<W, BT><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename W>
cudaError_t dispatch_bt(const Params& p, int bt, cudaStream_t stream) {
  switch (bt) {
    case 1: return launch<W, 1>(p, stream);
    case 2: return launch<W, 2>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int wn_generate(
    const void* w_first, const void* b_first, const void* w_in, const void* b_in,
    const void* w_og, const void* b_og, const void* w_h1, const void* b_h1,
    const void* w_h2, const void* b_h2, const void* cond, long long cond_sb,
    const void* g_gate, void* ring, void* x_cur, void* out, long long out_sb,
    int B, int n, int t0, unsigned int seed, int L, int lps, int k, int R, int G,
    int S, int C_in, int C_out, int cin, int head, int deterministic, int bf16,
    int bt, void* stream) {
  Params p;
  p.w_first = w_first; p.b_first = static_cast<const float*>(b_first);
  p.w_in = w_in; p.b_in = static_cast<const float*>(b_in);
  p.w_og = w_og; p.b_og = static_cast<const float*>(b_og);
  p.w_h1 = w_h1; p.b_h1 = static_cast<const float*>(b_h1);
  p.w_h2 = w_h2; p.b_h2 = static_cast<const float*>(b_h2);
  p.cond = cond; p.cond_sb = cond_sb;
  p.g_gate = static_cast<const float*>(g_gate);
  p.ring = ring; p.x_cur = static_cast<float*>(x_cur);
  p.out = out; p.out_sb = out_sb;
  p.B = B; p.n = n; p.t0 = t0; p.seed = seed;
  p.L = L; p.lps = lps; p.k = k; p.R = R; p.G = G; p.S = S;
  p.C_in = C_in; p.C_out = C_out; p.cin = cin;
  p.head = head; p.deterministic = deterministic;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? (int)dispatch_bt<__nv_bfloat16>(p, bt, s) : (int)dispatch_bt<float>(p, bt, s);
}
