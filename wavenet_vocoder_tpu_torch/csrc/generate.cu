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
// What bounds it on an H100: across streams a step is a (B x K) @ (K x N)
// product per layer (flagship: 1.87 GFLOP a step at B=256 against 7.3 MB of
// bf16 weights), so the card's bound is its tensor-core rate. But a step is a
// chain of 2*L+3 dependent products (51 at the flagship), each a few hundred
// KFLOP and each followed by an exchange between SMs: what a launch really
// waits for is the length of the instruction stream along that chain (a CTA
// runs 8 warps, so every dependent instruction costs its full latency) and
// the SM-to-SM latency, not bytes or operations. The TPU kernel kept all
// weights in VMEM; one SM's 227 KB of shared memory cannot hold 7.3 MB, so the
// weights have to be shared out.
//
// What this design does about it:
//   * A thread-block cluster of CS CTAs (CS in 1, 2, 4, 8, the portable
//     sizes) owns up to 16 streams and splits the output columns of every
//     product: CTA r holds gate channels [r*Gq, (r+1)*Gq) of each w_in[l]
//     (both GLU halves of them), residual and skip channels [r*Rq, ...) and
//     [r*Sq, ...) of each w_og[l], and the matching columns of the head's
//     first 1x1. Each CTA so pulls 1/CS of the weights a step, and the weights
//     are read once per 16 streams instead of once per 1 or 2. Clusters never
//     talk to each other, so a grid larger than the card runs in waves.
//   * 16 streams are the M=16 tile of mma.sync.aligned.m16n8k16 (bf16 in, f32
//     out); wgmma needs M=64, which 16 streams a cluster do not fill. The
//     deep product (w_in) is cut into kSplitIn parts of its k-steps, a warp per
//     part and pair of n-tiles; the parts leave their partial sums in shared
//     memory and one thread per output adds them in a fixed order, then runs
//     bias, gate and GLU. The shallow products (w_og, the head) take a warp
//     per n-tile, and bias, residual or skip sum and the send run in the
//     registers that hold the sums. The order of every sum depends on the
//     product's depth alone, so a stream's result does not depend on which
//     streams share its cluster, on the threads, or (where no channel needs
//     padding) on the cluster size. f32 packs take the same structure with
//     FP32 FMAs, a thread per output (TF32 would lose the whole-run agreement
//     with the plain version).
//   * Activations cross the cluster through distributed shared memory: after
//     the GLU each CTA sends its slice of `gated` into every CTA's buffer,
//     after w_og its slice of the new residual (the next layer's newest tap),
//     with st.async, which counts the bytes on an mbarrier of the receiving
//     CTA; the receiver waits on its own mbarrier. There is no cluster-wide
//     barrier inside a layer: a buffer is free for the next round because a
//     sender only gets there after it has received what the reader sent
//     after reading. Skip sums stay local to the CTA that owns the columns
//     and are gathered once for the head. The head's second 1x1 and the
//     sampler run redundantly in every CTA with the same hash, so the sample
//     needs no broadcast.
//   * What does not depend on the current step is fetched ahead. The weights
//     are repacked once per pack (ops/cuda_generate.py::kernel_pack) so that
//     a CTA's slice of a layer is one contiguous block in mma fragment order;
//     one thread brings it into a ring of shared-memory stages with
//     cp.async.bulk + mbarrier, as many layers ahead as fit (all layers stay
//     resident when they fit), the w_in slice and the rest of a block each
//     as soon as the stage's last reader is past it. Shapes that leave no
//     room for two stages read the fragments from global memory instead. A
//     layer's biases travel in the same block. The older taps of layer l+2
//     are loaded from the global ring while layer l runs, those of the next
//     step's first two layers and its conditioning row while the head runs.
//   * Ring buffers (rows, B, R) and the current input (B, C_in) live in global
//     memory, allocated by the caller, so state survives between launches.
//     R is a multiple of 8 (rows move 8 channels a vector): the wrapper runs
//     a narrower model on a ring padded with zero channels.
//     A CTA writes its own columns of a ring row only after every peer has
//     consumed the row it evicts (read-before-write; the peers' sends that
//     the writer waited for come after their reads). Peers read the new row
//     one or more steps later: one release/acquire cluster barrier per step,
//     whose arrive and wait bracket the head, orders a step's ring writes
//     before the next step's reads, which bypass L1 (ld.global.cg).
//   * Random numbers come from a counter-based hash of (seed, stream, absolute
//     step, draw index): results do not depend on the cluster shape or on
//     launch boundaries, and the plain PyTorch version in
//     ops/cuda_generate.py computes the same bits with int64 tensor ops.
//
// Numerics: products accumulate in f32; inputs of every product are rounded to
// the pack dtype first (as the JAX kernel's .astype before each jnp.dot); GLU,
// skips and heads run in f32. f32 packs use tanh(a)*sigmoid(b); bf16 packs use
// the one-divide exp form (e^{2a}-1)/((e^{2a}+1)(1+e^{-b})) of the JAX bf16
// production kernel. log_scale_min is not applied (as in the JAX kernel).
//
// -DWN_NO_PRODUCTS compiles the products out (barriers, gathers, prefetches
// and the sampler stay): a timing aid, its results mean nothing. -DWN_TRACE
// makes thread 0 of CTA 0 stamp the clock through the last step of a launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cgr = cooperative_groups;

namespace {

constexpr int kRows = 16;          // streams a cluster owns: the rows of an mma tile
constexpr int kThreads = 256;      // most threads per CTA
constexpr int kSplitIn = 2;        // parts the depth of the w_in product is cut into (bf16)
constexpr int kTapPre = 2;         // 8-element tap vectors a thread loads ahead
constexpr size_t kSmemLimit = 232448;

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

// ---------------------------------------------------------------- PTX helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// bytes (a multiple of 16) from global to this CTA's shared memory; completion
// is counted on the mbarrier. Issued by one thread.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, size_t bytes,
                                          uint64_t* bar) {
  mbar_expect_tx(bar, (uint32_t)bytes);
  const char* s = static_cast<const char*>(src);
  char* d = static_cast<char*>(dst);
  for (size_t at = 0; at < bytes; at += 32768) {
    const uint32_t part = (uint32_t)(bytes - at < 32768 ? bytes - at : 32768);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_u32(d + at)), "l"(s + at), "r"(part), "r"(smem_u32(bar))
        : "memory");
  }
}
// release/acquire barrier over all threads of the cluster, in two halves
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the address of this CTA's shared-memory address `addr` in CTA `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
// store into a CTA of the cluster; the bytes are counted on that CTA's mbarrier
__device__ __forceinline__ void st_async(uint32_t addr, uint32_t v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(
                   addr),
               "r"(v), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void st_async(uint32_t addr, uint32_t v0, uint32_t v1, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];\n" ::"r"(
          addr),
      "r"(v0), "r"(v1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ------------------------------------------------------------------- products
// x: 16 rows of K values (row stride xs) in shared memory, already in the
// pack dtype; K % 16 == 0. w: this CTA's K x N slice (N % 8 == 0), in shared
// or global memory.

// bf16: w in mma fragment order, [k-step][n-tile][lane][4], lane (g = lane / 4,
// t = lane % 4) holding w[16 ks + 2t + {0, 1, 8, 9}][8 nt + g]. One warp runs
// k-steps ks0, ks0 + stride, ... for NTL n-tiles (nt[i]); lane (g, t) ends up
// with acc[i] = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)} of tile nt[i].
// Two accumulators per tile take the k-steps in turns (the mma's latency is
// what a chain waits for) and are added at the end.
template <int NTL>
__device__ __forceinline__ void mma_chain(const __nv_bfloat16* w, int K, int N, int ks0,
                                          int stride, const int* nt, const __nv_bfloat16* x,
                                          int xs, float (*acc)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float odd[NTL][4];
#pragma unroll
  for (int i = 0; i < NTL; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[i][v] = odd[i][v] = 0.0f;
#ifndef WN_NO_PRODUCTS
  const int KS = K >> 4, per = (N >> 3) * 32;   // uint2s per k-step
  const __nv_bfloat16* xp = x + g * xs + 2 * t + ks0 * 16;
  const uint2* wp = reinterpret_cast<const uint2*>(w) + lane + (size_t)ks0 * per;
  int ks = ks0;
#pragma unroll 2
  for (; ks + stride < KS; ks += 2 * stride, xp += 32 * stride, wp += 2 * stride * per) {
    const __nv_bfloat16* xq = xp + 16 * stride;
    const uint32_t a0 = *reinterpret_cast<const uint32_t*>(xp);
    const uint32_t a1 = *reinterpret_cast<const uint32_t*>(xp + 8 * xs);
    const uint32_t a2 = *reinterpret_cast<const uint32_t*>(xp + 8);
    const uint32_t a3 = *reinterpret_cast<const uint32_t*>(xp + 8 * xs + 8);
    const uint32_t c0 = *reinterpret_cast<const uint32_t*>(xq);
    const uint32_t c1 = *reinterpret_cast<const uint32_t*>(xq + 8 * xs);
    const uint32_t c2 = *reinterpret_cast<const uint32_t*>(xq + 8);
    const uint32_t c3 = *reinterpret_cast<const uint32_t*>(xq + 8 * xs + 8);
#pragma unroll
    for (int i = 0; i < NTL; ++i) {
      const uint2 b = wp[nt[i] * 32], d = wp[nt[i] * 32 + stride * per];
      mma_bf16(acc[i], a0, a1, a2, a3, b.x, b.y);
      mma_bf16(odd[i], c0, c1, c2, c3, d.x, d.y);
    }
  }
  if (ks < KS) {
    const uint32_t a0 = *reinterpret_cast<const uint32_t*>(xp);
    const uint32_t a1 = *reinterpret_cast<const uint32_t*>(xp + 8 * xs);
    const uint32_t a2 = *reinterpret_cast<const uint32_t*>(xp + 8);
    const uint32_t a3 = *reinterpret_cast<const uint32_t*>(xp + 8 * xs + 8);
#pragma unroll
    for (int i = 0; i < NTL; ++i) {
      const uint2 b = wp[nt[i] * 32];
      mma_bf16(acc[i], a0, a1, a2, a3, b.x, b.y);
    }
  }
#pragma unroll
  for (int i = 0; i < NTL; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[i][v] += odd[i][v];
#endif
}

// f32: w row-major; one thread runs the whole depth for one row and NCOL
// columns (col[i]).
template <int NCOL>
__device__ __forceinline__ void fma_chain(const float* w, int K, int N, const int* col,
                                          const float* xrow, float* acc) {
#pragma unroll
  for (int i = 0; i < NCOL; ++i) acc[i] = 0.0f;
#ifndef WN_NO_PRODUCTS
  for (int k = 0; k < K; ++k) {
    const float xv = xrow[k];
#pragma unroll
    for (int i = 0; i < NCOL; ++i) acc[i] += xv * w[(size_t)k * N + col[i]];
  }
#endif
}

// e = start, start + step, ... as (row, col) = (e / n, e % n), dividing once
struct Walk {
  int row, col, drow, dcol, n;
  __device__ __forceinline__ Walk(int start, int step, int n_)
      : row(start / n_), col(start % n_), drow(step / n_), dcol(step % n_), n(n_) {}
  __device__ __forceinline__ void next() {
    row += drow;
    col += dcol;
    if (col >= n) { col -= n; ++row; }
  }
};

// Sends into the shared memory of every CTA of the cluster (this one too),
// counted in bytes on that CTA's mbarrier `bar`.
// f32: one value to element `at` of buf.
__device__ __forceinline__ void send(int CS, float* buf, int at, float v, uint64_t* bar) {
  const uint32_t a = smem_u32(buf + at), b = smem_u32(bar);
  for (int peer = 0; peer < CS; ++peer)
    st_async(map_rank(a, peer), __float_as_uint(v), map_rank(b, peer));
}
// bf16, by a whole warp, one value a lane: lane i holds element `at` of buf
// with at % 4 == i % 4, and the four lanes of a group hold four neighbours;
// the four go out as one 8-byte store, lane i % 4 serving the ranks i % 4,
// i % 4 + 4, ...
__device__ __forceinline__ void send(int CS, __nv_bfloat16* buf, int at, float v, uint64_t* bar) {
  const int lane = threadIdx.x & 31;
  const float other = __shfl_xor_sync(0xffffffffu, v, 1);
  const __nv_bfloat162 pair =
      (lane & 1) ? __floats2bfloat162_rn(other, v) : __floats2bfloat162_rn(v, other);
  const uint32_t mine = *reinterpret_cast<const uint32_t*>(&pair);
  const uint32_t theirs = __shfl_xor_sync(0xffffffffu, mine, 2);
  const uint32_t v0 = (lane & 2) ? theirs : mine, v1 = (lane & 2) ? mine : theirs;
  const uint32_t a = smem_u32(buf + (at & ~3)), b = smem_u32(bar);
  for (int peer = lane & 3; peer < CS; peer += 4)
    st_async(map_rank(a, peer), v0, v1, map_rank(b, peer));
}
// bf16, by a whole warp: the warp's accumulator tile v (mma_chain's layout),
// rounded, to columns [col0, col0 + 8) of the 16 rows of buf (row stride bs;
// col0 % 8 == 0). Lanes t and t ^ 1 put their column pairs together; each
// then sends both its rows' 8-byte groups, the even t to the even ranks.
__device__ __forceinline__ void send_tile(int CS, __nv_bfloat16* buf, int bs, int col0,
                                          const float* v, uint64_t* bar) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const __nv_bfloat162 p0 = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 p1 = __floats2bfloat162_rn(v[2], v[3]);
  const uint32_t lo = *reinterpret_cast<const uint32_t*>(&p0);   // row g
  const uint32_t hi = *reinterpret_cast<const uint32_t*>(&p1);   // row g + 8
  const uint32_t lo_o = __shfl_xor_sync(0xffffffffu, lo, 1);
  const uint32_t hi_o = __shfl_xor_sync(0xffffffffu, hi, 1);
  const bool odd = t & 1;
  const int c4 = col0 + 4 * (t >> 1);
  const uint32_t a_lo = smem_u32(buf + g * bs + c4), a_hi = smem_u32(buf + (g + 8) * bs + c4);
  const uint32_t b = smem_u32(bar);
  for (int peer = odd; peer < CS; peer += 2) {
    const uint32_t pb = map_rank(b, peer);
    st_async(map_rank(a_lo, peer), odd ? lo_o : lo, odd ? lo : lo_o, pb);
    st_async(map_rank(a_hi, peer), odd ? hi_o : hi, odd ? hi : hi_o, pb);
  }
}

// 8 consecutive values of the pack dtype, loaded past L1
template <typename W> struct Vec8;
template <> struct Vec8<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void zero() { u = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = __ldcg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void store(__nv_bfloat16* p) const {
    *reinterpret_cast<uint4*>(p) = u;
  }
};
template <> struct Vec8<float> {
  float4 a, b;
  __device__ __forceinline__ void zero() { a = b = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ void load(const float* p) {
    a = __ldcg(reinterpret_cast<const float4*>(p));
    b = __ldcg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void store(float* p) const {
    reinterpret_cast<float4*>(p)[0] = a;
    reinterpret_cast<float4*>(p)[1] = b;
  }
};

struct Params {
  const void* w_first; const float* b_first;  // (C_in, R), (R); R the ring's width
  // (CS, L, stage_bytes): per CTA and layer [w_in slice | w_og slice | b_in | b_og]
  const unsigned char* wl;
  // (CS, head_bytes): per CTA [w_h1 slice | w_h2 | b_h1 slice | b_h2]
  const unsigned char* wh;
  const void* cond; long long cond_sb;        // step j of stream b: cond + b*cond_sb + j*cin
  const float* g_gate;                        // (L, B, G) or null
  void* ring;                                 // (rows, B, R), pack dtype
  float* x_cur;                               // (B, C_in)
  void* out; long long out_sb;                // step j of stream b: out + b*out_sb + j
  long long* trace;                           // clock stamps of the last step (WN_TRACE), or null
  int B, n, t0;
  uint32_t seed;
  int L, lps, k, R, G, S, C_in, C_out, cin;
  int head;           // 0 categorical, 1 logistic mixture, 2 normal
  int deterministic;
  // the kernel-side pack's plan (ops/cuda_generate.py::KernelPack)
  int CS, spc;        // CTAs per cluster, streams per cluster
  int Gq, Rq, Sq;     // gate, residual, skip channels a CTA owns (multiples of 8)
  int Kin, Kog, Ksk;  // padded depths of w_in, w_og and the head products (% 16)
  int Cp;             // C_out padded to 8
  int xs, gs, ss;     // row strides of the [taps | cond], gated and head buffers
  int stage_bytes, head_bytes;
  // chosen at launch
  int nstage;         // layer blocks held in shared memory (0: read from global)
  int head_res;       // the head's block held in shared memory
};

__host__ __device__ inline size_t up128(size_t b) { return (b + 127) / 128 * 128; }

// byte offsets into dynamic shared memory
struct Layout {
  size_t stage_stride, headw, xin, gt, hx, o1, part, hbf, sk, lo, xc, first, code, ltab, bars, total;
};
template <typename W> __host__ __device__ inline Layout make_layout(const Params& p) {
  const size_t M = kRows;
  Layout y;
  size_t o = 0;
  y.stage_stride = up128((size_t)p.stage_bytes);
  o += (size_t)p.nstage * y.stage_stride;
  y.headw = o; o += p.head_res ? up128((size_t)p.head_bytes) : 0;
  y.xin = o;  o += up128(2 * M * p.xs * sizeof(W));
  y.gt = o;   o += up128(M * p.gs * sizeof(W));
  y.hx = o;   o += up128(M * p.ss * sizeof(W));
  y.o1 = o;   o += up128(M * p.ss * sizeof(W));
  // bf16: the kSplitIn partial sums of the w_in product, [part][tile][lane][4]
  y.part = o; o += sizeof(W) == 2 ? up128(kSplitIn * M * 2 * p.Gq * 4) : 0;
  y.hbf = o;  o += up128(M * p.Rq * 4);
  y.sk = o;   o += up128(M * p.Sq * 4);
  y.lo = o;   o += up128(M * p.Cp * 4);
  y.xc = o;   o += up128(M * p.C_in * 4);
  y.first = o; o += up128(2 * (size_t)p.CS * p.Rq * 4);
  y.code = o; o += up128(M * 4);
  y.ltab = o; o += up128((size_t)p.L * 16);
  y.bars = o; o += up128((size_t)(2 * p.nstage + 5) * 8);
  y.total = o;
  return y;
}

#ifdef WN_TRACE
#define WN_STAMP(i) \
  if (p.trace != nullptr && threadIdx.x == 0 && blockIdx.x == 0 && j == p.n - 1) \
    p.trace[i] = clock64()
#else
#define WN_STAMP(i)
#endif

template <typename W>
__global__ void __launch_bounds__(kThreads, 1) generate_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int M = kRows;
  constexpr bool kBf16 = !std::is_same<W, float>::value;
  cgr::cluster_group cluster = cgr::this_cluster();
  const Layout lay = make_layout<W>(p);
  unsigned char* stages = smem;
  W* xin = reinterpret_cast<W*>(smem + lay.xin);    // 2 x M x xs: [taps | cond], by layer parity
  W* gt = reinterpret_cast<W*>(smem + lay.gt);      // M x gs: gated, all CTAs' slices
  W* hx = reinterpret_cast<W*>(smem + lay.hx);      // M x ss: head input
  W* o1 = reinterpret_cast<W*>(smem + lay.o1);      // M x ss: head hidden
  float* part = reinterpret_cast<float*>(smem + lay.part);
  float* hbf = reinterpret_cast<float*>(smem + lay.hbf);  // M x Rq: own residual columns, f32
  float* sk = reinterpret_cast<float*>(smem + lay.sk);    // M x Sq: own skip sums
  float* lo = reinterpret_cast<float*>(smem + lay.lo);    // M x Cp: head output
  float* xc = reinterpret_cast<float*>(smem + lay.xc);    // M x C_in: current input
  // the first conv's bias and, for a scalar input, its one row of weights
  float* first_b = reinterpret_cast<float*>(smem + lay.first);
  float* first_w = first_b + p.CS * p.Rq;
  int* code = reinterpret_cast<int*>(smem + lay.code);    // last emitted class per stream
  int* l_off = reinterpret_cast<int*>(smem + lay.ltab);   // per layer: first ring row,
  int* l_dil = l_off + p.L;                               //   dilation,
  int* l_mods = l_dil + p.L;   //   t mod ((k - 1) * dilation), for even and odd steps j
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  // bars[2 s], bars[2 s + 1]: stage s holds its w_in slice; the rest of its block
  uint64_t* bar_head = bars + 2 * p.nstage;   // the head's weights have landed
  uint64_t* bar_x = bar_head + 1;    // all slices of a layer's newest tap have landed
  uint64_t* bar_g = bar_head + 2;    // ... of gated
  uint64_t* bar_hx = bar_head + 3;   // ... of the head's input
  uint64_t* bar_o1 = bar_head + 4;   // ... of the head's hidden layer

  // A CTA runs few warps and a step is one long chain, so a step's time is
  // the length of the instruction stream along it: index arithmetic is hoisted
  // out of the step loop (Walk, the tap tables), nothing in a layer divides,
  // and every product's bias, activation and send run in the registers of
  // the thread that holds the sum.
  const int tid = threadIdx.x, nthr = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int NW = nthr >> 5, g = lane >> 2, t4 = lane & 3;
  const int CS = p.CS, rank = (int)cluster.block_rank();
  const int base = (blockIdx.x / CS) * p.spc;
  const int nvalid = min(p.spc, p.B - base);
  const int L = p.L, R = p.R, G = p.G, G2 = p.G / 2;
  const int k = p.k, cin = p.cin, C_in = p.C_in, C_out = p.C_out;
  const int Gq = p.Gq, Rq = p.Rq, Sq = p.Sq, Rp = CS * Rq, Cp = p.Cp;
  const int xs = p.xs, gs = p.gs, ss = p.ss;
  const int NA = 2 * Gq, NB = Rq + Sq;
  const W* w_first = static_cast<const W*>(p.w_first);
  const unsigned char* wl = p.wl + (size_t)rank * L * p.stage_bytes;
  const unsigned char* wh = p.wh + (size_t)rank * p.head_bytes;
  const size_t win_bytes = (size_t)p.Kin * NA * sizeof(W);
  const size_t wog_bytes = (size_t)p.Kog * NB * sizeof(W);
  const size_t wh1_bytes = (size_t)p.Ksk * Sq * sizeof(W);
  const size_t wh2_bytes = (size_t)p.Ksk * Cp * sizeof(W);
  const W* cond = static_cast<const W*>(p.cond);
  W* ring = static_cast<W*>(p.ring);
  const size_t ring_row = (size_t)p.B * R;
  const float sqrt_half = 0.70710678118654752440f;
  const float sqrt_inv_L = (float)sqrt(1.0 / (double)L);
  const bool resident = p.nstage >= L;
  const long long total_layers = (long long)p.n * L;
  // bytes a CTA receives per round of each exchange (every CTA's slice, its own too)
  const uint32_t x_bytes = (uint32_t)(M * Rp * sizeof(W));
  const uint32_t g_bytes = (uint32_t)(M * CS * Gq * sizeof(W));
  const uint32_t s_bytes = (uint32_t)(M * CS * Sq * sizeof(W));
  uint32_t x_round = 0, g_round = 0, h_round = 0;   // rounds waited for so far
  const Walk walk_p(tid, nthr, Rp);
  // a thread's outputs (row, col) of each product
  const Walk walk_g(tid, nthr, Gq), walk_b(tid, nthr, NB), walk_s(tid, nthr, Sq);
  const Walk walk_c(tid, nthr, Cp);
  // bf16: a warp's items of the w_in product, (part of the k-steps, pair of
  // n-tiles: 8 gate channels' a and b half)
  const int pairs = Gq >> 3;
  const Walk walk_w(warp, NW, pairs);

  // zero every activation buffer (padding columns and unused rows stay zero)
  {
    uint32_t* z = reinterpret_cast<uint32_t*>(smem + lay.xin);
    const int words = (int)((lay.bars - lay.xin) / 4);
    for (int e = tid; e < words; e += nthr) z[e] = 0u;
  }
  if (tid == 0) {
    for (int s = 0; s < 2 * p.nstage + 5; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  for (int e = tid; e < M * C_in; e += nthr) {
    const int bi = e / C_in;
    if (bi < nvalid) xc[e] = p.x_cur[(size_t)(base + bi) * C_in + e % C_in];
  }
  for (int ch = tid; ch < R; ch += nthr) {
    first_b[ch] = p.b_first[ch];
    first_w[ch] = to_f(w_first[ch]);
  }
  if (tid == 0) {
    int off = 0;
    for (int l = 0; l < L; ++l) {
      l_off[l] = off;
      l_dil[l] = 1 << (l % p.lps);
      off += (k - 1) * l_dil[l];
    }
  }
  // The ring of weight blocks, filled in two parts so that each part is on
  // its way again as soon as it is read out: part 0 the w_in slice, part 1
  // the rest. The next block of part h goes to stage fill_slot[h].
  long long issued[2] = {0, 0};
  int fill_slot[2] = {0, 0}, fill_layer[2] = {0, 0};
  // The last warp has the fewest products to run: its first lane fills.
  const bool filler = tid == nthr - 32;
  auto fill = [&](int h) {   // the filler only
    const size_t at = h ? win_bytes : 0, bytes = h ? p.stage_bytes - win_bytes : win_bytes;
    bulk_load(stages + fill_slot[h] * lay.stage_stride + at,
              wl + (size_t)fill_layer[h] * p.stage_bytes + at, bytes, &bars[2 * fill_slot[h] + h]);
    ++issued[h];
    if (++fill_slot[h] == p.nstage) fill_slot[h] = 0;
    if (++fill_layer[h] == L) fill_layer[h] = 0;
  };
  const bool refill = p.nstage > 0 && !resident;
  if (filler) {
    if (p.head_res) bulk_load(smem + lay.headw, wh, (size_t)p.head_bytes, bar_head);
    for (int h = 0; h < 2; ++h)
      while (issued[h] < p.nstage && issued[h] < total_layers) fill(h);
  }
  if (tid == 0) {
    // the first round of every exchange
    mbar_expect_tx(bar_x, x_bytes);
    mbar_expect_tx(bar_g, g_bytes);
    mbar_expect_tx(bar_hx, s_bytes);
    mbar_expect_tx(bar_o1, s_bytes);
  }
  int use_slot = 0;            // the stage the next layer reads,
  uint32_t use_parity = 0;     //   and how often the ring has wrapped (mod 2)
  // no CTA sends into a peer before the peer has cleared its buffers and
  // set up its mbarriers
  cluster_arrive();
  cluster_wait();

  // The older taps of a layer from the global ring: vector v = tid + u * nthr
  // is 8 channels of one tap of one stream. Where it comes from in a ring row
  // and where it goes in a [taps | cond] buffer does not change: tables.
  const int VR = R / 8, NV = M * (k - 1) * VR;
  int tap_dst[kTapPre], tap_from[kTapPre], tap_back[kTapPre];   // tap_back: dilations back
  auto tap_place = [&](int v, int* dst, int* from, int* back) {
    const int bi = v / ((k - 1) * VR), rem = v % ((k - 1) * VR);
    const int tap = rem / VR, c8 = rem % VR;
    *dst = bi * xs + tap * Rp + c8 * 8;
    *from = bi < nvalid ? (base + bi) * R + c8 * 8 : -1;
    *back = k - 1 - tap;
  };
#pragma unroll
  for (int u = 0; u < kTapPre; ++u) {
    tap_dst[u] = tap_from[u] = -1;
    tap_back[u] = 0;
    if (tid + u * nthr < NV) tap_place(tid + u * nthr, &tap_dst[u], &tap_from[u], &tap_back[u]);
  }
  // row of the tap `back` dilations before step t: tm = t mod ((k - 1) * d)
  auto tap_row = [&](int off, int d, int tm, int back) {
    int i = tm - back * d;
    if (i < 0) i += (k - 1) * d;
    return off + i;
  };
  auto taps_load = [&](Vec8<W>* pre, int off, int d, int tm) {
#pragma unroll
    for (int u = 0; u < kTapPre; ++u) {
      if (tap_from[u] >= 0)
        pre[u].load(ring + tap_row(off, d, tm, tap_back[u]) * ring_row + tap_from[u]);
      else
        pre[u].zero();
    }
  };
  auto taps_store = [&](const Vec8<W>* pre, int off, int d, int tm, W* xb) {
#pragma unroll
    for (int u = 0; u < kTapPre; ++u)
      if (tap_dst[u] >= 0) pre[u].store(xb + tap_dst[u]);
    for (int v = tid + kTapPre * nthr; v < NV; v += nthr) {   // what was not loaded ahead
      int dst, from, back;
      tap_place(v, &dst, &from, &back);
      Vec8<W> x;
      if (from >= 0) x.load(ring + tap_row(off, d, tm, back) * ring_row + from); else x.zero();
      x.store(xb + dst);
    }
  };
  // the conditioning row of step j: 8 values a vector where the layout allows
  const bool cond_vec = cin > 0 && cin % 8 == 0 && p.cond_sb % 8 == 0 &&
                        reinterpret_cast<uintptr_t>(p.cond) % 16 == 0;
  const int VC = cin / 8;
  const int cond_bi = cond_vec ? tid / VC : 0, cond_c8 = cond_vec ? tid % VC : 0;
  auto cond_load = [&](Vec8<W>* pre, int j) {
    if (cond_vec && tid < M * VC) {
      if (cond_bi < nvalid)
        pre->load(cond + (size_t)(base + cond_bi) * p.cond_sb + (size_t)j * cin + cond_c8 * 8);
      else
        pre->zero();
    }
  };
  auto cond_store = [&](const Vec8<W>* pre, int j) {
    if (cond_vec) {
      if (tid < M * VC) {
        pre->store(xin + cond_bi * xs + k * Rp + cond_c8 * 8);
        pre->store(xin + (M + cond_bi) * xs + k * Rp + cond_c8 * 8);
      }
      for (int v = tid + nthr; v < M * VC; v += nthr) {   // what was not loaded ahead
        const int bi = v / VC, c8 = v % VC;
        Vec8<W> x;
        if (bi < nvalid)
          x.load(cond + (size_t)(base + bi) * p.cond_sb + (size_t)j * cin + c8 * 8);
        else
          x.zero();
        x.store(xin + bi * xs + k * Rp + c8 * 8);
        x.store(xin + (M + bi) * xs + k * Rp + c8 * 8);
      }
    } else {
      for (int e = tid; e < M * cin; e += nthr) {
        const int bi = e / cin, i = e % cin;
        if (bi < nvalid) {
          const W cv = cond[(size_t)(base + bi) * p.cond_sb + (size_t)j * cin + i];
          xin[bi * xs + k * Rp + i] = cv;
          xin[(M + bi) * xs + k * Rp + i] = cv;
        }
      }
    }
  };
  auto set_mods = [&](int j) {   // the table of step j
    for (int l = tid; l < L; l += nthr)
      l_mods[(j & 1) * L + l] = (p.t0 + j) % ((k - 1) * l_dil[l]);
  };

  // what the first step's first two layers need that is known already
  set_mods(0);
  __syncthreads();
  Vec8<W> pre0[kTapPre], pre1[kTapPre], prec;
  taps_load(pre0, 0, 1, l_mods[0]);
  if (L > 1) taps_load(pre1, l_off[1], l_dil[1], l_mods[1]);
  cond_load(&prec, 0);

  for (int j = 0; j < p.n; ++j) {
    const int t = p.t0 + j;
    const int* l_mod = l_mods + (j & 1) * L;
    WN_STAMP(0);

    // ---- step start: first 1x1 conv (all columns, every CTA); the first two
    // layers' older taps and this step's conditioning row, loaded ahead
    {
      Walk w = walk_p;
      for (int e = tid; e < M * Rp; e += nthr, w.next()) {
        const int bi = w.row, ch = w.col;
        float v = 0.0f;
        if (ch < R) {
          if (p.head == 0 && j > 0) {   // one-hot input: a row lookup
            if (code[bi] < C_in) v = to_f(w_first[(size_t)code[bi] * R + ch]);
          } else if (C_in == 1) {
            v = rnd<W>(xc[bi]) * first_w[ch];
          } else {
            for (int i = 0; i < C_in; ++i) {
              const float xv = xc[bi * C_in + i];
              if (xv != 0.0f) v += rnd<W>(xv) * to_f(w_first[(size_t)i * R + ch]);
            }
          }
          v += first_b[ch];
        }
        xin[bi * xs + (k - 1) * Rp + ch] = from_f<W>(v);
        const int c = ch - rank * Rq;
        if (c >= 0 && c < Rq) hbf[bi * Rq + c] = v;
      }
    }
    for (int e = tid; e < M * Sq; e += nthr) sk[e] = 0.0f;
    taps_store(pre0, 0, 1, l_mod[0], xin);
    if (L > 1) taps_store(pre1, l_off[1], l_dil[1], l_mod[1], xin + M * xs);
    cond_store(&prec, j);
    __syncthreads();
    WN_STAMP(1);

    for (int l = 0; l < L; ++l) {
      const bool last = l + 1 == L;
      W* xb = xin + (l & 1) * M * xs;          // this layer's [taps | cond]
      W* xn = xin + ((l + 1) & 1) * M * xs;    // the next layer's

      // this layer's block of weights and biases
      const unsigned char* wst = wl + (size_t)l * p.stage_bytes;
      if (p.nstage > 0) {
        const uint32_t parity = resident ? 0u : use_parity;
        mbar_wait(&bars[2 * use_slot], parity);
        mbar_wait(&bars[2 * use_slot + 1], parity);
        wst = stages + use_slot * lay.stage_stride;
        if (++use_slot == p.nstage) {
          use_slot = 0;
          use_parity ^= 1u;
        }
      }
      const W* w_in = reinterpret_cast<const W*>(wst);
      const W* w_og = reinterpret_cast<const W*>(wst + win_bytes);
      const float* b_in = reinterpret_cast<const float*>(wst + win_bytes + wog_bytes);
      const float* b_og = b_in + NA;
      const float* gg = p.g_gate == nullptr ? nullptr : p.g_gate + ((size_t)l * p.B + base) * G;

      // ---- [taps | cond] @ w_in slice + b_in (+ global gate), GLU; own gate
      // channels go to every CTA. The newest tap came from the cluster (layer
      // 0: from the first conv, above); the older taps of the layer after the
      // next start their way from the global ring.
      if (l > 0) {
        mbar_wait(bar_x, x_round & 1);
        ++x_round;
        if (tid == 0) mbar_expect_tx(bar_x, x_bytes);
      }
      WN_STAMP(2 + 4 * l);
      Vec8<W> pre[kTapPre];
      int off2 = 0, dil2 = 1, mod2 = 0;
      if (l + 2 < L) {
        off2 = l_off[l + 2], dil2 = l_dil[l + 2], mod2 = l_mod[l + 2];
        taps_load(pre, off2, dil2, mod2);
      }
      if constexpr (kBf16) {
        // A warp's item: one pair of n-tiles for one of kSplitIn parts of the
        // k-steps; the partial sums meet in shared memory.
        Walk w = walk_w;
        for (int item = warp; item < pairs * kSplitIn; item += NW, w.next()) {
          const int nt[2] = {w.col, pairs + w.col};
          float acc[2][4];
          mma_chain<2>(w_in, p.Kin, NA, w.row, kSplitIn, nt, xb, xs, acc);
          float4* dst = reinterpret_cast<float4*>(part) + ((w.row * pairs + w.col) * 2) * 32 + lane;
          dst[0] = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
          dst[32] = make_float4(acc[1][0], acc[1][1], acc[1][2], acc[1][3]);
        }
      } else {
        Walk w = walk_g;
        for (int e = tid; e < M * Gq; e += nthr, w.next()) {
          const int row = w.row, qc = w.col, ch = rank * Gq + qc;
          const int col[2] = {qc, Gq + qc};
          float acc[2];
          fma_chain<2>(w_in, p.Kin, NA, col, xb + row * xs, acc);
          float za = acc[0] + b_in[qc], zg = acc[1] + b_in[Gq + qc];
          if (gg != nullptr && ch < G2 && row < nvalid) {
            za += gg[(size_t)row * G + ch];
            zg += gg[(size_t)row * G + G2 + ch];
          }
          send(CS, gt, row * gs + ch, glu<W>(za, zg), bar_g);
        }
      }
      __syncthreads();
      // Every thread is past this layer's w_in slice and, since the layer
      // before, past the rest of that layer's block.
      if (filler && refill) {
        if (issued[0] < total_layers) fill(0);
        if (l > 0 && issued[1] < total_layers) fill(1);
      }
      if constexpr (kBf16) {
        // One gate channel of one stream a thread: its partial sums in
        // order, then bias, gate and GLU; four neighbours share a send.
        Walk w = walk_g;
        for (int e = tid; e < M * Gq; e += nthr, w.next()) {
          const int row = w.row, qc = w.col, ch = rank * Gq + qc;
          // where mma_chain's lane (row % 8, qc % 8 / 2) keeps (row, qc)
          const float* src = part + (qc >> 3) * 256 + ((row & 7) * 4 + ((qc & 7) >> 1)) * 4 +
                             (row >> 3) * 2 + (qc & 1);
          float za = src[0], zg = src[128];
#pragma unroll
          for (int sp = 1; sp < kSplitIn; ++sp) {
            za += src[sp * pairs * 256];
            zg += src[sp * pairs * 256 + 128];
          }
          za += b_in[qc];
          zg += b_in[Gq + qc];
          if (gg != nullptr && ch < G2 && row < nvalid) {
            za += gg[(size_t)row * G + ch];
            zg += gg[(size_t)row * G + G2 + ch];
          }
          send(CS, gt, row * gs + ch, glu<W>(za, zg), bar_g);
        }
      }
      WN_STAMP(3 + 4 * l);

      // ---- gated @ [w_out | w_skip] slice -> own residual and skip columns.
      // Ring rows are written here: every CTA has consumed the rows they evict
      // before it sent the gated slice this CTA waits for. Layer 0 writes its
      // own input of this step, every layer the next one's.
      mbar_wait(bar_g, g_round & 1);
      ++g_round;
      if (tid == 0) mbar_expect_tx(bar_g, g_bytes);
      WN_STAMP(4 + 4 * l);
      W* row0 = ring + (size_t)l_mod[0] * ring_row + (size_t)base * R;
      W* rown = last ? nullptr
                     : ring + (size_t)(l_off[l + 1] + l_mod[l + 1]) * ring_row + (size_t)base * R;
      if constexpr (kBf16) {
        // a warp per n-tile; bias, residual or skip sum and the send run in
        // the registers that hold the sums
        for (int tile = warp; tile < (NB >> 3); tile += NW) {
          const int col0 = tile * 8;
          const bool res = col0 < Rq;
          if (res && last && l != 0) continue;   // the last layer's residual is not used
          float acc[1][4], v[4];
          mma_chain<1>(w_og, p.Kog, NB, 0, 1, &tile, gt, gs, acc);
          if (res) {
            float h0[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int row = g + 8 * (i >> 1), c = col0 + 2 * t4 + (i & 1);
              h0[i] = hbf[row * Rq + c];
              v[i] = (acc[0][i] + b_og[c] + h0[i]) * sqrt_half;
              hbf[row * Rq + c] = v[i];
            }
            const int ch = rank * Rq + col0 + 2 * t4;   // even: a pair of channels per store
#pragma unroll
            for (int i = 0; i < 4; i += 2) {
              const int row = g + 4 * i;
              if (row < nvalid && ch < R) {
                if (l == 0)
                  *reinterpret_cast<__nv_bfloat162*>(row0 + (size_t)row * R + ch) =
                      __floats2bfloat162_rn(h0[i], h0[i + 1]);
                if (!last)
                  *reinterpret_cast<__nv_bfloat162*>(rown + (size_t)row * R + ch) =
                      __floats2bfloat162_rn(v[i], v[i + 1]);
              }
            }
            if (!last) send_tile(CS, xn + (k - 1) * Rp, xs, rank * Rq + col0, v, bar_x);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int row = g + 8 * (i >> 1), c = col0 - Rq + 2 * t4 + (i & 1);
              const float s = sk[row * Sq + c] + acc[0][i] + b_og[Rq + c];
              sk[row * Sq + c] = s;
              v[i] = fmaxf(s * sqrt_inv_L, 0.0f);   // head input: ReLU of the scaled skip sum
            }
            if (last) send_tile(CS, hx, ss, rank * Sq + col0 - Rq, v, bar_hx);
          }
        }
      } else {
        Walk w = walk_b;
        for (int e = tid; e < M * NB; e += nthr, w.next()) {
          const int row = w.row, c = w.col;
          if (c < Rq && last && l != 0) continue;
          float acc[1];
          fma_chain<1>(w_og, p.Kog, NB, &c, gt + row * gs, acc);
          if (c < Rq) {
            const int ch = rank * Rq + c;
            const float h0 = hbf[row * Rq + c];
            const float h1 = (acc[0] + b_og[c] + h0) * sqrt_half;
            hbf[row * Rq + c] = h1;
            if (row < nvalid && ch < R) {
              if (l == 0) row0[(size_t)row * R + ch] = from_f<W>(h0);
              if (!last) rown[(size_t)row * R + ch] = from_f<W>(h1);
            }
            if (!last) send(CS, xn, row * xs + (k - 1) * Rp + ch, h1, bar_x);
          } else {
            const float s = sk[row * Sq + c - Rq] + acc[0] + b_og[c];
            sk[row * Sq + c - Rq] = s;
            if (last)
              send(CS, hx, row * ss + rank * Sq + c - Rq, fmaxf(s * sqrt_inv_L, 0.0f), bar_hx);
          }
        }
      }
      // this layer's buffer was read out before the block barrier above: the
      // older taps of the layer after the next go where its own were
      if (l + 2 < L) taps_store(pre, off2, dil2, mod2, xb);
      WN_STAMP(5 + 4 * l);
    }
    // all of this step's ring writes are issued: the cluster barrier's first half
    cluster_arrive();

    // ---- head: 1x1 (own columns) -> ReLU -> 1x1 (all columns, every CTA)
    const unsigned char* whb = wh;
    if (p.head_res) {
      mbar_wait(bar_head, 0u);
      whb = smem + lay.headw;
    }
    const W* w_h1 = reinterpret_cast<const W*>(whb);
    const W* w_h2 = reinterpret_cast<const W*>(whb + wh1_bytes);
    const float* b_h1 = reinterpret_cast<const float*>(whb + wh1_bytes + wh2_bytes);
    const float* b_h2 = b_h1 + Sq;
    mbar_wait(bar_hx, h_round & 1);
    if (tid == 0) mbar_expect_tx(bar_hx, s_bytes);
    if constexpr (kBf16) {
      for (int tile = warp; tile < (Sq >> 3); tile += NW) {
        float acc[1][4], v[4];
        mma_chain<1>(w_h1, p.Ksk, Sq, 0, 1, &tile, hx, ss, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = fmaxf(acc[0][i] + b_h1[tile * 8 + 2 * t4 + (i & 1)], 0.0f);
        send_tile(CS, o1, ss, rank * Sq + tile * 8, v, bar_o1);
      }
    } else {
      Walk w = walk_s;
      for (int e = tid; e < M * Sq; e += nthr, w.next()) {
        float acc[1];
        fma_chain<1>(w_h1, p.Ksk, Sq, &w.col, hx + w.row * ss, acc);
        send(CS, o1, w.row * ss + rank * Sq + w.col, fmaxf(acc[0] + b_h1[w.col], 0.0f), bar_o1);
      }
    }
    if (j + 1 < p.n) set_mods(j + 1);
    __syncthreads();
    // the rest of the last layer's block is read out too
    if (filler && refill && issued[1] < total_layers) fill(1);
    WN_STAMP(2 + 4 * L);
    // The barrier's second half: every CTA's ring writes of this step are
    // visible. What the next step's first two layers need starts its way.
    cluster_wait();
    if (j + 1 < p.n) {
      const int* next_mod = l_mods + ((j + 1) & 1) * L;
      taps_load(pre0, 0, 1, next_mod[0]);
      if (L > 1) taps_load(pre1, l_off[1], l_dil[1], next_mod[1]);
      cond_load(&prec, j + 1);
    }
    mbar_wait(bar_o1, h_round & 1);
    ++h_round;
    if (tid == 0) mbar_expect_tx(bar_o1, s_bytes);
    if constexpr (kBf16) {
      for (int tile = warp; tile < (Cp >> 3); tile += NW) {
        float acc[1][4];
        mma_chain<1>(w_h2, p.Ksk, Cp, 0, 1, &tile, o1, ss, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = g + 8 * (i >> 1), c = tile * 8 + 2 * t4 + (i & 1);
          lo[row * Cp + c] = acc[0][i] + b_h2[c];
        }
      }
    } else {
      Walk w = walk_c;
      for (int e = tid; e < M * Cp; e += nthr, w.next()) {
        float acc[1];
        fma_chain<1>(w_h2, p.Ksk, Cp, &w.col, o1 + w.row * ss, acc);
        lo[e] = acc[0] + b_h2[w.col];
      }
    }
    __syncthreads();
    WN_STAMP(3 + 4 * L);

    // ---- sampling: a warp per stream, the same in every CTA; rank 0 writes
    for (int bi = warp; bi < nvalid; bi += NW) {
      const int b = base + bi;
      const float* o = lo + bi * Cp;
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
        if (arg >= C_out) arg = C_out - 1;
        if (lane == 0) {
          code[bi] = arg;
          if (rank == 0) static_cast<int*>(p.out)[b * p.out_sb + j] = arg;
        }
        for (int c = lane; c < C_in; c += 32) xc[bi * C_in + c] = c == arg ? 1.0f : 0.0f;
      } else {
        float mean, ls;
        int nr = 1;
        if (C_out == 2) {
          mean = o[0];
          ls = o[1];
        } else {
          // the component: the first maximum of the logits (+ Gumbel noise),
          // a lane per component
          nr = C_out / 3;
          float best = -INFINITY;
          int sel = nr;
          for (int c = lane; c < nr; c += 32) {
            float v = o[c];
            if (!p.deterministic) v -= logf(-logf(uniform(key, (uint32_t)c)));
            if (sel == nr || v > best) { best = v; sel = c; }
          }
          for (int m = 16; m > 0; m >>= 1) {
            float ob = __shfl_xor_sync(0xffffffffu, best, m);
            int os = __shfl_xor_sync(0xffffffffu, sel, m);
            if (os < nr && (sel == nr || ob > best || (ob == best && os < sel))) {
              best = ob;
              sel = os;
            }
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
        if (lane == 0) {
          if (rank == 0) static_cast<float*>(p.out)[b * p.out_sb + j] = x;
          xc[bi * C_in] = x;
        }
      }
    }
    __syncthreads();
    WN_STAMP(4 + 4 * L);
  }

  if (rank == 0)
    for (int e = tid; e < M * C_in; e += nthr) {
      const int bi = e / C_in;
      if (bi < nvalid) p.x_cur[(size_t)(base + bi) * C_in + e % C_in] = xc[e];
    }
  // no CTA leaves while a peer may still send into its shared memory
  cluster_arrive();
  cluster_wait();
}

// info (host, may be null): [stages in shared memory, head weights resident,
// dynamic shared-memory bytes, clusters the card can hold at once]
template <typename W>
cudaError_t launch(Params p, int threads, int max_stages, int* info, cudaStream_t stream) {
  if (threads < 32 || threads > kThreads || threads % 32) return cudaErrorInvalidValue;
  // Shared memory: the activation buffers, then layer blocks. A ring needs
  // two stages; the head's block stays resident too unless that costs the
  // ring its second stage. Without a ring the weights are read from global
  // memory.
  auto fits = [&](int stages, int head_res) {
    p.nstage = stages;
    p.head_res = head_res;
    return make_layout<W>(p).total <= kSmemLimit;
  };
  const int need = p.L < 2 ? p.L : 2;
  const int cap = max_stages >= 0 && max_stages < p.L ? max_stages : p.L;
  int ns = 0, hr = 0;
  for (int h = 1; h >= 0 && ns == 0; --h)
    for (int s = cap; s >= need && s > 0 && ns == 0; --s)
      if (fits(s, h)) ns = s, hr = h;
  if (ns == 0) hr = fits(0, 1);
  p.nstage = ns;
  p.head_res = hr;
  const size_t bytes = make_layout<W>(p).total;
  cudaError_t err = cudaFuncSetAttribute(generate_kernel<W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((p.B + p.spc - 1) / p.spc) * p.CS));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (info != nullptr) {
    info[0] = p.nstage;
    info[1] = p.head_res;
    info[2] = (int)bytes;
    info[3] = -1;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, generate_kernel<W>, &cfg) == cudaSuccess)
      info[3] = clusters;
    else
      (void)cudaGetLastError();
  }
  err = cudaLaunchKernelEx(&cfg, generate_kernel<W>, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// plan: [CS, streams per cluster, threads, max stages (-1: as many as fit),
//        Gq, Rq, Sq, Kin, Kog, Ksk, Cp, xs, gs, ss, stage_bytes, head_bytes]
// (host ints). trace: device buffer of 4 L + 5 clock stamps, or null.
extern "C" int wn_generate(
    const void* w_first, const void* b_first, const void* wl, const void* wh,
    const void* cond, long long cond_sb, const void* g_gate, void* ring, void* x_cur,
    void* out, long long out_sb, int B, int n, int t0, unsigned int seed, int L, int lps,
    int k, int R, int G, int S, int C_in, int C_out, int cin, int head, int deterministic,
    int bf16, const int* plan, int* info, void* trace, void* stream) {
  Params p;
  p.w_first = w_first; p.b_first = static_cast<const float*>(b_first);
  p.wl = static_cast<const unsigned char*>(wl);
  p.wh = static_cast<const unsigned char*>(wh);
  p.cond = cond; p.cond_sb = cond_sb;
  p.g_gate = static_cast<const float*>(g_gate);
  p.ring = ring; p.x_cur = static_cast<float*>(x_cur);
  p.out = out; p.out_sb = out_sb;
  p.trace = static_cast<long long*>(trace);
  p.B = B; p.n = n; p.t0 = t0; p.seed = seed;
  p.L = L; p.lps = lps; p.k = k; p.R = R; p.G = G; p.S = S;
  p.C_in = C_in; p.C_out = C_out; p.cin = cin;
  p.head = head; p.deterministic = deterministic;
  p.CS = plan[0]; p.spc = plan[1];
  const int threads = plan[2], max_stages = plan[3];
  p.Gq = plan[4]; p.Rq = plan[5]; p.Sq = plan[6];
  p.Kin = plan[7]; p.Kog = plan[8]; p.Ksk = plan[9]; p.Cp = plan[10];
  p.xs = plan[11]; p.gs = plan[12]; p.ss = plan[13];
  p.stage_bytes = plan[14]; p.head_bytes = plan[15];
  p.nstage = 0; p.head_res = 0;
  if (p.CS < 1 || p.CS > 8 || (p.CS & (p.CS - 1)) || p.spc < 1 || p.spc > kRows || B < 1 ||
      k < 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? (int)launch<__nv_bfloat16>(p, threads, max_stages, info, s)
              : (int)launch<float>(p, threads, max_stages, info, s);
}
