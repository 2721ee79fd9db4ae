// Fused autoregressive WaveNet generation for Hopper (sm_90a).
//
// Replaces: wavenet_vocoder_tpu/ops/pallas_generate.py::_make_kernel, variant
// "fused" (launched by _pallas_generate_jit through pl.pallas_call). One launch
// runs steps [t0, t0+n) of the whole AR decoder for B streams: first 1x1 conv
// -> per layer, the k dilated taps gathered from the packed ring buffer,
// [older taps | cond | newest tap] @ w_in + b_in (+ global gate), GLU,
// gated @ w_og + b_og ->
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
//     sizes) owns up to 16 streams (32: below) and splits the output columns
//     of every product: CTA r holds gate channels [r*Gq, (r+1)*Gq) of each
//     w_in[l] (both GLU halves of them), residual and skip channels [r*Rq,
//     ...) and [r*Sq, ...) of each w_og[l], and the matching columns of the
//     head's first 1x1. Each CTA so pulls 1/CS of the weights a step, and the
//     weights are read once per 16 streams instead of once per 1 or 2.
//     Clusters never talk to each other, so a grid larger than the card runs
//     in waves.
//   * 16 streams are the M=16 tile of mma.sync.aligned.m16n8k16 (bf16 in, f32
//     out); wgmma needs M=64, which 16 streams a cluster do not fill. The deep
//     product (w_in) is cut into kSplitIn parts of its k-steps, a warp per part
//     and pair of n-tiles; the parts leave their partial sums in shared memory
//     and one thread per output adds them in a fixed order, then runs bias,
//     gate and GLU. The shallow products (w_og, the head) take a warp per
//     n-tile, and bias, residual or skip sum and the send run in the registers
//     that hold the sums. The order of every sum depends on the product's depth
//     alone, so a stream's result does not depend on which streams share its
//     cluster, on the threads, on the row tiles (below), or (where no channel
//     needs padding) on the cluster size. f32 packs take the same structure
//     with FP32 FMAs, a thread per output (TF32 would lose the whole-run
//     agreement with the plain version).
//   * A cluster of 17-32 streams (generate_kernel<W, false, 2>) runs two row
//     tiles, so that B=256 fills 8 clusters of 8 CTAs in one wave where
//     16-stream clusters would have to shrink to 4 CTAs. The buffers, the
//     exchanges, the tap gathers and the sampler (8 lanes a stream) take 32
//     rows; a w_in item runs both tiles with one read of each weight
//     fragment, over the k-steps of one of a kSplitIn part's two sums (acc
//     or odd), so that every warp has an item; the shallow products take a
//     warp per n-tile and row tile. Each CTA then computes what a CTA of a
//     16-stream cluster of 4 does, but the cluster sends and gathers twice
//     as many copies of each stream's activations: on an H100 a step takes
//     ~2% longer, so the picker takes two tiles only where clusters of 4
//     would stream the chunk ring (ops/cuda_generate.py::pick_cluster). The
//     32 rows' buffers leave room for whole-layer stages only; the chunk
//     ring runs one row tile.
//   * Activations cross the cluster through distributed shared memory: after
//     the GLU each CTA sends its slice of `gated` into every CTA's buffer,
//     after w_og its slice of the new residual (the next layer's newest tap),
//     with st.async, which counts the bytes on an mbarrier of the receiving
//     CTA; the receiver waits on its own mbarrier. There is no cluster-wide
//     barrier inside a layer: a buffer is free for the next round because a
//     sender only gets there after it has received what the reader sent after
//     reading. Of a layer's w_in operand only the newest tap comes from the
//     peers; the older taps and the conditioning row are in shared memory
//     before the layer starts (fetched ahead, below). So the operand and w_in's
//     rows are in the order [older taps | cond | newest tap]
//     (ops/cuda_generate.py::KernelPack; the plan's cond_at, new_at and
//     ks_new), an order that depends on the model's widths alone (f32 packs
//     keep the plain version's [taps | cond]). Two row tiles
//     run the k-steps they hold before they wait for the newest tap; one row
//     tile waits before its walk: there the tap has landed by the time a layer
//     starts, and a walk cut in two cost more than the wait (H100: 3-4.5% a
//     step). This still needs no barrier: thread 0 re-arms the newest tap's
//     mbarrier as soon as it has waited, which is before this CTA's gated send,
//     and a peer sends the next layer's newest tap only after it has received
//     that send. Skip sums stay local to the CTA that owns the columns and are
//     gathered once for the head. The scalar heads' second 1x1 (a few columns)
//     and sampler run redundantly in every CTA with the same hash, so the
//     sample needs no broadcast. The categorical head is split like every other
//     product: CTA r holds classes [r*Cq, (r+1)*Cq) of w_h2, adds their Gumbel
//     noise (keyed by the absolute class) and sends its best (score, class) a
//     stream to every CTA, each of which reduces the CS candidates in rank
//     order to the same code. Its one-hot input is kept as that code: the first
//     1x1 conv is a row of w_first.
//   * What does not depend on the current step is fetched ahead. The weights
//     are repacked once per pack (ops/cuda_generate.py::kernel_pack) so that
//     a CTA's slice of a layer is one contiguous block in mma fragment order;
//     one thread brings it into a ring of shared-memory stages with
//     cp.async.bulk + mbarrier, as many layers ahead as fit (all layers stay
//     resident when they fit), the w_in slice and the rest of a block each
//     as soon as the stage's last reader is past it; the head's block stays
//     resident. A layer's biases travel in the same block. The older taps of
//     layer l+2 are loaded from the global ring while layer l runs, those of
//     the next step's first two layers and its conditioning row while the
//     head runs.
//   * A CTA whose two layer blocks and head do not fit (the 512/512/256
//     model: 256.6 KB a block at clusters of 8 beside 153.6 KB of buffers)
//     pulls its whole slice of the model, ~6 MB, through shared memory every
//     step. Read as fragments from global memory on the product chain, each
//     load's L2 or HBM round trip stood on that chain, which 8 warps cannot
//     hide. Such a shape streams instead (the chunk ring, generate_kernel<W,
//     true>): each product's slice is cut into chunks of whole steps (bf16
//     k-steps, f32 rows; ops/cuda_generate.py::plan_launch), and a producer
//     warpgroup (one lane working; its registers go to the computing warps)
//     puts them with cp.async.bulk, in the order the warps take them, into
//     slots with a full and an empty mbarrier each, a slot as soon as every
//     warp has left it; the head's products stream through the same slots.
//     A warp takes each chunk as its k-walk enters it: all of its units of
//     the product (an item or a tile; kUnits a pass) advance through the
//     chunk together, each sum taking the same k-steps in the same order as
//     the whole-layer path. A pass's last chunk brings the product's biases
//     behind its weights; they are read out before the chunk goes back. Two
//     large slots ran faster on an H100 than three to six smaller ones:
//     every chunk costs each warp a wait and a release. What bounds the
//     512/512/256 step then: the stream itself (the products compiled out,
//     a step still takes ~75% of its time) and the older taps of the layer
//     after next, of which a thread loads kTapPre vectors ahead and, at
//     R = 512, six more on the chain at the layer's end.
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
// makes thread 0 of CTA 0 stamp the clock through the last step of a launch:
// the step's start, the end of the first conv and prefetch stores, per layer
// l from 2 + 6 l on the end of the stage waits, the start and the end of the
// newest tap's wait, the GLU's send, the wait for gated and the layer's end,
// then the head's two products and the sampler (6 L + 5 stamps).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cgr = cooperative_groups;

namespace {

constexpr int kTileRows = 16;      // streams of one mma row tile
constexpr int kMaxTiles = 2;       // row tiles a cluster owns at most
constexpr int kThreads = 256;      // most threads per CTA
constexpr int kSplitIn = 2;        // parts the depth of the w_in product is cut into (bf16)
constexpr int kTapPre = 2;         // 8-element tap vectors a thread loads ahead, a row tile
constexpr int kUnits = 2;          // chunk ring: units of a product a warp (f32: thread) runs a pass
constexpr int kFillThreads = 128;  // chunk ring: the filler's warpgroup
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
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// bytes (a multiple of 16) from global to this CTA's shared memory; completion
// is counted on the mbarrier, which expects them already. Issued by one thread.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, size_t bytes,
                                          uint64_t* bar) {
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
__device__ __forceinline__ void bulk_load(void* dst, const void* src, size_t bytes,
                                          uint64_t* bar) {
  mbar_expect_tx(bar, (uint32_t)bytes);
  bulk_copy(dst, src, bytes, bar);
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
// pack dtype; K % 16 == 0. w: this CTA's K x N slice (N % 8 == 0), or a run
// of its k-steps (16 rows each), in shared memory.

// bf16: w in mma fragment order, [k-step][n-tile][lane][4], lane (g = lane / 4,
// t = lane % 4) holding w[16 ks + 2t + {0, 1, 8, 9}][8 nt + g]; w holds the
// fragments from k-step kb on. One warp runs k-steps ks, ks + stride, ...
// below ke for NTL n-tiles (nt[i]); lane (g, t) ends up with acc[i] = {(g,
// 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)} of tile nt[i]. Two accumulators per
// tile take a product's k-steps in turns (the mma's latency is what a chain
// waits for): its m-th k-step goes to acc for even m and to odd for odd m,
// wherever a run of them starts (odd_first: this run starts at an odd m).
template <int NTL, bool kAnyStart>
__device__ __forceinline__ void mma_steps(const __nv_bfloat16* w, int kb, int ks, int ke,
                                          int stride, int N, const int* nt,
                                          const __nv_bfloat16* x, int xs, float (*acc)[4],
                                          float (*odd)[4], bool odd_first) {
#ifndef WN_NO_PRODUCTS
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int per = (N >> 3) * 32;   // uint2s per k-step
  const __nv_bfloat16* xp = x + g * xs + 2 * t + ks * 16;
  const uint2* wp = reinterpret_cast<const uint2*>(w) + lane + (size_t)(ks - kb) * per;
  if (kAnyStart && odd_first && ks < ke) {
    const uint32_t a0 = *reinterpret_cast<const uint32_t*>(xp);
    const uint32_t a1 = *reinterpret_cast<const uint32_t*>(xp + 8 * xs);
    const uint32_t a2 = *reinterpret_cast<const uint32_t*>(xp + 8);
    const uint32_t a3 = *reinterpret_cast<const uint32_t*>(xp + 8 * xs + 8);
#pragma unroll
    for (int i = 0; i < NTL; ++i) {
      const uint2 b = wp[nt[i] * 32];
      mma_bf16(odd[i], a0, a1, a2, a3, b.x, b.y);
    }
    ks += stride;
    xp += 16 * stride;
    wp += stride * per;
  }
#pragma unroll 2
  for (; ks + stride < ke; ks += 2 * stride, xp += 32 * stride, wp += 2 * stride * per) {
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
  if (ks < ke) {
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
#endif
}

// The whole depth of a product: k-steps ks0, ks0 + stride, ... of K / 16.
template <int NTL>
__device__ __forceinline__ void mma_chain(const __nv_bfloat16* w, int K, int N, int ks0,
                                          int stride, const int* nt, const __nv_bfloat16* x,
                                          int xs, float (*acc)[4]) {
  float odd[NTL][4];
#pragma unroll
  for (int i = 0; i < NTL; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[i][v] = odd[i][v] = 0.0f;
  mma_steps<NTL, false>(w, 0, ks0, K >> 4, stride, N, nt, x, xs, acc, odd, false);
#ifndef WN_NO_PRODUCTS
#pragma unroll
  for (int i = 0; i < NTL; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[i][v] += odd[i][v];
#endif
}

// The first k-step at or after a of the walk sp, sp + stride, ... (stride a
// power of two, sp < stride)
__device__ __forceinline__ int first_step(int sp, int a, int stride) {
  return a + ((sp - a) & (stride - 1));
}

// Two row tiles of the w_in product, bf16 (generate_kernel<W, false, 2>):
// one accumulator per row tile mt and n-tile nt[i], acc[mt * NTL + i], adds
// the k-steps in [from, to) of sp, sp + stride, ... in that order, each
// weight fragment read once for both tiles. With stride twice mma_chain's,
// the parts sp and sp + stride / 2 are that chain's acc and odd sums; a walk
// split into such runs sums what it sums whole.
template <int NTL, int TILES>
__device__ __forceinline__ void mma_run(const __nv_bfloat16* w, int sp, int from, int to,
                                        int stride, int N, const int* nt, const __nv_bfloat16* x,
                                        int xs, float (*acc)[4]) {
#ifndef WN_NO_PRODUCTS
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int per = (N >> 3) * 32;   // uint2s per k-step
  const int ks0 = first_step(sp, from, stride);
  const __nv_bfloat16* xp = x + g * xs + 2 * t + ks0 * 16;
  const uint2* wp = reinterpret_cast<const uint2*>(w) + lane + (size_t)ks0 * per;
#pragma unroll 2
  for (int ks = ks0; ks < to; ks += stride, xp += 16 * stride, wp += stride * per) {
    uint32_t a[TILES][4];
#pragma unroll
    for (int mt = 0; mt < TILES; ++mt) {
      const __nv_bfloat16* r = xp + 16 * mt * xs;
      a[mt][0] = *reinterpret_cast<const uint32_t*>(r);
      a[mt][1] = *reinterpret_cast<const uint32_t*>(r + 8 * xs);
      a[mt][2] = *reinterpret_cast<const uint32_t*>(r + 8);
      a[mt][3] = *reinterpret_cast<const uint32_t*>(r + 8 * xs + 8);
    }
#pragma unroll
    for (int i = 0; i < NTL; ++i) {
      const uint2 b = wp[nt[i] * 32];
#pragma unroll
      for (int mt = 0; mt < TILES; ++mt)
        mma_bf16(acc[mt * NTL + i], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b.x, b.y);
    }
  }
#endif
}

// f32: w row-major, from row r0 on; one thread runs rows [r0, r1) of the
// depth for one row and NCOL columns (col[i]).
template <int NCOL>
__device__ __forceinline__ void fma_rows(const float* w, int r0, int r1, int N, const int* col,
                                         const float* xrow, float* acc) {
#ifndef WN_NO_PRODUCTS
  for (int k = r0; k < r1; ++k) {
    const float xv = xrow[k];
    const float* wr = w + (size_t)(k - r0) * N;
#pragma unroll
    for (int i = 0; i < NCOL; ++i) acc[i] += xv * wr[col[i]];
  }
#endif
}

template <int NCOL>
__device__ __forceinline__ void fma_chain(const float* w, int K, int N, const int* col,
                                          const float* xrow, float* acc) {
#pragma unroll
  for (int i = 0; i < NCOL; ++i) acc[i] = 0.0f;
  fma_rows<NCOL>(w, 0, K, N, col, xrow, acc);
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
  __device__ __forceinline__ float get(int i) const {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&u)[i]);
  }
  __device__ __forceinline__ void set(int i, float v) {
    reinterpret_cast<__nv_bfloat16*>(&u)[i] = __float2bfloat16(v);
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
  __device__ __forceinline__ float get(int i) const {
    return i < 4 ? (&a.x)[i] : (&b.x)[i - 4];
  }
  __device__ __forceinline__ void set(int i, float v) {
    if (i < 4) (&a.x)[i] = v; else (&b.x)[i - 4] = v;
  }
};

// The launch plan, made on the host (ops/cuda_generate.py::plan_launch; its
// Plan and _CPlan follow this struct field for field): the model as the
// kernel runs it, the cluster shape, the kernel-side pack's widths, the ring
// of weights in shared memory and the byte offsets of every buffer there.
struct Plan {
  int L, lps, k;
  int R;              // the ring's width, a multiple of 8
  int G, C_in, C_out, cin;
  int head;           // 0 categorical (split over the cluster), 1 logistic mixture, 2 normal
  int bf16;           // the pack dtype: bf16, else f32
  int CS, spc;        // CTAs per cluster, streams per cluster
  int tiles;          // mma row tiles of kTileRows streams a cluster (kTiles)
  int Gq, Rq, Sq;     // gate, residual, skip channels a CTA owns (multiples of 8)
  int Kin, Kog, Ksk;  // padded depths of w_in, w_og and the head products (% 16)
  int Cq;             // the head's output columns a CTA holds (padded to 8): all C_out
                      // for the scalar heads, its share of the classes for the categorical
  int xs, gs, ss;     // row strides of the xin, gated and head buffers
  int cond_at, new_at;  // where the conditioning and the newest tap start in an xin row
  int ks_new;         // w_in's first k-step (16 rows) that holds a newest-tap row
  int stage_bytes, head_bytes;  // a CTA's layer block and head block in the pack
  int nstage;         // whole-layer stages, or chunk slots
  int slot_bytes;     // 0: whole-layer stages, the head's block resident; else a chunk slot
  int ck[4];          // steps (bf16 k-steps, f32 rows) a chunk of w_in, w_og, w_h1, w_h2 carries
  int passes[4];      // passes over each product's chunks, kUnits units a warp (f32: thread) each
  int head_res;       // the head's block held in shared memory (whole-layer stages)
  // byte offsets into dynamic shared memory: stages or slots from 0, stage_stride apart
  int stage_stride, headw, xin, gt, hx, o1, part, bst, hbf, sk, lo, xc, cand, first, code,
      ltab, bars, total;
};
constexpr int kBars = 5;   // mbarriers besides the ring's: the head's weights, four exchanges

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
  int deterministic;
  Plan plan;
};

#ifdef WN_TRACE
#define WN_STAMP(i) \
  if (p.trace != nullptr && threadIdx.x == 0 && blockIdx.x == 0 && j == p.n - 1) \
    p.trace[i] = clock64()
#else
#define WN_STAMP(i)
#endif

// kTiles: the mma row tiles of 16 streams a cluster owns (1 or 2); the chunk
// ring runs one.
template <typename W, bool kChunk, int kTiles>
__global__ void __launch_bounds__(kThreads + (kChunk ? kFillThreads : 0), 1)
    generate_kernel(const Params p) {
  static_assert(kTiles == 1 || (kTiles == kMaxTiles && !kChunk), "the chunk ring runs one row tile");
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int M = kTileRows * kTiles;
  constexpr int kPre = kTapPre * kTiles;   // tap vectors a thread loads ahead
  // bf16: parts of the w_in product's k-steps, each a warp's item with a pair
  // of n-tiles (two row tiles: each part a single chain of both tiles)
  constexpr int kParts = kSplitIn * kTiles;
  constexpr bool kBf16 = !std::is_same<W, float>::value;
  cgr::cluster_group cluster = cgr::this_cluster();
  unsigned char* stages = smem;
  // 2 x M x xs: [older taps | cond | newest tap], by layer parity
  W* xin = reinterpret_cast<W*>(smem + p.plan.xin);
  W* gt = reinterpret_cast<W*>(smem + p.plan.gt);     // M x gs: gated, all CTAs' slices
  W* hx = reinterpret_cast<W*>(smem + p.plan.hx);     // M x ss: head input
  W* o1 = reinterpret_cast<W*>(smem + p.plan.o1);     // M x ss: head hidden
  float* part = reinterpret_cast<float*>(smem + p.plan.part);
  float* bst = reinterpret_cast<float*>(smem + p.plan.bst);
  float* hbf = reinterpret_cast<float*>(smem + p.plan.hbf);  // M x Rq: own residual columns, f32
  float* sk = reinterpret_cast<float*>(smem + p.plan.sk);    // M x Sq: own skip sums
  float* lo = reinterpret_cast<float*>(smem + p.plan.lo);    // M x Cq: head output
  float* xc = reinterpret_cast<float*>(smem + p.plan.xc);    // M x C_in: input (scalar heads)
  uint2* cand = reinterpret_cast<uint2*>(smem + p.plan.cand);  // M x CS: each CTA's (score, class)
  // the first conv's bias and, for a scalar input, its one row of weights
  float* first_b = reinterpret_cast<float*>(smem + p.plan.first);
  float* first_w = first_b + p.plan.CS * p.plan.Rq;
  int* code = reinterpret_cast<int*>(smem + p.plan.code);    // last emitted class per stream
  int* l_off = reinterpret_cast<int*>(smem + p.plan.ltab);   // per layer: first ring row,
  int* l_dil = l_off + p.plan.L;                             //   dilation,
  int* l_mods = l_dil + p.plan.L;   //   t mod ((k - 1) * dilation), for even and odd steps j
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + p.plan.bars);
  // bars[2 s]: whole-layer stage s holds its block (both parts, below,
  // arrive on it: one wait a layer). Chunk ring: bars[2 s], bars[2 s + 1]:
  // slot s is full; slot s is free again.
  uint64_t* bar_head = bars + 2 * p.plan.nstage;   // the head's weights have landed
  uint64_t* bar_x = bar_head + 1;    // all slices of a layer's newest tap have landed
  uint64_t* bar_g = bar_head + 2;    // ... of gated
  uint64_t* bar_hx = bar_head + 3;   // ... of the head's input
  uint64_t* bar_o1 = bar_head + 4;   // ... of the head's hidden layer
  uint64_t* bar_cd = bar_head + 5;   // every CTA's candidates (split head)

  // A CTA runs few warps and a step is one long chain, so a step's time is
  // the length of the instruction stream along it: index arithmetic is hoisted
  // out of the step loop (Walk, the tap tables), nothing in a layer divides,
  // and every product's bias, activation and send run in the registers of
  // the thread that holds the sum.
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the threads that compute; the chunk ring's filler is a warpgroup more
  const int nthr = kChunk ? (int)blockDim.x - kFillThreads : (int)blockDim.x;
  const int NW = nthr >> 5, g = lane >> 2, t4 = lane & 3;
  const int CS = p.plan.CS, rank = (int)cluster.block_rank();
  const int base = (blockIdx.x / CS) * p.plan.spc;
  const int nvalid = min(p.plan.spc, p.B - base);
  const int L = p.plan.L, R = p.plan.R, G = p.plan.G, G2 = p.plan.G / 2;
  const int k = p.plan.k, cin = p.plan.cin, C_in = p.plan.C_in, C_out = p.plan.C_out;
  const int Gq = p.plan.Gq, Rq = p.plan.Rq, Sq = p.plan.Sq, Rp = CS * Rq, Cq = p.plan.Cq;
  const bool split = p.plan.head == 0;
  const int xs = p.plan.xs, gs = p.plan.gs, ss = p.plan.ss;
  const int cond_at = p.plan.cond_at, new_at = p.plan.new_at, ks_new = p.plan.ks_new;
  const int NA = 2 * Gq, NB = Rq + Sq;
  const W* w_first = static_cast<const W*>(p.w_first);
  const unsigned char* wl = p.wl + (size_t)rank * L * p.plan.stage_bytes;
  const unsigned char* wh = p.wh + (size_t)rank * p.plan.head_bytes;
  const size_t win_bytes = (size_t)p.plan.Kin * NA * sizeof(W);
  const size_t wog_bytes = (size_t)p.plan.Kog * NB * sizeof(W);
  const size_t wh1_bytes = (size_t)p.plan.Ksk * Sq * sizeof(W);
  const size_t wh2_bytes = (size_t)p.plan.Ksk * Cq * sizeof(W);
  const W* cond = static_cast<const W*>(p.cond);
  W* ring = static_cast<W*>(p.ring);
  const size_t ring_row = (size_t)p.B * R;
  const float sqrt_half = 0.70710678118654752440f;
  const float sqrt_inv_L = (float)sqrt(1.0 / (double)L);
  const bool resident = p.plan.nstage >= L;
  const long long total_layers = (long long)p.n * L;
  // bytes a CTA receives per round of each exchange (every CTA's slice, its own too)
  const uint32_t x_bytes = (uint32_t)(M * Rp * sizeof(W));
  const uint32_t g_bytes = (uint32_t)(M * CS * Gq * sizeof(W));
  const uint32_t s_bytes = (uint32_t)(M * CS * Sq * sizeof(W));
  const uint32_t c_bytes = (uint32_t)(nvalid * CS * 8);
  uint32_t x_round = 0, g_round = 0, h_round = 0, c_round = 0;   // rounds waited for so far
  const Walk walk_p(tid, nthr, Rp);
  // a thread's outputs (row, col) of each product
  const Walk walk_g(tid, nthr, Gq), walk_b(tid, nthr, NB), walk_s(tid, nthr, Sq);
  const Walk walk_c(tid, nthr, Cq);
  // bf16: a warp's items of the w_in product, (part of the k-steps, pair of
  // n-tiles: 8 gate channels' a and b half)
  const int pairs = Gq >> 3;
  const Walk walk_w(warp, NW, pairs);
  // the depths of w_in, w_og and the head's products in the chunk ring's
  // steps: bf16 mma k-steps of 16 rows, f32 single rows
  constexpr int kRowsStep = kBf16 ? 16 : 1;
  const int KSin = p.plan.Kin / kRowsStep, KSog = p.plan.Kog / kRowsStep;
  const int KSsk = p.plan.Ksk / kRowsStep;

  // zero every activation buffer (padding columns and unused rows stay zero)
  {
    uint32_t* z = reinterpret_cast<uint32_t*>(smem + p.plan.xin);
    const int words = (int)((p.plan.bars - p.plan.xin) / 4);
    for (int e = tid; e < words; e += blockDim.x) z[e] = 0u;
  }
  if (tid == 0) {
    // a whole-layer stage holds its block once both parts have arrived; a
    // chunk slot is free again once every warp has left it
    for (int s = 0; s < 2 * p.plan.nstage + kBars + split; ++s)
      mbar_init(&bars[s], s >= 2 * p.plan.nstage ? 1
                          : (s & 1)                 ? (kChunk ? NW : 1)
                                                    : (kChunk ? 1 : 2));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if constexpr (kChunk) {
    if (warp >= NW) {
      // The chunk ring's filler, a warpgroup of its own that gives most of
      // its registers to the computing ones; its first lane walks the order
      // in which every warp takes the chunks: per step each layer's w_in
      // then w_og slice, then the head's w_h1 and w_h2; each product pass
      // by pass, a pass in chunks of whole steps; each chunk into the next
      // slot once every computing warp has left what it held. A pass's last
      // chunk brings the product's biases behind its weights.
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
      if (warp > NW) return;
      int slot = 0;
      uint32_t wraps = 0;
      auto put = [&](const unsigned char* w, int KS, int d, const unsigned char* bias,
                     uint32_t bias_bytes) {
        const size_t kstep =
            (size_t)kRowsStep * (d == 0 ? NA : d == 1 ? NB : d == 2 ? Sq : Cq) * sizeof(W);
        for (int pass = 0; pass < p.plan.passes[d]; ++pass)
          for (int k0 = 0; k0 < KS; k0 += p.plan.ck[d]) {
            const int k1 = min(KS, k0 + p.plan.ck[d]);
            const uint32_t bytes = (uint32_t)((k1 - k0) * kstep);
            const uint32_t extra = k1 == KS ? bias_bytes : 0u;
            if (wraps > 0) mbar_wait(&bars[2 * slot + 1], (wraps - 1) & 1);
            unsigned char* dst = stages + slot * p.plan.stage_stride;
            mbar_expect_tx(&bars[2 * slot], bytes + extra);
            bulk_copy(dst, w + k0 * kstep, bytes, &bars[2 * slot]);
            if (extra) bulk_copy(dst + bytes, bias, extra, &bars[2 * slot]);
            if (++slot == p.plan.nstage) {
              slot = 0;
              ++wraps;
            }
          }
      };
      // the cluster barriers the computing threads pass: before the first
      // step, after each step's layers (its wait after the head's first
      // product, so that the head's chunks are on their way before it), and
      // before they leave
      cluster_arrive();
      cluster_wait();
      for (int j = 0; j < p.n; ++j) {
        if (lane == 0)
          for (int l = 0; l < L; ++l) {
            const unsigned char* blk = wl + (size_t)l * p.plan.stage_bytes;
            const unsigned char* bias = blk + win_bytes + wog_bytes;
            put(blk, KSin, 0, bias, NA * 4);
            put(blk + win_bytes, KSog, 1, bias + NA * 4, NB * 4);
          }
        __syncwarp();
        cluster_arrive();
        if (lane == 0) {
          const unsigned char* bias = wh + wh1_bytes + wh2_bytes;
          put(wh, KSsk, 2, bias, Sq * 4);
          put(wh + wh1_bytes, KSsk, 3, bias + Sq * 4, Cq * 4);
        }
        __syncwarp();
        cluster_wait();
      }
      cluster_arrive();
      cluster_wait();
      return;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  }
  // from here on the computing threads alone
  auto sync = [&]() {
    if constexpr (kChunk)
      asm volatile("bar.sync 1, %0;\n" ::"r"(nthr) : "memory");
    else
      __syncthreads();
  };

  if (split) {
    // a one-hot row's code: the index of its nonzero entry (C_in: a zero
    // row, no input), a warp a stream
    for (int bi = warp; bi < M; bi += NW) {
      int c = C_in;
      if (bi < nvalid) {
        const float* x = p.x_cur + (size_t)(base + bi) * C_in;
        for (int c0 = 0; c0 < C_in; c0 += 32) {
          const unsigned hit = __ballot_sync(0xffffffffu, c0 + lane < C_in && x[c0 + lane] != 0.0f);
          if (hit) {
            c = c0 + __ffs(hit) - 1;
            break;
          }
        }
      }
      if (lane == 0) code[bi] = c;
    }
  } else {
    for (int e = tid; e < M * C_in; e += nthr) {
      const int bi = e / C_in;
      if (bi < nvalid) xc[e] = p.x_cur[(size_t)(base + bi) * C_in + e % C_in];
    }
  }
  for (int ch = tid; ch < R; ch += nthr) {
    first_b[ch] = p.b_first[ch];
    first_w[ch] = to_f(w_first[ch]);
  }
  if (tid == 0) {
    int off = 0;
    for (int l = 0; l < L; ++l) {
      l_off[l] = off;
      l_dil[l] = 1 << (l % p.plan.lps);
      off += (k - 1) * l_dil[l];
    }
  }
  // The ring of whole-layer stages, filled in two parts so that each part is
  // on its way again as soon as it is read out: part 0 the w_in slice, part 1
  // the rest. The next block of part h goes to stage fill_slot[h].
  long long issued[2] = {0, 0};
  int fill_slot[2] = {0, 0}, fill_layer[2] = {0, 0};
  // The last warp has the fewest products to run: its first lane fills.
  const bool filler = !kChunk && tid == nthr - 32;
  auto fill = [&](int h) {   // the filler only
    const size_t at = h ? win_bytes : 0, bytes = h ? p.plan.stage_bytes - win_bytes : win_bytes;
    bulk_load(stages + fill_slot[h] * p.plan.stage_stride + at,
              wl + (size_t)fill_layer[h] * p.plan.stage_bytes + at, bytes,
              &bars[2 * fill_slot[h]]);
    ++issued[h];
    if (++fill_slot[h] == p.plan.nstage) fill_slot[h] = 0;
    if (++fill_layer[h] == L) fill_layer[h] = 0;
  };
  const bool refill = !resident;
  if (filler) {
    bulk_load(smem + p.plan.headw, wh, (size_t)p.plan.head_bytes, bar_head);
    for (int h = 0; h < 2; ++h)
      while (issued[h] < p.plan.nstage && issued[h] < total_layers) fill(h);
  }
  if (tid == 0) {
    // the first round of every exchange
    mbar_expect_tx(bar_x, x_bytes);
    mbar_expect_tx(bar_g, g_bytes);
    mbar_expect_tx(bar_hx, s_bytes);
    mbar_expect_tx(bar_o1, s_bytes);
    if (split) mbar_expect_tx(bar_cd, c_bytes);
  }
  int use_slot = 0;            // the stage or slot read next,
  uint32_t use_parity = 0;     //   and how often the ring has wrapped (mod 2)
  // no CTA sends into a peer before the peer has cleared its buffers and
  // set up its mbarriers
  cluster_arrive();
  cluster_wait();

  // The chunk ring, as the computing warps see it: every warp takes every
  // chunk, in the order the filler brings them, and leaves it as a warp.
  auto acquire = [&]() {
    mbar_wait(&bars[2 * use_slot], use_parity);
    return static_cast<const unsigned char*>(stages + use_slot * p.plan.stage_stride);
  };
  auto release = [&]() {
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars[2 * use_slot + 1]);
    if (++use_slot == p.plan.nstage) {
      use_slot = 0;
      use_parity ^= 1u;
    }
  };
  // One pass over the KS steps of a product in chunks of ck: step(chunk,
  // k0, k1) on each, chunk holding steps [k0, k1) of kstep bytes. Returns
  // the biases behind the last chunk's weights; that chunk stays taken until
  // the caller, done with them, releases it.
  auto walk = [&](int KS, int ck, size_t kstep, auto&& step) {
    for (int k0 = 0;; k0 += ck) {
      const int k1 = min(KS, k0 + ck);
      const unsigned char* c = acquire();
      step(c, k0, k1);
      if (k1 == KS) return reinterpret_cast<const float*>(c + (size_t)(k1 - k0) * kstep);
      release();
    }
  };
  // Chunk ring, bf16: a product of single n-tiles (w_og, the head's), pass
  // by pass up to kUnits of the warp's tiles through every chunk, then
  // epi(tile, 0, sums, b0, b1) for each (row tile 0), b0 and b1 the biases
  // of the lane's columns 8 tile + 2 t4 + {0, 1}, read before the last
  // chunk goes back.
  auto tiles_pass = [&](int d, int KS, int N, const auto* x, int xstride, int tiles,
                        auto&& skip, auto&& epi) {
    for (int pass = 0; pass < p.plan.passes[d]; ++pass) {
      float acc[kUnits][1][4], odd[kUnits][1][4];
      int nt[kUnits];
      bool on[kUnits];
#pragma unroll
      for (int i = 0; i < kUnits; ++i) {
        nt[i] = warp + (pass * kUnits + i) * NW;
        on[i] = nt[i] < tiles && !skip(nt[i]);
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][0][v] = odd[i][0][v] = 0.0f;
      }
      const float* bias = walk(KS, p.plan.ck[d], (size_t)16 * N * sizeof(W),
                               [&](const unsigned char* c, int k0, int k1) {
#pragma unroll
        for (int i = 0; i < kUnits; ++i)
          if (on[i])
            mma_steps<1, true>(reinterpret_cast<const __nv_bfloat16*>(c), k0, k0, k1, 1, N,
                               &nt[i], x, xstride, acc[i], odd[i], k0 & 1);
      });
      float b[kUnits][2];
#pragma unroll
      for (int i = 0; i < kUnits; ++i)
        if (on[i]) b[i][0] = bias[nt[i] * 8 + 2 * t4], b[i][1] = bias[nt[i] * 8 + 2 * t4 + 1];
      release();
#pragma unroll
      for (int i = 0; i < kUnits; ++i) {
        if (!on[i]) continue;
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][0][v] += odd[i][0][v];
        epi(nt[i], 0, acc[i][0], b[i][0], b[i][1]);
      }
    }
  };
  // Chunk ring, f32: a product of one column an output (w_og, the head's),
  // pass by pass up to kUnits of the thread's outputs (row, col) of the M x N
  // through every chunk, then epi(row, col, sum, biases) for each.
  auto cols_pass = [&](int d, int KS, int N, const auto* x, int xstride, auto&& skip,
                       auto&& epi) {
    for (int pass = 0; pass < p.plan.passes[d]; ++pass) {
      float acc[kUnits][1];
      int row[kUnits], col[kUnits];
      bool on[kUnits];
#pragma unroll
      for (int i = 0; i < kUnits; ++i) {
        const int e = tid + (pass * kUnits + i) * nthr;
        row[i] = e / N;
        col[i] = e % N;
        on[i] = e < M * N && !skip(col[i]);
        acc[i][0] = 0.0f;
      }
      const float* bias = walk(KS, p.plan.ck[d], (size_t)N * sizeof(W),
                               [&](const unsigned char* c, int k0, int k1) {
#pragma unroll
        for (int i = 0; i < kUnits; ++i)
          if (on[i])
            fma_rows<1>(reinterpret_cast<const float*>(c), k0, k1, N, &col[i],
                        x + row[i] * xstride, acc[i]);
      });
#pragma unroll
      for (int i = 0; i < kUnits; ++i)
        if (on[i]) epi(row[i], col[i], acc[i][0], bias);
      release();
    }
  };
  auto no_skip = [](int) { return false; };

  // The older taps of a layer from the global ring: vector v = tid + u * nthr
  // is 8 channels of one tap of one stream. Where it comes from in a ring row
  // and where it goes in an xin buffer (the older taps lead it) does not
  // change: tables.
  const int VR = R / 8, NV = M * (k - 1) * VR;
  int tap_dst[kPre], tap_from[kPre], tap_back[kPre];   // tap_back: dilations back
  auto tap_place = [&](int v, int* dst, int* from, int* back) {
    const int bi = v / ((k - 1) * VR), rem = v % ((k - 1) * VR);
    const int tap = rem / VR, c8 = rem % VR;
    *dst = bi * xs + tap * Rp + c8 * 8;
    *from = bi < nvalid ? (base + bi) * R + c8 * 8 : -1;
    *back = k - 1 - tap;
  };
#pragma unroll
  for (int u = 0; u < kPre; ++u) {
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
    for (int u = 0; u < kPre; ++u) {
      if (tap_from[u] >= 0)
        pre[u].load(ring + tap_row(off, d, tm, tap_back[u]) * ring_row + tap_from[u]);
      else
        pre[u].zero();
    }
  };
  auto taps_store = [&](const Vec8<W>* pre, int off, int d, int tm, W* xb) {
#pragma unroll
    for (int u = 0; u < kPre; ++u)
      if (tap_dst[u] >= 0) pre[u].store(xb + tap_dst[u]);
    for (int v = tid + kPre * nthr; v < NV; v += nthr) {   // what was not loaded ahead
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
  // a thread loads vectors tid + u * nthr (u < kTiles) ahead
  int cond_bi[kTiles], cond_c8[kTiles];
  cond_bi[0] = cond_vec ? tid / VC : 0, cond_c8[0] = cond_vec ? tid % VC : 0;
#pragma unroll
  for (int u = 1; u < kTiles; ++u) {
    cond_bi[u] = cond_vec ? (tid + u * nthr) / VC : 0;
    cond_c8[u] = cond_vec ? (tid + u * nthr) % VC : 0;
  }
  auto cond_load = [&](Vec8<W>* pre, int j) {
#pragma unroll
    for (int u = 0; u < kTiles; ++u)
      if (cond_vec && tid + u * nthr < M * VC) {
        if (cond_bi[u] < nvalid)
          pre[u].load(cond + (size_t)(base + cond_bi[u]) * p.cond_sb + (size_t)j * cin +
                      cond_c8[u] * 8);
        else
          pre[u].zero();
      }
  };
  auto cond_store = [&](const Vec8<W>* pre, int j) {
    if (cond_vec) {
#pragma unroll
      for (int u = 0; u < kTiles; ++u)
        if (tid + u * nthr < M * VC) {
          pre[u].store(xin + cond_bi[u] * xs + cond_at + cond_c8[u] * 8);
          pre[u].store(xin + (M + cond_bi[u]) * xs + cond_at + cond_c8[u] * 8);
        }
      for (int v = tid + kTiles * nthr; v < M * VC; v += nthr) {   // what was not loaded ahead
        const int bi = v / VC, c8 = v % VC;
        Vec8<W> x;
        if (bi < nvalid)
          x.load(cond + (size_t)(base + bi) * p.cond_sb + (size_t)j * cin + c8 * 8);
        else
          x.zero();
        x.store(xin + bi * xs + cond_at + c8 * 8);
        x.store(xin + (M + bi) * xs + cond_at + c8 * 8);
      }
    } else {
      for (int e = tid; e < M * cin; e += nthr) {
        const int bi = e / cin, i = e % cin;
        if (bi < nvalid) {
          const W cv = cond[(size_t)(base + bi) * p.cond_sb + (size_t)j * cin + i];
          xin[bi * xs + cond_at + i] = cv;
          xin[(M + bi) * xs + cond_at + i] = cv;
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
  sync();
  Vec8<W> pre0[kPre], pre1[kPre], prec[kTiles];
  taps_load(pre0, 0, 1, l_mods[0]);
  if (L > 1) taps_load(pre1, l_off[1], l_dil[1], l_mods[1]);
  cond_load(prec, 0);

  for (int j = 0; j < p.n; ++j) {
    const int t = p.t0 + j;
    const int* l_mod = l_mods + (j & 1) * L;
    WN_STAMP(0);

    // ---- step start: first 1x1 conv (all columns, every CTA); the first two
    // layers' older taps and this step's conditioning row, loaded ahead
    if constexpr (kTiles > 1) {
      // 8 channels a thread at a time (Rp, R and Rq are multiples of 8)
      const int VP = Rp / 8;
      for (int e = tid; e < M * VP; e += nthr) {
        const int bi = e / VP, ch0 = (e % VP) * 8;
        Vec8<W> wv, xv;
        wv.zero();
        if (ch0 < R && split && code[bi] < C_in) wv.load(w_first + (size_t)code[bi] * R + ch0);
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int ch = ch0 + i;
          v[i] = 0.0f;
          if (ch < R) {
            if (split) {
              v[i] = wv.get(i);
            } else {
              v[i] = rnd<W>(xc[bi]) * first_w[ch];
            }
            v[i] += first_b[ch];
          }
          xv.set(i, v[i]);
        }
        xv.store(xin + bi * xs + new_at + ch0);
        const int c = ch0 - rank * Rq;
        if (c >= 0 && c < Rq) {
          float4* h = reinterpret_cast<float4*>(hbf + bi * Rq + c);
          h[0] = make_float4(v[0], v[1], v[2], v[3]);
          h[1] = make_float4(v[4], v[5], v[6], v[7]);
        }
      }
    } else {
      Walk w = walk_p;
      for (int e = tid; e < M * Rp; e += nthr, w.next()) {
        const int bi = w.row, ch = w.col;
        float v = 0.0f;
        if (ch < R) {
          if (split) {   // one-hot input, kept as its code: a row lookup
            if (code[bi] < C_in) v = to_f(w_first[(size_t)code[bi] * R + ch]);
          } else {       // a scalar input
            v = rnd<W>(xc[bi]) * first_w[ch];
          }
          v += first_b[ch];
        }
        xin[bi * xs + new_at + ch] = from_f<W>(v);
        const int c = ch - rank * Rq;
        if (c >= 0 && c < Rq) hbf[bi * Rq + c] = v;
      }
    }
    for (int e = tid; e < M * Sq; e += nthr) sk[e] = 0.0f;
    taps_store(pre0, 0, 1, l_mod[0], xin);
    if (L > 1) taps_store(pre1, l_off[1], l_dil[1], l_mod[1], xin + M * xs);
    cond_store(prec, j);
    sync();
    WN_STAMP(1);

    for (int l = 0; l < L; ++l) {
      const bool last = l + 1 == L;
      W* xb = xin + (l & 1) * M * xs;          // this layer's [taps | cond]
      W* xn = xin + ((l + 1) & 1) * M * xs;    // the next layer's

      // this layer's block of weights and biases: a whole-layer stage holds
      // it; the chunk ring brings it chunk by chunk in the products below
      const W* w_in = nullptr;
      const W* w_og = nullptr;
      const float* b_in = bst;   // the chunk ring copies b_in here
      const float* b_og = nullptr;
      if constexpr (!kChunk) {
        const uint32_t parity = resident ? 0u : use_parity;
        mbar_wait(&bars[2 * use_slot], parity);
        const unsigned char* wst = stages + use_slot * p.plan.stage_stride;
        if (++use_slot == p.plan.nstage) {
          use_slot = 0;
          use_parity ^= 1u;
        }
        w_in = reinterpret_cast<const W*>(wst);
        w_og = reinterpret_cast<const W*>(wst + win_bytes);
        b_in = reinterpret_cast<const float*>(wst + win_bytes + wog_bytes);
        b_og = b_in + NA;
      }
      const float* gg = p.g_gate == nullptr ? nullptr : p.g_gate + ((size_t)l * p.B + base) * G;

      // ---- [older taps | cond | newest tap] @ w_in slice + b_in (+ global
      // gate), GLU; own gate channels go to every CTA. The older taps of the
      // layer after the next start their way from the global ring. The
      // newest tap comes from the cluster (layer 0: from the first conv,
      // above): a warp waits for it once (two row tiles: where the walk
      // first reads it; else before the walk), thread 0 then re-arming its
      // mbarrier.
      WN_STAMP(2 + 6 * l);
      bool x_due = true;
      auto wait_x = [&]() {
        if (!x_due) return;
        x_due = false;
        WN_STAMP(3 + 6 * l);
        if (l > 0) {
          mbar_wait(bar_x, x_round & 1);
          if (tid == 0) mbar_expect_tx(bar_x, x_bytes);
        }
        WN_STAMP(4 + 6 * l);
      };
      Vec8<W> pre[kPre];
      int off2 = 0, dil2 = 1, mod2 = 0;
      if (l + 2 < L) {
        off2 = l_off[l + 2], dil2 = l_dil[l + 2], mod2 = l_mod[l + 2];
        taps_load(pre, off2, dil2, mod2);
      }
      // f32: bias, global gate, GLU and the send of gate channel qc of a stream
      auto glu_send = [&](int row, int qc, float a, float b, const float* bias) {
        const int ch = rank * Gq + qc;
        float za = a + bias[qc], zg = b + bias[Gq + qc];
        if (gg != nullptr && ch < G2 && row < nvalid) {
          za += gg[(size_t)row * G + ch];
          zg += gg[(size_t)row * G + G2 + ch];
        }
        send(CS, gt, row * gs + ch, glu<W>(za, zg), bar_g);
      };
      if constexpr (kBf16) {
        // A warp's item: one pair of n-tiles for one of kSplitIn parts of the
        // k-steps, every row tile; the partial sums meet in shared memory.
        // acc[2 mt + h]: row tile mt, GLU half h.
        auto put_part = [&](int sp, int pr, const float (*acc)[4]) {
          float4* dst =
              reinterpret_cast<float4*>(part) + ((sp * pairs + pr) * kTiles) * 64 + lane;
#pragma unroll
          for (int mt = 0; mt < kTiles; ++mt) {
            dst[64 * mt] = make_float4(acc[2 * mt][0], acc[2 * mt][1], acc[2 * mt][2],
                                       acc[2 * mt][3]);
            dst[64 * mt + 32] = make_float4(acc[2 * mt + 1][0], acc[2 * mt + 1][1],
                                            acc[2 * mt + 1][2], acc[2 * mt + 1][3]);
          }
        };
        if constexpr (kChunk) {
          // pass by pass, up to kUnits of the warp's items through every
          // chunk
          wait_x();
          for (int pass = 0; pass < p.plan.passes[0]; ++pass) {
            float acc[kUnits][2][4], odd[kUnits][2][4];
            int nt[kUnits][2], sp[kUnits];
            bool on[kUnits];
#pragma unroll
            for (int i = 0; i < kUnits; ++i) {
              const int item = warp + (pass * kUnits + i) * NW;
              on[i] = item < pairs * kSplitIn;
              sp[i] = item / pairs;
              nt[i][0] = item % pairs;
              nt[i][1] = pairs + nt[i][0];
#pragma unroll
              for (int a = 0; a < 2; ++a)
#pragma unroll
                for (int v = 0; v < 4; ++v) acc[i][a][v] = odd[i][a][v] = 0.0f;
            }
            const float* bias = walk(KSin, p.plan.ck[0], (size_t)16 * NA * sizeof(W),
                                     [&](const unsigned char* c, int k0, int k1) {
#pragma unroll
              for (int i = 0; i < kUnits; ++i) {
                if (!on[i]) continue;
                // the item's first k-step in the chunk; its m-th of the item
                const int ks = k0 + ((sp[i] - k0) & (kSplitIn - 1));
                mma_steps<2, true>(reinterpret_cast<const __nv_bfloat16*>(c), k0, ks, k1,
                                   kSplitIn, NA, nt[i], xb, xs, acc[i], odd[i],
                                   ((ks - sp[i]) / kSplitIn) & 1);
              }
            });
            // b_in out of its chunk, so that the chunk goes back now
            for (int e = tid; e < NA; e += nthr) bst[e] = bias[e];
            release();
#pragma unroll
            for (int i = 0; i < kUnits; ++i) {
              if (!on[i]) continue;
#pragma unroll
              for (int a = 0; a < 2; ++a)
#pragma unroll
                for (int v = 0; v < 4; ++v) acc[i][a][v] += odd[i][a][v];
              put_part(sp[i], nt[i][0], acc[i]);
            }
          }
        } else {
          // Two row tiles run the k-steps they hold before they wait for
          // the newest tap; one row tile waits first, since there the tap
          // has landed by the time a layer starts and a walk cut in two
          // costs more than the wait (the header's note).
          if constexpr (kTiles == 1) wait_x();
          Walk w = walk_w;
          for (int item = warp; item < pairs * kParts; item += NW, w.next()) {
            const int nt[2] = {w.col, pairs + w.col};
            float acc[2 * kTiles][4];
            if constexpr (kTiles == 1) {
              mma_chain<2>(w_in, p.plan.Kin, NA, w.row, kSplitIn, nt, xb, xs, acc);
            } else {
#pragma unroll
              for (int i = 0; i < 2 * kTiles; ++i)
#pragma unroll
                for (int v = 0; v < 4; ++v) acc[i][v] = 0.0f;
              mma_run<2, kTiles>(w_in, w.row, 0, ks_new, kParts, NA, nt, xb, xs, acc);
              wait_x();
              mma_run<2, kTiles>(w_in, w.row, ks_new, KSin, kParts, NA, nt, xb, xs, acc);
            }
            put_part(w.row, w.col, acc);
          }
        }
      } else {
        wait_x();
        if constexpr (kChunk) {
          for (int pass = 0; pass < p.plan.passes[0]; ++pass) {
            float acc[kUnits][2];
            int row[kUnits], col[kUnits][2];
            bool on[kUnits];
#pragma unroll
            for (int i = 0; i < kUnits; ++i) {
              const int e = tid + (pass * kUnits + i) * nthr;
              on[i] = e < M * Gq;
              row[i] = e / Gq;
              col[i][0] = e % Gq;
              col[i][1] = Gq + col[i][0];
              acc[i][0] = acc[i][1] = 0.0f;
            }
            const float* bias = walk(KSin, p.plan.ck[0], (size_t)NA * sizeof(W),
                                     [&](const unsigned char* c, int k0, int k1) {
#pragma unroll
              for (int i = 0; i < kUnits; ++i)
                if (on[i])
                  fma_rows<2>(reinterpret_cast<const float*>(c), k0, k1, NA, col[i],
                              xb + row[i] * xs, acc[i]);
            });
#pragma unroll
            for (int i = 0; i < kUnits; ++i)
              if (on[i]) glu_send(row[i], col[i][0], acc[i][0], acc[i][1], bias);
            release();
          }
        } else {
          Walk w = walk_g;
          for (int e = tid; e < M * Gq; e += nthr, w.next()) {
            const int col[2] = {w.col, Gq + w.col};
            float acc[2];
            fma_chain<2>(w_in, p.plan.Kin, NA, col, xb + w.row * xs, acc);
            glu_send(w.row, w.col, acc[0], acc[1], b_in);
          }
        }
      }
      if (l > 0) ++x_round;
      sync();
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
          // where mma_chain's lane (r % 8, qc % 8 / 2) of row tile mt keeps
          // (row, qc), row = 16 mt + r
          const int mt = kTiles == 1 ? 0 : row >> 4, r = kTiles == 1 ? row : row & 15;
          const float* src = part + ((qc >> 3) * kTiles + mt) * 256 +
                             ((r & 7) * 4 + ((qc & 7) >> 1)) * 4 + (r >> 3) * 2 + (qc & 1);
          // the sum of part sp in mma_chain's order (two row tiles: its acc
          // and odd sums are parts sp and kSplitIn + sp), parts in order
          auto part_sum = [&](int sp, int h) {
            float v = src[sp * pairs * kTiles * 256 + h];
            if constexpr (kTiles > 1) v += src[(kSplitIn + sp) * pairs * kTiles * 256 + h];
            return v;
          };
          float za = part_sum(0, 0), zg = part_sum(0, 128);
#pragma unroll
          for (int sp = 1; sp < kSplitIn; ++sp) {
            za += part_sum(sp, 0);
            zg += part_sum(sp, 128);
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
      WN_STAMP(5 + 6 * l);

      // ---- gated @ [w_out | w_skip] slice -> own residual and skip columns.
      // Ring rows are written here: every CTA has consumed the rows they evict
      // before it sent the gated slice this CTA waits for. Layer 0 writes its
      // own input of this step, every layer the next one's.
      mbar_wait(bar_g, g_round & 1);
      ++g_round;
      if (tid == 0) mbar_expect_tx(bar_g, g_bytes);
      WN_STAMP(6 + 6 * l);
      W* row0 = ring + (size_t)l_mod[0] * ring_row + (size_t)base * R;
      W* rown = last ? nullptr
                     : ring + (size_t)(l_off[l + 1] + l_mod[l + 1]) * ring_row + (size_t)base * R;
      // the last layer's residual is not used
      auto skip_res = [&](int c) { return c < Rq && last && l != 0; };
      if constexpr (kBf16) {
        // a warp per n-tile and row tile mt; bias, residual or skip sum and
        // the send run in the registers that hold the sums
        auto og_tile = [&](int tile, int mt, const float* acc, float b0, float b1) {
          const int col0 = tile * 8, r0 = 16 * mt;
          float v[4];
          if (col0 < Rq) {
            float h0[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int row = r0 + g + 8 * (i >> 1), c = col0 + 2 * t4 + (i & 1);
              h0[i] = hbf[row * Rq + c];
              v[i] = (acc[i] + ((i & 1) ? b1 : b0) + h0[i]) * sqrt_half;
              hbf[row * Rq + c] = v[i];
            }
            const int ch = rank * Rq + col0 + 2 * t4;   // even: a pair of channels per store
#pragma unroll
            for (int i = 0; i < 4; i += 2) {
              const int row = r0 + g + 4 * i;
              if (row < nvalid && ch < R) {
                if (l == 0)
                  *reinterpret_cast<__nv_bfloat162*>(row0 + (size_t)row * R + ch) =
                      __floats2bfloat162_rn(h0[i], h0[i + 1]);
                if (!last)
                  *reinterpret_cast<__nv_bfloat162*>(rown + (size_t)row * R + ch) =
                      __floats2bfloat162_rn(v[i], v[i + 1]);
              }
            }
            if (!last) send_tile(CS, xn + r0 * xs + new_at, xs, rank * Rq + col0, v, bar_x);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int row = r0 + g + 8 * (i >> 1), c = col0 - Rq + 2 * t4 + (i & 1);
              const float s = sk[row * Sq + c] + acc[i] + ((i & 1) ? b1 : b0);
              sk[row * Sq + c] = s;
              v[i] = fmaxf(s * sqrt_inv_L, 0.0f);   // head input: ReLU of the scaled skip sum
            }
            if (last) send_tile(CS, hx + r0 * ss, ss, rank * Sq + col0 - Rq, v, bar_hx);
          }
        };
        if constexpr (kChunk) {
          tiles_pass(1, KSog, NB, gt, gs, NB >> 3, [&](int tile) { return skip_res(tile * 8); },
                     og_tile);
        } else {
          for (int item = warp; item < (NB >> 3) * kTiles; item += NW) {
            const int tile = item / kTiles, mt = item % kTiles;
            if (skip_res(tile * 8)) continue;
            float acc[1][4];
            mma_chain<1>(w_og, p.plan.Kog, NB, 0, 1, &tile, gt + 16 * mt * gs, gs, acc);
            og_tile(tile, mt, acc[0], b_og[tile * 8 + 2 * t4], b_og[tile * 8 + 2 * t4 + 1]);
          }
        }
      } else {
        auto og_out = [&](int row, int c, float acc, const float* bias) {
          if (c < Rq) {
            const int ch = rank * Rq + c;
            const float h0 = hbf[row * Rq + c];
            const float h1 = (acc + bias[c] + h0) * sqrt_half;
            hbf[row * Rq + c] = h1;
            if (row < nvalid && ch < R) {
              if (l == 0) row0[(size_t)row * R + ch] = from_f<W>(h0);
              if (!last) rown[(size_t)row * R + ch] = from_f<W>(h1);
            }
            if (!last) send(CS, xn, row * xs + new_at + ch, h1, bar_x);
          } else {
            const float s = sk[row * Sq + c - Rq] + acc + bias[c];
            sk[row * Sq + c - Rq] = s;
            if (last)
              send(CS, hx, row * ss + rank * Sq + c - Rq, fmaxf(s * sqrt_inv_L, 0.0f), bar_hx);
          }
        };
        if constexpr (kChunk) {
          cols_pass(1, KSog, NB, gt, gs, skip_res, og_out);
        } else {
          Walk w = walk_b;
          for (int e = tid; e < M * NB; e += nthr, w.next()) {
            const int row = w.row, c = w.col;
            if (skip_res(c)) continue;
            float acc[1];
            fma_chain<1>(w_og, p.plan.Kog, NB, &c, gt + row * gs, acc);
            og_out(row, c, acc[0], b_og);
          }
        }
      }
      // this layer's buffer was read out before the block barrier above: the
      // older taps of the layer after the next go where its own were
      if (l + 2 < L) taps_store(pre, off2, dil2, mod2, xb);
      WN_STAMP(7 + 6 * l);
    }
    // all of this step's ring writes are issued: the cluster barrier's first half
    cluster_arrive();

    // ---- head: 1x1 (own columns) -> ReLU -> 1x1 (all columns, every CTA)
    const W* w_h1 = nullptr;
    const W* w_h2 = nullptr;
    const float* b_h1 = nullptr;
    const float* b_h2 = nullptr;
    if constexpr (!kChunk) {
      mbar_wait(bar_head, 0u);
      const unsigned char* whb = smem + p.plan.headw;
      w_h1 = reinterpret_cast<const W*>(whb);
      w_h2 = reinterpret_cast<const W*>(whb + wh1_bytes);
      b_h1 = reinterpret_cast<const float*>(whb + wh1_bytes + wh2_bytes);
      b_h2 = b_h1 + Sq;
    }
    mbar_wait(bar_hx, h_round & 1);
    if (tid == 0) mbar_expect_tx(bar_hx, s_bytes);
    if constexpr (kBf16) {
      auto h1_tile = [&](int tile, int mt, const float* acc, float b0, float b1) {
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = fmaxf(acc[i] + ((i & 1) ? b1 : b0), 0.0f);
        send_tile(CS, o1 + 16 * mt * ss, ss, rank * Sq + tile * 8, v, bar_o1);
      };
      if constexpr (kChunk) {
        tiles_pass(2, KSsk, Sq, hx, ss, Sq >> 3, no_skip, h1_tile);
      } else {
        for (int item = warp; item < (Sq >> 3) * kTiles; item += NW) {
          const int tile = item / kTiles, mt = item % kTiles;
          float acc[1][4];
          mma_chain<1>(w_h1, p.plan.Ksk, Sq, 0, 1, &tile, hx + 16 * mt * ss, ss, acc);
          h1_tile(tile, mt, acc[0], b_h1[tile * 8 + 2 * t4], b_h1[tile * 8 + 2 * t4 + 1]);
        }
      }
    } else {
      auto h1_out = [&](int row, int col, float acc, const float* bias) {
        send(CS, o1, row * ss + rank * Sq + col, fmaxf(acc + bias[col], 0.0f), bar_o1);
      };
      if constexpr (kChunk) {
        cols_pass(2, KSsk, Sq, hx, ss, no_skip, h1_out);
      } else {
        Walk w = walk_s;
        for (int e = tid; e < M * Sq; e += nthr, w.next()) {
          float acc[1];
          fma_chain<1>(w_h1, p.plan.Ksk, Sq, &w.col, hx + w.row * ss, acc);
          h1_out(w.row, w.col, acc[0], b_h1);
        }
      }
    }
    if (j + 1 < p.n) set_mods(j + 1);
    sync();
    // the rest of the last layer's block is read out too
    if (filler && refill && issued[1] < total_layers) fill(1);
    WN_STAMP(2 + 6 * L);
    // The barrier's second half: every CTA's ring writes of this step are
    // visible. What the next step's first two layers need starts its way.
    cluster_wait();
    if (j + 1 < p.n) {
      const int* next_mod = l_mods + ((j + 1) & 1) * L;
      taps_load(pre0, 0, 1, next_mod[0]);
      if (L > 1) taps_load(pre1, l_off[1], l_dil[1], next_mod[1]);
      cond_load(prec, j + 1);
    }
    mbar_wait(bar_o1, h_round & 1);
    ++h_round;
    if (tid == 0) mbar_expect_tx(bar_o1, s_bytes);
    if constexpr (kBf16) {
      auto h2_tile = [&](int tile, int mt, const float* acc, float b0, float b1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = 16 * mt + g + 8 * (i >> 1), c = tile * 8 + 2 * t4 + (i & 1);
          lo[row * Cq + c] = acc[i] + ((i & 1) ? b1 : b0);
        }
      };
      if constexpr (kChunk) {
        tiles_pass(3, KSsk, Cq, o1, ss, Cq >> 3, no_skip, h2_tile);
      } else {
        for (int item = warp; item < (Cq >> 3) * kTiles; item += NW) {
          const int tile = item / kTiles, mt = item % kTiles;
          float acc[1][4];
          mma_chain<1>(w_h2, p.plan.Ksk, Cq, 0, 1, &tile, o1 + 16 * mt * ss, ss, acc);
          h2_tile(tile, mt, acc[0], b_h2[tile * 8 + 2 * t4], b_h2[tile * 8 + 2 * t4 + 1]);
        }
      }
    } else {
      auto h2_out = [&](int row, int col, float acc, const float* bias) {
        lo[row * Cq + col] = acc + bias[col];
      };
      if constexpr (kChunk) {
        cols_pass(3, KSsk, Cq, o1, ss, no_skip, h2_out);
      } else {
        Walk w = walk_c;
        for (int e = tid; e < M * Cq; e += nthr, w.next()) {
          float acc[1];
          fma_chain<1>(w_h2, p.plan.Ksk, Cq, &w.col, o1 + w.row * ss, acc);
          h2_out(w.row, w.col, acc[0], b_h2);
        }
      }
    }
    sync();
    WN_STAMP(3 + 6 * L);
    // ---- sampling, SL lanes a stream: a warp for one row tile, for two a
    // group of 8 lanes (four streams a warp at once). Categorical: each
    // CTA's best of its classes to every CTA, then the reduction over the
    // cluster. Scalar heads: the same in every CTA. Rank 0 writes.
    constexpr int SL = kTiles == 1 ? 32 : 8;
    const int sl = lane & (SL - 1);
    for (int b0 = warp * (32 / SL); b0 < nvalid; b0 += NW * (32 / SL)) {
      const int bi = b0 + lane / SL;   // below M: lo has the row
      const bool live = bi < nvalid;
      const int b = base + bi;
      const float* o = lo + bi * Cq;
      const uint32_t key = mix32(mix32(mix32(p.seed) ^ (uint32_t)b) ^ (uint32_t)t);
      if (split) {
        // argmax of this CTA's logits (+ Gumbel noise, keyed by the class);
        // ties go to the lowest class
        float best = -INFINITY;
        int arg = C_out;
        for (int c = sl, cls = rank * Cq + sl; c < Cq && cls < C_out; c += SL, cls += SL) {
          float v = o[c];
          if (!p.deterministic) v -= logf(-logf(uniform(key, (uint32_t)cls)));
          if (v > best || arg == C_out) { best = v; arg = cls; }
        }
        for (int m = SL / 2; m > 0; m >>= 1) {
          float ob = __shfl_xor_sync(0xffffffffu, best, m);
          int oa = __shfl_xor_sync(0xffffffffu, arg, m);
          if (ob > best || (ob == best && oa < arg)) { best = ob; arg = oa; }
        }
        // the group's first lane's candidate, its lane r to CTA r
        best = __shfl_sync(0xffffffffu, best, lane & ~(SL - 1));
        arg = __shfl_sync(0xffffffffu, arg, lane & ~(SL - 1));
        if (live && sl < CS)
          st_async(map_rank(smem_u32(cand + bi * CS + rank), sl), __float_as_uint(best),
                   (uint32_t)arg, map_rank(smem_u32(bar_cd), sl));
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
          for (int c = sl; c < nr; c += SL) {
            float v = o[c];
            if (!p.deterministic) v -= logf(-logf(uniform(key, (uint32_t)c)));
            if (sel == nr || v > best) { best = v; sel = c; }
          }
          for (int m = SL / 2; m > 0; m >>= 1) {
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
          if (p.plan.head == 2) {
            const uint32_t d0 = C_out == 2 ? 0u : (uint32_t)nr;
            float u0 = uniform(key, d0), u1 = uniform(key, d0 + 1);
            x = mean + expf(ls) * (sqrtf(-2.0f * logf(u0)) * cosf(6.28318530717958647692f * u1));
          } else if (C_out != 2) {
            float u = uniform(key, (uint32_t)nr);
            x = mean + expf(ls) * (logf(u) - logf(1.0f - u));
          }
        }
        x = fminf(fmaxf(x, -1.0f), 1.0f);
        if (live && sl == 0) {
          if (rank == 0) static_cast<float*>(p.out)[b * p.out_sb + j] = x;
          xc[bi * C_in] = x;
        }
      }
    }
    if (split) {
      // every CTA reduces the CS candidates of a stream in rank order, ties
      // to the lower class, and so reaches the same code. The buffer is free
      // again before any peer sends the next step's: that comes after this
      // CTA's next gated slice, which comes after the sync below.
      mbar_wait(bar_cd, c_round & 1);
      ++c_round;
      if (tid == 0) mbar_expect_tx(bar_cd, c_bytes);
      for (int bi = tid; bi < nvalid; bi += nthr) {
        float best = __uint_as_float(cand[bi * CS].x);
        int arg = (int)cand[bi * CS].y;
        for (int r = 1; r < CS; ++r) {
          const float ob = __uint_as_float(cand[bi * CS + r].x);
          const int oa = (int)cand[bi * CS + r].y;
          if (ob > best || (ob == best && oa < arg)) { best = ob; arg = oa; }
        }
        if (arg >= C_out) arg = C_out - 1;
        code[bi] = arg;
        if (rank == 0) static_cast<int*>(p.out)[(base + bi) * p.out_sb + j] = arg;
      }
    }
    sync();
    WN_STAMP(4 + 6 * L);
  }

  // the last input: x_cur, for the categorical head the one-hot rows of its codes
  if (rank == 0)
    for (int e = tid; e < M * C_in; e += nthr) {
      const int bi = e / C_in;
      if (bi < nvalid)
        p.x_cur[(size_t)(base + bi) * C_in + e % C_in] =
            split ? (e % C_in == code[bi] ? 1.0f : 0.0f) : xc[e];
    }
  // no CTA leaves while a peer may still send into its shared memory
  cluster_arrive();
  cluster_wait();
}


// info (host, may be null): [stages or chunk slots in shared memory, head
// weights resident, dynamic shared-memory bytes, clusters the card can hold
// at once, chunk ring]
template <typename W, bool kChunk, int kTiles>
cudaError_t launch_ring(const Params& p, int* info, cudaStream_t stream) {
  const Plan& q = p.plan;
  if (q.total > (int)kSmemLimit) return cudaErrorInvalidValue;
  auto kernel = generate_kernel<W, kChunk, kTiles>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, q.total);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((p.B + q.spc - 1) / q.spc) * q.CS));
  cfg.blockDim = dim3((unsigned)(kThreads + (kChunk ? kFillThreads : 0)));
  cfg.dynamicSmemBytes = (size_t)q.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)q.CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (info != nullptr) {
    info[0] = q.nstage;
    info[1] = q.head_res;
    info[2] = q.total;
    info[3] = -1;
    info[4] = kChunk;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) == cudaSuccess)
      info[3] = clusters;
    else
      (void)cudaGetLastError();
  }
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The plan as received, checked where a wrong one would overrun or hang:
// whole-layer stages with the head's block resident, on one or two row tiles;
// or the chunk ring, on one, whose every chunk with its biases fits its slot
// and whose passes cover every unit of each product.
template <typename W>
cudaError_t launch(const Params& p, int* info, cudaStream_t stream) {
  const Plan& q = p.plan;
  if (q.nstage < 1 || q.tiles < 1 || q.tiles > kMaxTiles || q.spc > kTileRows * q.tiles)
    return cudaErrorInvalidValue;
  if (q.head_res) {
    if (q.slot_bytes != 0 || q.nstage > q.L) return cudaErrorInvalidValue;
    return q.tiles == 1 ? launch_ring<W, false, 1>(p, info, stream)
                        : launch_ring<W, false, kMaxTiles>(p, info, stream);
  }
  if (q.tiles != 1) return cudaErrorInvalidValue;
  const int rows = sizeof(W) == 2 ? 16 : 1;   // rows a step of the chunk ring
  const int KS[4] = {q.Kin / rows, q.Kog / rows, q.Ksk / rows, q.Ksk / rows};
  const int N[4] = {2 * q.Gq, q.Rq + q.Sq, q.Sq, q.Cq};
  for (int d = 0; d < 4; ++d) {
    // units: bf16 n-tiles (w_in: pairs of them, in kSplitIn parts), a warp
    // a unit; f32 outputs (w_in: gate channels of a stream), a thread each
    const long long units = sizeof(W) == 2 ? (d == 0 ? N[0] / 16 * kSplitIn : N[d] / 8)
                                           : (long long)kTileRows * (d == 0 ? q.Gq : N[d]);
    const long long workers = sizeof(W) == 2 ? kThreads / 32 : kThreads;
    const long long chunk =
        (long long)(q.ck[d] < KS[d] ? q.ck[d] : KS[d]) * rows * N[d] * sizeof(W) + 4 * N[d];
    if (q.ck[d] < 1 || chunk > q.slot_bytes || (long long)q.passes[d] * kUnits * workers < units)
      return cudaErrorInvalidValue;
  }
  return launch_ring<W, true, 1>(p, info, stream);
}

}  // namespace

// plan: a struct Plan (host memory, ops/cuda_generate.py Plan.struct). trace:
// device buffer of 6 L + 5 clock stamps, or null. info: 5 host ints or null.
extern "C" int wn_generate(const void* w_first, const void* b_first, const void* wl,
                           const void* wh, const void* cond, long long cond_sb,
                           const void* g_gate, void* ring, void* x_cur, void* out,
                           long long out_sb, int B, int n, int t0, unsigned int seed,
                           int deterministic, const void* plan, int* info, void* trace,
                           void* stream) {
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
  p.deterministic = deterministic;
  p.plan = *static_cast<const Plan*>(plan);
  const Plan& q = p.plan;
  if (q.CS < 1 || q.CS > 8 || (q.CS & (q.CS - 1)) || q.spc < 1 || B < 1 || q.k < 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return q.bf16 ? (int)launch<__nv_bfloat16>(p, info, s) : (int)launch<float>(p, info, s);
}
