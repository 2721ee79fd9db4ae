// Tensor-core pieces of the bf16 residual-stack training kernels
// (train_fwd.cu, train_bwd.cu): cp.async staging of bf16 tiles into shared
// memory, ldmatrix fragment loads, and a block product that streams one
// operand through a ring of shared-memory stages into
// mma.sync.aligned.m16n8k16 (bf16 in, f32 sums).
//
// Why mma.sync and not wgmma: every operand here is a 64-row tile whose rows
// are gathered (dilated taps, shifted dz, position chunks that cross batch
// rows), and the same product code serves four operand layouts (row- and
// column-major A and B). ldmatrix (with .trans where the contraction axis is
// the slow one) reads all four from one padded row-major tile, with no
// swizzled descriptors and no tensor maps; generate.cu's mma.sync products
// are the pattern. wgmma with TMA is a later step once these kernels are
// bound by their products rather than by staging and epilogues.
//
// Block shape: warps in rows of 4; warp (wm, wn) = (warp / 4, warp % 4)
// owns rows [32 wm, 32 wm + 32) of the block product as two 16-row mma tiles
// and NT 8-column tiles whose columns the caller names (col(j), with
// col(2i + 1) == col(2i) + 8, so a pair loads with one ldmatrix).
//
// Shared-memory tiles are row-major bf16 with a row stride (`ld`, in
// elements) from pad_ld: a multiple of 8 elements (16 bytes, as ldmatrix
// and cp.async need) that is an odd number of 16-byte units, so the 8 rows
// an ldmatrix matrix reads fall on distinct bank groups.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "train_common.cuh"

namespace wn {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr size_t kSmemLimit = 232448;    // dynamic shared memory a block may have

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ inline int pad_ld(int x) {
  int u = (x + 7) / 8;
  if (!(u & 1)) ++u;
  return u * 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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

// 8 bf16 from src[0, n) into the 16-byte aligned dst, zeros for [n, 8). A full
// piece from a 16-byte aligned source goes by cp.async; a ragged or unaligned
// one (a row stride that is not a multiple of 8 elements, as cin = 20) is
// copied element by element; n <= 0 (outside the operand: causal zeros,
// t >= T, padding) stores zeros and reads nothing.
__device__ __forceinline__ void stage8(bf16* dst, const bf16* src, int n) {
  if (n >= 8 && ((uintptr_t)src & 15) == 0) {
    cp_async16(dst, src);
  } else if (n <= 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  } else {
    const bf16 zero = __float2bfloat16(0.0f);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = i < n ? src[i] : zero;
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of the 16 x 16 tile at (row r0, depth k0).
// AT = false: A is [row][k] (k contiguous); AT = true: A is [k][row].
template <bool AT>
__device__ __forceinline__ void load_a(const bf16* A, int ld, int r0, int k0, uint32_t (&f)[4]) {
  const int i = threadIdx.x & 31;
  if (AT)
    ldsm_x4_t(smem_u32(A + (k0 + (i & 7) + (i >> 4) * 8) * ld + r0 + ((i >> 3) & 1) * 8), f);
  else
    ldsm_x4(smem_u32(A + (r0 + (i & 15)) * ld + k0 + (i >> 4) * 8), f);
}

// B fragments of the two 8-column tiles at columns c and c + 8, depth k0:
// f[0], f[1] for tile c, f[2], f[3] for tile c + 8.
// BT = true: B is [k][col] (columns contiguous); BT = false: B is [col][k].
template <bool BT>
__device__ __forceinline__ void load_b(const bf16* Bs, int ld, int c, int k0, uint32_t (&f)[4]) {
  const int i = threadIdx.x & 31;
  if (BT)
    ldsm_x4_t(smem_u32(Bs + (k0 + (i & 15)) * ld + c + (i >> 4) * 8), f);
  else
    ldsm_x4(smem_u32(Bs + (c + (i & 7) + (i >> 4) * 8) * ld + k0 + ((i >> 3) & 1) * 8), f);
}

// Where a thread's accumulator values land: acc[mi][j][v] is row
// 32 wm + 16 mi + g + 8 (v >> 1), column col(j) + 2 t + (v & 1).
struct Frag {
  int wm, wn, g, t;
  __device__ __forceinline__ Frag() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    wm = warp >> 2;
    wn = warp & 3;
    g = lane >> 2;
    t = lane & 3;
  }
  __device__ __forceinline__ int row(int mi, int v) const { return 32 * wm + 16 * mi + g + 8 * (v >> 1); }
};

// acc = A (32 x warps/4 rows, K deep) @ B (K x columns named by col), the depth cut into
// `nslices` slices of BKW. B (and, for AT, A) arrive slice by slice through a
// ring of STAGES shared-memory stages of `stage_elems` elements each:
// load(s, stage) issues the cp.async copies (and zero stores) of slice s
// into `stage`. Inside a stage, A sits at offset 0 ([BKW][a_ld]) when AT and B
// at `b_off` with row stride b_ld ([BKW][b_ld] for BT, [cols][b_ld] else).
// Without AT, A is resident: [rows][a_ld] at `A`, slice s at columns
// [s BKW, s BKW + BKW). prep(s, stage) runs after slice s has arrived and
// before it is used; when it returns true (uniformly over the block) it wrote
// the stage and a barrier follows. Ends with every copy landed and a barrier,
// so the caller may reuse the ring.
//
// -DWN_NO_PRODUCTS compiles the ldmatrix/mma loop out and keeps the staging,
// barriers and epilogues (acc stays 0): a timing aid, its results mean
// nothing.
template <int NT, int BKW, int STAGES, bool AT, bool BT, typename Load, typename Prep,
          typename Col>
__device__ __forceinline__ void ring_product(float (&acc)[2][NT][4], const bf16* A, int a_ld,
                                             int nslices, bf16* ring, int stage_elems, int b_off,
                                             int b_ld, Load load, Prep prep, Col col) {
  static_assert(NT % 2 == 0 && BKW % 16 == 0 && STAGES >= 2, "tile shape");
  const Frag fr;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mi][j][v] = 0.0f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nslices) load(s, ring + s * stage_elems);
    cp_async_commit();
  }
  for (int s = 0; s < nslices; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    bf16* stage = ring + (s % STAGES) * stage_elems;
    if (prep(s, stage)) __syncthreads();
    const int nx = s + STAGES - 1;
    if (nx < nslices) load(nx, ring + (nx % STAGES) * stage_elems);
    cp_async_commit();
#ifndef WN_NO_PRODUCTS
    const bf16* As = AT ? stage : A;
    const bf16* Bs = stage + b_off;
#pragma unroll
    for (int kk = 0; kk < BKW; kk += 16) {
      const int ka = AT ? kk : s * BKW + kk;
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) load_a<AT>(As, a_ld, 32 * fr.wm + 16 * mi, ka, af[mi]);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bfr[4];
        load_b<BT>(Bs, b_ld, col(j), kk, bfr);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma16816(acc[mi][j], af[mi], bfr[0], bfr[1]);
          mma16816(acc[mi][j + 1], af[mi], bfr[2], bfr[3]);
        }
      }
    }
#endif
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Stage slice s (depth [s BK, s BK + BK)) of the transposed weight w^T for
// output columns [n0, n0 + 128) into [128][BK + 8] (B of a product with the
// contraction axis contiguous, as w is stored): row(n, kk) points at depth
// kk of column n's row of w, or is null past the output; depth K ends the
// rows (zeros beyond).
constexpr int kWtCols = 128;
template <int BK, int kThreads, typename Row>
__device__ __forceinline__ void stage_wt(bf16* stage, int s, int n0, int K, Row row) {
  for (int e = threadIdx.x; e < kWtCols * (BK / 8); e += kThreads) {
    const int x = e / (BK / 8), h = e % (BK / 8), k0 = s * BK + 8 * h;
    const bf16* src = k0 < K ? row(n0 + x, k0) : nullptr;
    stage8(stage + x * (BK + 8) + 8 * h, src, src ? K - k0 : 0);
  }
}

// tanh and sigmoid from one __expf and one fast divide each: relative error
// ~1e-6, far below the bf16 rounding that gated and dz take next. Clamped
// where the result is already +-1 (or 0, 1) in f32.
__device__ __forceinline__ float tanh_fast(float x) {
  const float u = __expf(2.0f * fminf(fmaxf(x, -15.0f), 15.0f));
  return __fdividef(u - 1.0f, u + 1.0f);
}
__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-fminf(fmaxf(x, -30.0f), 30.0f)));
}

struct NoPrep {
  __device__ __forceinline__ bool operator()(int, bf16*) const { return false; }
};

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Sum over the 32 rows a warp holds (both mma tiles, both row halves) of the
// pair of columns (2t, 2t + 1) of tile j; lanes 0-3 end with the sums.
template <int NT>
__device__ __forceinline__ float2 warp_col_sum(const float (&x)[2][NT][4], int j) {
  float s0 = x[0][j][0] + x[0][j][2] + x[1][j][0] + x[1][j][2];
  float s1 = x[0][j][1] + x[0][j][3] + x[1][j][1] + x[1][j][3];
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
  }
  return make_float2(s0, s1);
}

// ------------------------------------------------- the z product of a tile
// z = [taps | c] @ [w_in; w_cond] + b_in (+ gb) for the ROWS positions [t0,
// t0 + ROWS) of batch row b: the forward and bwd_dz's recompute share it, so
// both see the same z. The A operand (taps of x_l, then c, zero-padded to a
// multiple of 16) is staged once and stays resident; the weights stream in
// slices of BK rows, each slice holding 128 columns of the a-half and the
// same 128 columns of the b-half, so that thread i holds a[g] and b[g] in the
// same accumulator slots (acc[.][j] and acc[.][j + 4]) and the GLU (or its
// derivative) needs no shared memory. A gate width above 128 takes several
// passes over the resident operand.
//
// A position tile of ROWS rows has ROWS / 32 x 4 warps (4 ROWS threads):
// each weight slice that reaches the block serves ROWS positions, so ROWS
// sets the L2 traffic of the streamed weights.
template <int ROWS> struct Tile {
  static constexpr int kThreads = 4 * ROWS, kWarps = ROWS / 8;
};

constexpr int kZCols = 128;
constexpr int kZld = 2 * kZCols + 8;     // pad_ld(256)

// The resident operand's depth: K = k*R + cin, zero-padded to Kp, a whole
// number of weight slices of BK rows.
struct ZLayout {
  int kR, cin, K, Kp, a_ld;
  __host__ __device__ ZLayout(const TrainArgs& a, int bk) : kR(a.k * a.R), cin(a.c ? a.cin : 0) {
    K = kR + cin;
    Kp = round_up(K, bk);
    a_ld = pad_ld(Kp);
  }
};

// Issue the copies of the z operand of the tile into As ([ROWS][a_ld]):
// piece p of a row (8 columns) is tap j's channels, c's, or padding up to Kp. Rows
// past T and taps before t = 0 are zeros. Commits one cp.async group.
template <int ROWS>
__device__ __forceinline__ void issue_z_operand(const TrainArgs& a, const ZLayout& z, int b,
                                                int t0, bf16* As) {
  const int np = z.Kp / 8, R = a.R;
  const bf16* xs = static_cast<const bf16*>(a.xs_l);
  const bf16* c = static_cast<const bf16*>(a.c);
  for (int e = threadIdx.x; e < ROWS * np; e += Tile<ROWS>::kThreads) {
    const int m = e / np, col = 8 * (e - m * np), tm = t0 + m;
    const bf16* src = xs;
    int n = 0;
    if (tm < a.T) {
      if (col < z.kR) {
        const int j = col / R, r = col - j * R, t = tm - (a.k - 1 - j) * a.d;
        if (t >= 0) {
          src = xs + ((long long)b * a.T + t) * R + r;
          n = 8;
        }
      } else if (col < z.K) {
        src = c + ((long long)b * a.T + tm) * z.cin + (col - z.kR);
        n = z.K - col;
      }
    }
    stage8(As + m * z.a_ld + col, src, n);
  }
  cp_async_commit();
}

// Wait for the operand; under dropout, mask and rescale the staged taps in
// place (rounded as conv_input rounds). Ends with a barrier.
template <int ROWS>
__device__ __forceinline__ void finish_z_operand(const TrainArgs& a, const ZLayout& z, int b,
                                                 int t0, bf16* As) {
  cp_async_wait<0>();
  __syncthreads();
  if (!a.has_drop) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int m = warp; m < ROWS; m += Tile<ROWS>::kWarps) {
    for (int x = lane; x < z.kR; x += 32) {
      const int j = x / a.R, r = x - j * a.R, t = t0 + m - (a.k - 1 - j) * a.d;
      if (t < 0 || t0 + m >= a.T) continue;
      bf16* p = As + m * z.a_ld + x;
      *p = keep_bit(a, b, t, r) ? __float2bfloat16(__bfloat162float(*p) * a.inv_keep)
                                : __float2bfloat16(0.0f);
    }
  }
  __syncthreads();
}

// acc = z without its bias, for a-columns [c0, c0 + 128) and the matching
// b-columns; warp (wm, wn) holds a-columns c0 + 32 wn + 8 j + ... in acc[.][j]
// and the b-columns G/2 + (the same) in acc[.][j + 4], j < 4. The weights
// come through a ring of STAGES slices of BK rows ([BK][kZld] each).
template <int ROWS, int BK, int STAGES>
__device__ __forceinline__ void z_product(float (&acc)[2][8][4], const TrainArgs& a,
                                          const ZLayout& z, const bf16* As, bf16* ring, int c0) {
  const int G = a.G, G2 = G / 2, l = a.l, wn = threadIdx.x >> 5 & 3;
  const bf16* w_in = static_cast<const bf16*>(a.w_in) + (long long)l * z.kR * G;
  const bf16* w_cond = a.c ? static_cast<const bf16*>(a.w_cond) + (long long)l * z.cin * G
                           : nullptr;
  auto load = [&](int s, bf16* stage) {
    for (int e = threadIdx.x; e < BK * 32; e += Tile<ROWS>::kThreads) {
      const int r = e >> 5, p = e & 31;
      const int half = p >> 4, x = (p & 15) * 8, kk = s * BK + r;
      const bf16* row = kk < z.kR ? w_in + (long long)kk * G
                      : kk < z.K  ? w_cond + (long long)(kk - z.kR) * G
                                  : nullptr;
      const int n = row ? G2 - (c0 + x) : 0;
      stage8(stage + r * kZld + half * kZCols + x, row ? row + half * G2 + c0 + x : w_in, n);
    }
  };
  ring_product<8, BK, STAGES, false, true>(
      acc, As, z.a_ld, z.Kp / BK, ring, BK * kZld, 0, kZld, load, NoPrep(),
      [&](int j) { return (j >> 2) * kZCols + 32 * wn + 8 * (j & 3); });
}

// z += b_in (+ gb) on the columns a pass holds.
__device__ __forceinline__ void add_z_bias(float (&acc)[2][8][4], const TrainArgs& a, int b,
                                           int c0) {
  const Frag fr;
  const int G = a.G, G2 = G / 2;
  const float* bi = a.b_in + (long long)a.l * G;
  const float* gb = a.gb ? a.gb + ((long long)a.l * a.B + b) * G : nullptr;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int gc = c0 + 32 * fr.wn + 8 * j + 2 * fr.t + e;
      if (gc >= G2) continue;
      const float ba = bi[gc] + (gb ? gb[gc] : 0.0f);
      const float bb = bi[G2 + gc] + (gb ? gb[G2 + gc] : 0.0f);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[mi][j][2 * h + e] += ba;
          acc[mi][j + 4][2 * h + e] += bb;
        }
    }
}

}  // namespace tc
}  // namespace wn
