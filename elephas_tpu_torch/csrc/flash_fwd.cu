// Flash-attention forward for Hopper (sm_90a), one kernel for every layout.
//
// Replaces the Pallas TPU kernels of elephas_tpu/ops/flash_attention.py:
//   _fwd_kernel (reached through _flash_forward, the [BH, S, D] layout, and
//   _flash_forward_packed, the packed [B, S, 3, H, D] qkv layout) and
//   _fwd_kernel_grouped (_flash_forward_packed_grouped, head_dim 64).
// The TPU kernels cut the packed layout with BlockSpec index maps and lane-
// packed two 64-wide heads into one 128-lane tile; here the kernel takes
// element strides (batch, head, seq) for q, k, v and out instead, so the
// packed qkv, the [B, H, S, D] layout and the sequence-major [B, S, H, D]
// output share one launch path with no transpose copies, and D = 64 is a
// native width with no lane packing.
//
// What it computes, per (batch, head): s = q.k^T * scale in fp32, the causal
// mask cols <= rows on absolute positions filled with -1e30, an online
// softmax with m, l and acc in fp32, p = 0 while m <= -5e29 (rows masked so
// far output zeros with lse -1e30), out = acc / (l == 0 ? 1 : l) in the input
// type and lse = m + log(safe_l) in fp32. p and the rescale factor are
// exp2f((x - m) * log2 e); lse uses logf.
//
// What bounds it on the H100: causal attention at the serving shapes does
// 2*BH*S^2*D flops on 4*BH*S*D elements, far above the card's ridge in fp32
// on the FMA units (67 TFLOP/s, where this kernel's earlier design ran)
// and near it in bf16 on the tensor cores. So the products run on the
// tensor cores through warp-level mma.sync:
//  - bf16: m16n8k16 for s = q.k^T and for acc += p.v, with p rounded to bf16
//    in registers (the C fragments of two n8 score tiles are the A fragment
//    of the next mma); m, l and acc stay fp32.
//  - fp32: 3xTF32 on m16n8k8. Each operand splits into hi (x with the 13
//    low mantissa bits cleared) and lo = x - hi (exact), and a product is
//    lo.hi + hi.lo + hi.hi accumulated in fp32: about 1e-6 relative, fp32
//    accuracy, at a third of the TF32 rate (495 / 3 TFLOP/s, 2.5x the FMA
//    peak). The k index of each mma is permuted, so q and k fragments of
//    two k-steps load as one 128-bit word and the score C fragment is the
//    p A fragment with no shuffle.
// Each warp owns 16 q rows with its score tile and output accumulator in
// registers; a block is 4 or 8 warps (the wrapper picks from the shape)
// sharing K/V tiles staged in shared memory in the input type by
// 16-byte cp.async copies (rows past S zero-filled) in a ring of two
// stages: the copy of tile j + 1 runs under the mma of tile j, with one
// barrier per tile. Row padding keeps the fragment loads (ldmatrix,
// ldmatrix.trans for V, 128-bit lds for fp32 q and k) free of bank
// conflicts. Causal kv tiles wholly above a warp's rows are skipped, only
// edge tiles are masked, and the q tiles further down (more work) start
// first. What still bounds it (PERF.md): each warp reads every K/V tile
// from shared memory for 16 rows, with 8 warps on an SM (registers), and
// in causal grids of one wave the last q tile's walk over all keys.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxWarps = 8;
constexpr int kStages = 2;

// element strides of one [B, H, S, D] operand; D has unit stride
struct Strides {
  long long b, h, s;
};

// Shared-memory layout of one block, in elements of T: the q tile
// (16 * warps rows), then kStages stages of a K tile and a V tile.
template <typename T, int D>
struct Tile {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  // fp32 at D = 128 takes 32-key tiles: registers and shared memory
  static constexpr int kBlockK = (kF32 && D == 128) ? 32 : 64;
  // bf16: rows 16 bytes apart in the banks for ldmatrix; fp32 q and k:
  // two rows 16 words apart for 128-bit loads; fp32 v: rows 4 words apart
  static constexpr int kQKStride = !kF32 ? D + 8 : ((D + 16) % 32 == 16 ? D + 16 : D + 32);
  static constexpr int kVStride = kF32 ? D + 4 : D + 8;
  static constexpr int kStage = kBlockK * (kQKStride + kVStride);
  static int smem_bytes(int block_q) {
    return (block_q * kQKStride + kStages * kStage) * static_cast<int>(sizeof(T));
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo: hi keeps the 10 mantissa bits a tf32 operand holds (by
// truncation: one AND), lo = x - hi is exact in fp32. The tensor core
// reads only lo's top 10 mantissa bits; what it drops is below 2^-21 of
// |x|, so lo.hi + hi.lo + hi.hi keeps fp32 accuracy.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a.b in fp32 accuracy: the small products first, then hi.hi
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(c, a_lo, b_hi[0], b_hi[1]);
  mma_tf32(c, a_hi, b_lo[0], b_lo[1]);
  mma_tf32(c, a_hi, b_hi[0], b_hi[1]);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Rows [row0, row0 + rows) of one [S, D] slice into shared memory (row
// stride `stride` elements) by 16-byte copies; rows at or past n_rows are
// zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, int stride, const T* src, long long seq_stride,
                                          int row0, int n_rows, int rows) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kChunks = D / kVec;
  for (int e = threadIdx.x; e < rows * kChunks; e += blockDim.x) {
    const int r = e / kChunks, c = (e % kChunks) * kVec;
    const int g = row0 + r;
    const bool in = g < n_rows;
    cp_async16(dst + r * stride + c, src + (in ? g * seq_stride : 0) + c, in ? 16 : 0);
  }
}

// kv tile `tile` (keys tile * BK..) of k and v into its stage of the ring
template <typename T, int D>
__device__ __forceinline__ void load_kv(T* KVs, const T* k, long long k_ss, const T* v,
                                        long long v_ss, int tile, int Sk) {
  using Cfg = Tile<T, D>;
  constexpr int BK = Cfg::kBlockK;
  T* Ks = KVs + (tile % kStages) * Cfg::kStage;
  load_rows<T, D>(Ks, Cfg::kQKStride, k, k_ss, tile * BK, Sk, BK);
  load_rows<T, D>(Ks + BK * Cfg::kQKStride, Cfg::kVStride, v, v_ss, tile * BK, Sk, BK);
}

// s[n] (keys 8n.., C fragments) = q.k^T for one warp's 16 rows (Qw: its
// first row), bf16
template <int D, int NT>
__device__ __forceinline__ void scores_bf16(float (&s)[NT][4], const __nv_bfloat16* Qw,
                                            const __nv_bfloat16* Ks, int lane) {
  constexpr int kStride = Tile<__nv_bfloat16, D>::kQKStride;
  const int mat = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t qf[4];
    ldmatrix_x4(qf, Qw + (r + (mat & 1) * 8) * kStride + kk * 16 + (mat >> 1) * 8);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t kb[4];
      ldmatrix_x4(kb, Ks + ((n + (mat >> 1)) * 8 + r) * kStride + kk * 16 + (mat & 1) * 8);
      mma_bf16(s[n], qf, kb[0], kb[1]);
      mma_bf16(s[n + 1], qf, kb[2], kb[3]);
    }
  }
}

// acc[n] (columns 8n..) += p.v, p rounded to bf16
template <int D, int NT>
__device__ __forceinline__ void pv_bf16(float (&acc)[D / 8][4], const float (&p)[NT][4],
                                        const __nv_bfloat16* Vs, int lane) {
  constexpr int kStride = Tile<__nv_bfloat16, D>::kVStride;
  const int mat = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const uint32_t pa[4] = {
        pack_bf16(p[2 * kk][0], p[2 * kk][1]), pack_bf16(p[2 * kk][2], p[2 * kk][3]),
        pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
        pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, Vs + (kk * 16 + (mat & 1) * 8 + r) * kStride + (n + (mat >> 1)) * 8);
      mma_bf16(acc[n], pa, vb[0], vb[1]);
      mma_bf16(acc[n + 1], pa, vb[2], vb[3]);
    }
  }
}

// s[n] = q.k^T for one warp's 16 rows, fp32 by 3xTF32. The k index is
// permuted: in each 16-column chunk thread t loads columns 4t..4t+3 of q
// and k as one 128-bit word; the first k-step's index t and t + 4 are
// columns 4t and 4t + 1, the second's 4t + 2 and 4t + 3.
template <int D, int NT>
__device__ __forceinline__ void scores_f32(float (&s)[NT][4], const float* Qw, const float* Ks,
                                           int g, int t) {
  constexpr int kStride = Tile<float, D>::kQKStride;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const float4 qa = *reinterpret_cast<const float4*>(Qw + g * kStride + kc * 16 + 4 * t);
    const float4 qb = *reinterpret_cast<const float4*>(Qw + (g + 8) * kStride + kc * 16 + 4 * t);
    uint32_t a_hi[2][4], a_lo[2][4];
    split_tf32(qa.x, a_hi[0][0], a_lo[0][0]);
    split_tf32(qb.x, a_hi[0][1], a_lo[0][1]);
    split_tf32(qa.y, a_hi[0][2], a_lo[0][2]);
    split_tf32(qb.y, a_hi[0][3], a_lo[0][3]);
    split_tf32(qa.z, a_hi[1][0], a_lo[1][0]);
    split_tf32(qb.z, a_hi[1][1], a_lo[1][1]);
    split_tf32(qa.w, a_hi[1][2], a_lo[1][2]);
    split_tf32(qb.w, a_hi[1][3], a_lo[1][3]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float4 kb = *reinterpret_cast<const float4*>(Ks + (n * 8 + g) * kStride + kc * 16 + 4 * t);
      uint32_t b_hi[2][2], b_lo[2][2];
      split_tf32(kb.x, b_hi[0][0], b_lo[0][0]);
      split_tf32(kb.y, b_hi[0][1], b_lo[0][1]);
      split_tf32(kb.z, b_hi[1][0], b_lo[1][0]);
      split_tf32(kb.w, b_hi[1][1], b_lo[1][1]);
      mma_3xtf32(s[n], a_hi[0], a_lo[0], b_hi[0], b_lo[0]);
      mma_3xtf32(s[n], a_hi[1], a_lo[1], b_hi[1], b_lo[1]);
    }
  }
}

// acc[n] += p.v in fp32 by 3xTF32. With the k index permuted (index t is
// key 2t, t + 4 is key 2t + 1) the C fragment of score tile j is the A
// fragment of keys 8j..8j+7, with no shuffle.
template <int D, int NT>
__device__ __forceinline__ void pv_f32(float (&acc)[D / 8][4], const float (&p)[NT][4],
                                       const float* Vs, int g, int t) {
  constexpr int kStride = Tile<float, D>::kVStride;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t a_hi[4], a_lo[4];
    split_tf32(p[j][0], a_hi[0], a_lo[0]);
    split_tf32(p[j][2], a_hi[1], a_lo[1]);
    split_tf32(p[j][1], a_hi[2], a_lo[2]);
    split_tf32(p[j][3], a_hi[3], a_lo[3]);
    const float* v0 = Vs + (j * 8 + 2 * t) * kStride + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t b_hi[2], b_lo[2];
      split_tf32(v0[n * 8], b_hi[0], b_lo[0]);
      split_tf32(v0[kStride + n * 8], b_hi[1], b_lo[1]);
      mma_3xtf32(acc[n], a_hi, a_lo, b_hi, b_lo);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kMaxWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int H, int Sq, int Sk,
                 Strides qs, Strides ks, Strides vs, Strides os, float scale, int causal) {
  using Cfg = Tile<T, D>;
  constexpr bool kF32 = Cfg::kF32;
  constexpr int BK = Cfg::kBlockK;
  constexpr int NT = BK / 8;  // score n-tiles of 8 keys
  constexpr int DT = D / 8;   // output n-tiles of 8 columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int block_q = blockDim.x / 2;  // 16 rows a warp
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* KVs = Qs + block_q * Cfg::kQKStride;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // a thread holds rows g and g + 8 of its warp's 16, and columns 2t and
  // 2t + 1 of every n-tile
  const int g = lane >> 2, t = lane & 3;
  // causal tiles further down hold more work: start them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * block_q;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int r0 = q0 + warp * 16;

  q += b * qs.b + h * qs.h;
  k += b * ks.b + h * ks.h;
  v += b * vs.b + h * vs.h;

  // columns past the block's last row are masked for every row of it
  const int kv_end = causal ? min(Sk, q0 + block_q) : Sk;
  const int n_tiles = (kv_end + BK - 1) / BK;
  const int warp_kv_end = causal ? min(kv_end, r0 + 16) : kv_end;
  const bool warp_live = r0 < Sq;

  load_rows<T, D>(Qs, Cfg::kQKStride, q, qs.s, q0, Sq, block_q);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_kv<T, D>(KVs, k, ks.s, v, vs.s, st, Sk);
    cp_async_commit();
  }

  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const T* Qw = Qs + warp * 16 * Cfg::kQKStride;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStages - 2>();  // tile j (and the q tile) landed
    __syncthreads();               // ... for every thread; tile j - 1 is consumed
    if (j + kStages - 1 < n_tiles) load_kv<T, D>(KVs, k, ks.s, v, vs.s, j + kStages - 1, Sk);
    cp_async_commit();

    const int k0 = j * BK;
    if (!warp_live || k0 >= warp_kv_end) continue;
    const T* Ks = KVs + (j % kStages) * Cfg::kStage;
    const T* Vs = Ks + BK * Cfg::kQKStride;

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    if constexpr (kF32) {
      scores_f32<D, NT>(s, Qw, Ks, g, t);
    } else {
      scores_bf16<D, NT>(s, Qw, Ks, lane);
    }

    // scale; mask only tiles that cross Sk or a warp row's diagonal
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > r0);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (edge) {
          const int col = k0 + n * 8 + 2 * t + (e & 1);
          const int row = r0 + g + (e >> 1) * 8;
          if (col >= Sk || (causal && col > row)) x = kNegInf;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], m_new[2];
    bool dead[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m[r], mx[r]);
      // a row masked so far keeps p = 0, so l stays 0 and it outputs zeros
      dead[r] = m_new[r] <= 0.5f * kNegInf;
      alpha[r] = exp2f((m[r] - m_new[r]) * kLog2e);
      m[r] = m_new[r];
    }
    float row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = dead[r] ? 0.f : exp2f((s[n][e] - m_new[r]) * kLog2e);
        s[n][e] = p;
        row_sum[r] += p;
      }
    // l is this thread's share of the row sum; the quad adds them at the end
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + row_sum[r];
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    if constexpr (kF32) {
      pv_f32<D, NT>(acc, s, Vs, g, t);
    } else {
      pv_bf16<D, NT>(acc, s, Vs, lane);
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

  if (!warp_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = r0 + g + 8 * r;
    if (row >= Sq) continue;
    const float safe_l = sum == 0.f ? 1.f : sum;
    T* orow = o + b * os.b + h * os.h + row * os.s + 2 * t;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      store_pair(orow + n * 8, acc[n][2 * r] / safe_l, acc[n][2 * r + 1] / safe_l);
    if (t == 0) lse[static_cast<long long>(bh) * Sq + row] = m[r] + logf(safe_l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                   int H, int Sq, int Sk, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, int causal, int warps, cudaStream_t stream) {
  const int block_q = 16 * warps;
  const int smem = Tile<T, D>::smem_bytes(block_q);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + block_q - 1) / block_q, B * H);
  flash_fwd_kernel<T, D><<<grid, 32 * warps, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), H, Sq, Sk, qs, ks, vs, os, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, void* o, void* lse,
                       int B, int H, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
                       Strides os, float scale, int causal, int warps, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, H, Sq, Sk, qs, ks, vs, os, scale, causal, warps, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, H, Sq, Sk, qs, ks, vs, os, scale, causal, warps, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, H, Sq, Sk, qs, ks, vs, os, scale, causal, warps, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, H, Sq, Sk, qs, ks, vs, os, scale, causal, warps, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: [B, H, S, D] operands given by their (batch, head, seq)
// element strides, unit stride on D, with 16-byte-aligned base pointers and
// strides; lse: [B*H, Sq] fp32, contiguous. dtype 0 is float32, 1 is
// bfloat16; D is 16, 32, 64 or 128; warps (4 or 8) sets the q rows of
// a block, 16 a warp. Launches on `stream` without synchronising and
// returns cudaGetLastError().
extern "C" int elephas_flash_fwd(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int dtype, int B, int H, int Sq, int Sk, int D,
                                 long long q_sb, long long q_sh, long long q_ss,
                                 long long k_sb, long long k_sh, long long k_ss,
                                 long long v_sb, long long v_sh, long long v_ss,
                                 long long o_sb, long long o_sh, long long o_ss,
                                 float scale, int causal, int warps, void* stream) {
  if (warps != 4 && warps != kMaxWarps) return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(D, q, k, v, o, lse, B, H, Sq, Sk, qs, ks, vs, os, scale, causal, warps, st);
    case 1: return dispatch_d<__nv_bfloat16>(D, q, k, v, o, lse, B, H, Sq, Sk, qs, ks, vs, os, scale, causal, warps, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* elephas_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
