// Decode attention over the fixed KV arena for Hopper (sm_90a): one query
// row a slot, over the first `span` positions of the slot's arena row, with
// the span split over the card and the splits merged by their lse.
//
// Replaces elephas_tpu/ops/flash_serving.py::flash_span_decode (:153), which
// is flash_span_chunk (:93) with one query row: plain XLA in the reference,
// not a Pallas kernel. Every generated token pays it on every layer.
//
// What it computes, per (slot b, head h): with pos = positions[b] read from
// device memory (no host sync), the keys j with j <= pos and j < span are
// visible; s_j = q . k_j * scale in fp32, softmax over the visible keys in
// fp32 and out = sum_j p_j v_j, or zeros when no key is visible (pos < 0).
// Only keys 0 .. min(pos, span - 1) are read: a stale cursor past the span
// on an inactive lane reads nothing beyond the span and outputs a finite
// value nobody reads.
//
// Layout: q and out are contiguous [B, H, D]; k and v are views of the arena
// [slots, maxlen, H, D] cut to [B, span, H, D], passed as element strides
// (slot, position, head) with unit stride on D, so nothing is copied.
//
// What bounds it on the H100: each visible K and V row is read once and
// used for 4 * D flops, so it is bound by device memory:
// 2 * sum_b min(pos_b + 1, span) * H * D * 4 bytes over 3.35 TB/s. At the
// engine's shapes (16 slots, 4 heads of 128, spans 64-512) that is 1-17 MB a
// call: 0.3-5 us, so the latency of the loads and of the launch decide.
//
// Design. The grid is (splits, heads, batch): each block owns one fixed
// range of `chunk` key positions of one (slot, head), so a small batch
// still puts blocks on every SM. The host picks `splits` from the span,
// batch * heads and the SM count, never from the positions
// (ops/flash_serving.py::span_splits); when batch * heads alone fills the
// card it picks 1, and the block writes `out` itself. A block whose range
// starts at or past the slot's visible count loads nothing: it writes the
// empty state (m = -1e30, l = 0), or zeros when it is the only split.
//
// Inside a block, a key row of D floats is split into D / 4 float4 pieces,
// one per lane, so a warp reads 32 * 4 / D keys with one 16-byte load a
// lane; each lane group holds kUnroll keys of K and V a round. The loads of
// the next round are issued into a second register buffer before the
// current round's scores and softmax update, so a warp always has a round
// in flight. A lane group folds its keys into its own (m, l, acc), the
// scores in log2 units (q . k times scale * log2 e) and the softmax in
// exp2; the groups of a warp merge by shuffles and the warps through shared
// memory, a fixed tree, so every order is fixed. A block has 8 warps, or 4
// when its split is no longer than one round of 4 (split_warps: at the
// engine's span 64 the larger block only adds idle warps and a longer
// merge); a round of 8 folds twice the keys, and the fold, not the loads,
// is what a block waits on at the engine's shapes (PERF.md).
//
// Merge. With more than one split each block writes its unnormalised
// partial (m, l, acc[D]) to a workspace the wrapper allocates, and a second
// small kernel, launched by the same C entry point, walks a row's partials
// in split order: M = max m_s, l = sum l_s e^(m_s - M), acc likewise, out =
// acc / l, skipping the empty ones (l_s = 0). Every order is fixed, so a
// call repeats bit for bit; no counter or atomic is used, so a CUDA graph
// replays the call as it is. The merge is a second launch. A merge by the
// last block of each row, found by a per-row counter (a fence, an atomic,
// then that block walking the partials alone), was measured too: on the
// H100 it was slower at the engine's spans 64-256 and no faster at 512, so
// it was not kept.
//
// Paged variant (elephas_paged_span_decode). Replaces the gather and the
// decode attention of elephas_tpu/serving/paged_kv.py::paged_token_decode_step
// (:246), whose attention is flash_span_decode with kv_dtype and kv_scales
// (elephas_tpu/ops/flash_serving.py:153-167): plain XLA in the reference.
// The keys live in a block pool [num_blocks + 1, block_size, H, Ds] (block
// num_blocks is a sink that no request leases) and key j of slot b at
// (tables[b, j / block_size], j % block_size); a sentinel id (num_blocks)
// reads the sink, so a padded table entry or the stale cursor of an inactive
// lane never reads out of bounds, and feeds only masked lanes. The span is
// table_len * block_size, split by the same rule as the arena's. Bound: the
// bytes of the visible codes and scales, read once (int8 a quarter of fp's,
// int4 an eighth, plus 8 bytes of scales a key and head).
//
// Its loads are staged in shared memory, not taken per key into registers
// as the arena kernel's are: with a table in front of every row, a per-key
// load is two dependent global loads (entry, then row; three with a scale),
// and a quantized lane's piece of a row is only 4 (int8) or 2 (int4) bytes,
// so narrow loads leave few bytes in flight. So:
// - the block first copies the table entries that cover its key range
//   [begin, end) into shared memory in one coalesced pass, clamped to
//   [0, num_blocks] there (a range wider than kTable entries, only with
//   block_size 1 and a split of over 512 keys, takes one more pass each
//   kTable entries); the copies then read block ids from shared memory;
// - K and V rows (codes) and scales of this (slot, head) come in by cp.async
//   into a ring of 3 stages, each a tile of kKeys keys: 16-byte copies
//   (8-byte for an int4 row of D 16, which is 8 bytes), 4-byte copies for
//   the scales (strided by H in the pool). A tile may cross pages and a page
//   may cross tiles. The copies run key-major: a thread copies one piece of
//   the K and V rows of every kPerPass-th key of the tile, walking the
//   pages with one division a tile (a division a copy cost the fp kernel
//   half its speed in a first version). The stages are sized in bytes: 32
//   KB of codes a stage, so an int8 stage holds 4x and an int4 stage 8x the
//   keys of an fp stage (D 128: 32, 128 and 256 keys; at most 512);
// - tile t's copies are in flight while tiles t - 2 and t - 1 are folded
//   (commit_group / wait_group, one block barrier a tile).
// Shared memory a block at D 128: 3 stages of 32 KB of codes (plus 1 or 2
// KB of scales a stage quantized) and the table (2 KB): 98-104 KB, plus 4
// KB for the warp merge: 2 blocks an SM, as span_splits plans
// (SPLIT_BLOCKS_PER_SM). Bytes in flight a block: up to 64 KB (2 tiles:
// fp 64 keys, int8 256, int4 512: a whole split of the engine's shapes
// quantized). Bound at E's shape, span 512: fp 5.9 us, int8 1.6 us, int4
// 0.8 us of bytes (PERF.md).
// The arithmetic is the arena kernel's, in its order: each lane reads its
// piece of a key from the stage (a float4, 4 int8 codes or 2 bytes of
// nibbles, low nibble the even index), converts the codes exactly,
// dequantizes them with one code * scale product a value as the
// reference's dequantize_rows, and folds the same keys in the same rounds
// (fold_round, finish_split), so the output is bit-equal to the arena
// kernel over the gathered, dequantized span.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
// warps a block: 4, or 8 when a split is longer than one round of 4
// (split_warps); the kernels are instantiated for both
constexpr int kMaxWarps = 8;
constexpr int kUnroll = 4;
constexpr int kMergeThreads = 128;

__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

__device__ __forceinline__ float4 fma4(float4 a, float s, float4 c) {
  return make_float4(fmaf(a.x, s, c.x), fmaf(a.y, s, c.y), fmaf(a.z, s, c.z),
                     fmaf(a.w, s, c.w));
}

// (m, l, acc) <- the merge of two online-softmax states; symmetric, so every
// lane of a butterfly ends with the same bits
__device__ __forceinline__ void merge(float& m, float& l, float4& acc, float m2, float l2,
                                      float4 acc2) {
  const float mx = fmaxf(m, m2);
  const float a = exp2f(m - mx), b = exp2f(m2 - mx);
  l = l * a + l2 * b;
  acc = make_float4(acc.x * a + acc2.x * b, acc.y * a + acc2.y * b, acc.z * a + acc2.z * b,
                    acc.w * a + acc2.w * b);
  m = mx;
}

// K and V rows of one (slot, head) of the fixed arena: key j at kb + j * k_pos
// (the lane's float4 of the row)
struct ArenaRows {
  const float* kb;
  const float* vb;
  long long k_pos, v_pos;
  __device__ __forceinline__ void load(int j, float4& kr, float4& vr) const {
    kr = __ldg(reinterpret_cast<const float4*>(kb + j * k_pos));
    vr = __ldg(reinterpret_cast<const float4*>(vb + j * v_pos));
  }
};

// kUnroll keys of the round starting at `base`: key base + lane_key + u *
// stride for u < kUnroll, zeros past `end`
template <int D, class Rows>
__device__ __forceinline__ void load_round(float4 (&kr)[kUnroll], float4 (&vr)[kUnroll],
                                           const Rows& rows, int base, int lane_key, int stride,
                                           int end) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int j = base + lane_key + u * stride;
    if (j < end) {
      rows.load(j, kr[u], vr[u]);
    } else {
      kr[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      vr[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// The range of key positions one split block (split, head, slot) = blockIdx
// owns, and where its output goes
struct SplitRange {
  int begin, end;   // keys [begin, end) of the slot's visible ones
  long long row;    // b * heads + h
  long long part;   // row * splits + split
};

__device__ __forceinline__ SplitRange split_range(int pos, int span, int chunk) {
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n = pos < 0 ? 0 : min(pos, span - 1) + 1;  // visible keys
  SplitRange r;
  r.begin = split * chunk;
  r.end = min(r.begin + chunk, n);
  r.row = static_cast<long long>(b) * gridDim.y + h;
  r.part = r.row * gridDim.x + split;
  return r;
}

// a block with nothing visible in its range (uniform over the block) writes
// the empty state, or zeros when it is the only split
template <int D>
__device__ __forceinline__ void empty_split(const SplitRange& r, float* __restrict__ out,
                                            float* __restrict__ part_ml) {
  if (gridDim.x == 1) {
    for (int i = threadIdx.x; i < D / 4; i += blockDim.x)
      reinterpret_cast<float4*>(out + r.row * D)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else if (threadIdx.x == 0) {
    part_ml[2 * r.part] = kNegInf;
    part_ml[2 * r.part + 1] = 0.f;
  }
}

// One round's kUnroll keys of the lane (base + lane_key + u * stride)
// folded into the lane group's (m, l, acc): key_at(u) and value_at(u) give
// the lane's piece of key u (zeros past `end`), each read where it is used;
// scores in log2 units (`scale` holds log2 e), the softmax in exp2
template <int D, class KeyAt, class ValueAt>
__device__ __forceinline__ void fold_round(const KeyAt& key_at, const ValueAt& value_at,
                                           float4 qv, int base, int lane_key, int stride,
                                           int end, float scale, float& m, float& l,
                                           float4& acc) {
  constexpr int kLanesPerRow = D / 4;
  float s[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const float4 kr = key_at(u);
    s[u] = qv.x * kr.x + qv.y * kr.y + qv.z * kr.z + qv.w * kr.w;
  }
#pragma unroll
  for (int o = kLanesPerRow / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
  }
  float mx = m;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const bool live = base + lane_key + u * stride < end;
    s[u] = live ? s[u] * scale : kNegInf;
    mx = fmaxf(mx, s[u]);
  }
  const float alpha = exp2f(m - mx);
  l *= alpha;
  acc = scale4(acc, alpha);
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    // a masked key adds nothing, also while no key has been seen
    const float p = s[u] > 0.5f * kNegInf ? exp2f(s[u] - mx) : 0.f;
    l += p;
    acc = fma4(value_at(u), p, acc);
  }
  m = mx;
}

// The lane groups' states merged (the warp's key groups by shuffles, then
// the warps in order through shared memory), and the block's partial or,
// with one split, its output written
template <int D, int W>
__device__ __forceinline__ void finish_split(float m, float l, float4 acc, const SplitRange& r,
                                             float* __restrict__ out,
                                             float* __restrict__ part_acc,
                                             float* __restrict__ part_ml) {
  constexpr int kLanesPerRow = D / 4;
  __shared__ float4 s_acc[W][kLanesPerRow];
  __shared__ float s_m[W], s_l[W];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int piece = lane % kLanesPerRow, group = lane / kLanesPerRow;
#pragma unroll
  for (int o = kLanesPerRow; o < 32; o <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    float4 a2;
    a2.x = __shfl_xor_sync(0xffffffffu, acc.x, o);
    a2.y = __shfl_xor_sync(0xffffffffu, acc.y, o);
    a2.z = __shfl_xor_sync(0xffffffffu, acc.z, o);
    a2.w = __shfl_xor_sync(0xffffffffu, acc.w, o);
    merge(m, l, acc, m2, l2, a2);
  }
  if (group == 0) s_acc[warp][piece] = acc;
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
  __syncthreads();
  if (warp != 0 || group != 0) return;
  // the warps' states merged pairwise, a fixed tree of log2(W) levels
  float ms[W], ls[W];
  float4 as[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    ms[w] = s_m[w];
    ls[w] = s_l[w];
    as[w] = s_acc[w][piece];
  }
#pragma unroll
  for (int stride = 1; stride < W; stride <<= 1) {
#pragma unroll
    for (int w = 0; w + stride < W; w += 2 * stride)
      merge(ms[w], ls[w], as[w], ms[w + stride], ls[w + stride], as[w + stride]);
  }
  m = ms[0];
  l = ls[0];
  acc = as[0];
  if (gridDim.x == 1) {
    // a visible key makes l >= 1
    reinterpret_cast<float4*>(out + r.row * D)[piece] = scale4(acc, 1.f / l);
    return;
  }
  reinterpret_cast<float4*>(part_acc + r.part * D)[piece] = acc;
  if (piece == 0) {
    part_ml[2 * r.part] = m;
    part_ml[2 * r.part + 1] = l;
  }
}

template <int D, int W>
__global__ void __launch_bounds__(W * 32)
span_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const int* __restrict__ positions,
                   float* __restrict__ out, float* __restrict__ part_acc,
                   float* __restrict__ part_ml, int span, int chunk, long long k_slot,
                   long long k_pos, long long k_head, long long v_slot, long long v_pos,
                   long long v_head, float scale) {
  constexpr int kLanesPerRow = D / 4;
  constexpr int kRowsPerWarp = 32 / kLanesPerRow;
  const int h = blockIdx.y, b = blockIdx.z;
  const SplitRange r = split_range(positions[b], span, chunk);
  if (r.begin >= r.end) {
    empty_split<D>(r, out, part_ml);
    return;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int piece = lane % kLanesPerRow;  // which float4 of a row
  const int lane_key = warp * kRowsPerWarp + lane / kLanesPerRow;
  const float4 qv = reinterpret_cast<const float4*>(q + r.row * D)[piece];
  const ArenaRows rows{k + b * k_slot + h * k_head + piece * 4,
                       v + b * v_slot + h * v_head + piece * 4, k_pos, v_pos};
  constexpr int stride = W * kRowsPerWarp;  // keys apart in a round
  constexpr int rows_per_round = kUnroll * stride;

  float m = kNegInf, l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 kc[kUnroll], vc[kUnroll];
  load_round<D>(kc, vc, rows, r.begin, lane_key, stride, r.end);
  // the loop bound is uniform over the block: every lane takes part in the
  // shuffles, and j < end guards the loads. The next round's loads are in
  // flight while this one folds.
  for (int base = r.begin; base < r.end; base += rows_per_round) {
    const int next = base + rows_per_round;
    float4 kn[kUnroll], vn[kUnroll];
    if (next < r.end) load_round<D>(kn, vn, rows, next, lane_key, stride, r.end);
    fold_round<D>([&](int u) { return kc[u]; }, [&](int u) { return vc[u]; }, qv, base,
                  lane_key, stride, r.end, scale, m, l, acc);
    if (next < r.end) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        kc[u] = kn[u];
        vc[u] = vn[u];
      }
    }
  }
  finish_split<D, W>(m, l, acc, r, out, part_acc, part_ml);
}

// -- the paged kernel's stages

// the stored type of a paged pool
enum KvDtype { kFp = 0, kInt8 = 1, kInt4 = 2 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// N bytes global -> shared, asynchronously (16: cached in L2 only)
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "n"(N));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// blocks of the paged kernel an SM holds (its ring takes about 100 KB), the
// register budget ptxas plans for (without a bound it held a first version
// at 64 registers and spilled)
constexpr int kPagedBlocksPerSm = 2;

// The ring of one paged instantiation: a stage holds kKeys keys of one
// (slot, head): K rows (codes), V rows, then K and V scales (quantized).
template <int D, int Q>
struct PagedRing {
  static constexpr int kRowBytes = Q == kFp ? D * 4 : Q == kInt8 ? D : D / 2;
  static constexpr int kCopy = kRowBytes < 16 ? kRowBytes : 16;  // bytes a cp.async
  static constexpr int kCopiesPerRow = kRowBytes / kCopy;
  // keys a round of the most warps (a round of 4 is half of it)
  static constexpr int kRowsPerRound = kUnroll * kMaxWarps * (128 / D);
  // 32 KB of codes a stage (at D 128: 2, 8 or 16 rounds), at most 512 keys
  static constexpr int kRounds = 32768 / (2 * kRowBytes * kRowsPerRound);
  static constexpr int kKeys =
      (kRounds < 512 / kRowsPerRound ? kRounds : 512 / kRowsPerRound) * kRowsPerRound;
  static constexpr int kStages = 3;
  static constexpr int kScales = Q == kFp ? 0 : 2 * kKeys * 4;  // bytes of scales a stage
  static constexpr int kStageBytes = 2 * kKeys * kRowBytes + kScales;
  // table entries staged at once: a tile's, whatever the block size
  static constexpr int kTable = 516;
  static constexpr int kBytes = kStages * kStageBytes + kTable * 4;
  static_assert(kKeys % kRowsPerRound == 0 && kKeys > 0, "a stage holds whole rounds");
};

// The block's pieces of the paged pool and its table window
template <int D, int Q, int W>
struct PagedSource {
  using Ring = PagedRing<D, Q>;
  const unsigned char* k;  // the pool's (block 0, row 0, head h) row
  const unsigned char* v;
  const float* ks;  // the scale planes at head h
  const float* vs;
  const int* table;  // the slot's table row
  int* s_table;      // its staged window: entries [win0, win0 + kTable)
  int block_size, num_blocks, heads, table_len, end;
  int win0;

  // the window holds entries [e0, e0 + kTable) of the key range's, clamped
  // to [0, num_blocks]; one coalesced pass, then a barrier
  __device__ __forceinline__ void stage_table(int e0) {
    const int last = min((end - 1) / block_size + 1, table_len);
    for (int i = threadIdx.x; i < Ring::kTable && e0 + i < last; i += blockDim.x)
      s_table[i] = min(max(__ldg(table + e0 + i), 0), num_blocks);
    win0 = e0;
    __syncthreads();
  }

  // tile keys [k0, min(k0 + kKeys, end)) into stage `st` by cp.async (not
  // committed); stages the table window first if it does not cover them.
  // Key-major: a thread copies piece `threadIdx % kCopiesPerRow` of the K
  // and V rows of every kPerPass-th key (and, piece 0, their scales),
  // walking the pages by one division a tile. Uniform over the block.
  __device__ __forceinline__ void fill(unsigned char* st, int k0) {
    constexpr int kPerPass = W * 32 / Ring::kCopiesPerRow;  // keys a pass
    static_assert(Ring::kKeys % kPerPass == 0, "a tile is whole passes");
    const int k1 = min(k0 + Ring::kKeys, end);
    if (win0 < 0 || (k1 - 1) / block_size >= win0 + Ring::kTable) {
      if (win0 >= 0) __syncthreads();  // every copy from the old window made
      stage_table(k0 / block_size);
    }
    const int piece = threadIdx.x % Ring::kCopiesPerRow;
    int key = threadIdx.x / Ring::kCopiesPerRow;
    int e = (k0 + key) / block_size;  // the key's table entry and row in it
    int in_page = k0 + key - e * block_size;
    float* s_sc = reinterpret_cast<float*>(st + 2 * Ring::kKeys * Ring::kRowBytes);
#pragma unroll 2
    for (; key < Ring::kKeys; key += kPerPass) {
      if (k0 + key < k1) {
        const long long row =
            static_cast<long long>(s_table[e - win0]) * block_size + in_page;
        const long long at = row * heads * Ring::kRowBytes + piece * Ring::kCopy;
        cp_async<Ring::kCopy>(st + key * Ring::kRowBytes + piece * Ring::kCopy, k + at);
        cp_async<Ring::kCopy>(st + (Ring::kKeys + key) * Ring::kRowBytes + piece * Ring::kCopy,
                              v + at);
        if constexpr (Q != kFp) {
          if (piece == 0) {
            cp_async<4>(s_sc + key, ks + row * heads);
            cp_async<4>(s_sc + Ring::kKeys + key, vs + row * heads);
          }
        }
      }
      in_page += kPerPass;
      if (in_page >= block_size) {
        const int pages = in_page / block_size;
        e += pages;
        in_page -= pages * block_size;
      }
    }
  }
};

// The codes as exact floats without an int-to-float conversion (a quarter
// of the full rate): a code biased to unsigned x is placed in the low bits
// of 2^23 (bits 0x4B000000 | x), so the float 2^23 + x is one subtraction
// from x, then one code * scale product a value.

// the four int8 codes of w (byte i value i), each byte biased by ^ 0x80
__device__ __forceinline__ float4 dequant_int8(uint32_t w, float s) {
  constexpr float kBias = 8388608.f + 128.f;
  const uint32_t u = w ^ 0x80808080u;
  return make_float4((__int_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - kBias) * s,
                     (__int_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - kBias) * s,
                     (__int_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - kBias) * s,
                     (__int_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - kBias) * s);
}

// the four int4 codes of w's low 16 bits (nibble i value i: low nibble the
// even index), each nibble biased by ^ 8
__device__ __forceinline__ float4 dequant_int4(uint32_t w, float s) {
  constexpr float kBias = 8388608.f + 8.f;
  const uint32_t u = w ^ 0x8888u;
  return make_float4((__int_as_float(0x4B000000u | (u & 0xFu)) - kBias) * s,
                     (__int_as_float(0x4B000000u | (u >> 4 & 0xFu)) - kBias) * s,
                     (__int_as_float(0x4B000000u | (u >> 8 & 0xFu)) - kBias) * s,
                     (__int_as_float(0x4B000000u | (u >> 12 & 0xFu)) - kBias) * s);
}

// values 4p .. 4p + 3 of key `key` of a stage's K (which 0) or V (1) rows:
// a float4 (fp), 4 int8 codes, or 2 bytes of int4 nibbles, times the key's
// scale (one code * scale product a value)
template <int D, int Q>
__device__ __forceinline__ float4 read_piece(const unsigned char* st, int which, int key,
                                             int piece) {
  using Ring = PagedRing<D, Q>;
  const unsigned char* row = st + (which * Ring::kKeys + key) * Ring::kRowBytes;
  if constexpr (Q == kFp) {
    return reinterpret_cast<const float4*>(row)[piece];
  } else {
    const float sc = reinterpret_cast<const float*>(
        st + 2 * Ring::kKeys * Ring::kRowBytes)[which * Ring::kKeys + key];
    if constexpr (Q == kInt8) {
      return dequant_int8(reinterpret_cast<const uint32_t*>(row)[piece], sc);
    } else {
      return dequant_int4(reinterpret_cast<const uint16_t*>(row)[piece], sc);
    }
  }
}

// the paged pool [num_blocks + 1, block_size, heads, stored] (codes of the
// stored type), scale planes [num_blocks + 1, block_size, heads] (quantized
// only), tables [batch, table_len]; dynamic shared memory PagedRing::kBytes
template <int D, int Q, int W>
__global__ void __launch_bounds__(W * 32, kPagedBlocksPerSm)
paged_span_decode_kernel(const float* __restrict__ q, const void* __restrict__ k,
                         const void* __restrict__ v, const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale, const int* __restrict__ tables,
                         const int* __restrict__ positions, float* __restrict__ out,
                         float* __restrict__ part_acc, float* __restrict__ part_ml,
                         int table_len, int block_size, int num_blocks, int chunk, float scale) {
  using Ring = PagedRing<D, Q>;
  constexpr int kLanesPerRow = D / 4;
  constexpr int kRowsPerWarp = 32 / kLanesPerRow;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const SplitRange r = split_range(positions[b], table_len * block_size, chunk);
  if (r.begin >= r.end) {
    empty_split<D>(r, out, part_ml);
    return;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int piece = lane % kLanesPerRow;  // which float4 of a row
  const int lane_key = warp * kRowsPerWarp + lane / kLanesPerRow;
  const float4 qv = reinterpret_cast<const float4*>(q + r.row * D)[piece];
  constexpr int stride = W * kRowsPerWarp;  // keys apart in a round
  constexpr int rows_per_round = kUnroll * stride;
  PagedSource<D, Q, W> src{static_cast<const unsigned char*>(k) + h * Ring::kRowBytes,
                        static_cast<const unsigned char*>(v) + h * Ring::kRowBytes,
                        k_scale == nullptr ? nullptr : k_scale + h,
                        v_scale == nullptr ? nullptr : v_scale + h,
                        tables + static_cast<long long>(b) * table_len,
                        reinterpret_cast<int*>(smem_raw + Ring::kStages * Ring::kStageBytes),
                        block_size, num_blocks, heads, table_len, r.end, -1};

  // tiles 0 .. kStages - 2 in flight, one commit group each (empty past
  // the last tile, so the groups count the same on every thread)
  const int tiles = (r.end - r.begin + Ring::kKeys - 1) / Ring::kKeys;
#pragma unroll
  for (int t = 0; t < Ring::kStages - 1; ++t) {
    if (t < tiles) src.fill(smem_raw + t * Ring::kStageBytes, r.begin + t * Ring::kKeys);
    cp_async_commit();
  }
  float m = kNegInf, l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<Ring::kStages - 2>();  // tile t's copies of this thread landed
    __syncthreads();  // ... and every thread's; tile t - 1's stage is free
    const int ahead = t + Ring::kStages - 1;
    if (ahead < tiles)
      src.fill(smem_raw + ahead % Ring::kStages * Ring::kStageBytes,
                r.begin + ahead * Ring::kKeys);
    cp_async_commit();
    const unsigned char* st = smem_raw + t % Ring::kStages * Ring::kStageBytes;
    const int t0 = r.begin + t * Ring::kKeys, t1 = min(t0 + Ring::kKeys, r.end);
    // the arena kernel's rounds, in its order; the bounds are uniform over
    // the block and j < end guards the reads
    for (int base = t0; base < t1; base += rows_per_round) {
      const auto piece_at = [&](int which, int u) {
        const int j = base + lane_key + u * stride;
        return j < r.end ? read_piece<D, Q>(st, which, j - t0, piece)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      };
      fold_round<D>([&](int u) { return piece_at(0, u); }, [&](int u) { return piece_at(1, u); },
                    qv, base, lane_key, stride, r.end, scale, m, l, acc);
    }
  }
  finish_split<D, W>(m, l, acc, r, out, part_acc, part_ml);
}

// out[row] <- the lse merge of the row's `splits` partials, in split order;
// D / 4 lanes a row
template <int D>
__global__ void __launch_bounds__(kMergeThreads)
span_decode_merge_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                         float* __restrict__ out, int rows, int splits) {
  constexpr int kLanesPerRow = D / 4;
  constexpr int kRowsPerBlock = kMergeThreads / kLanesPerRow;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kLanesPerRow;
  const int piece = threadIdx.x % kLanesPerRow;
  if (row >= rows) return;
  const float* ml = part_ml + row * splits * 2;
  float mx = kNegInf;
  for (int s = 0; s < splits; ++s)
    if (ml[2 * s + 1] > 0.f) mx = fmaxf(mx, ml[2 * s]);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const float ls = ml[2 * s + 1];
    if (ls > 0.f) {  // an empty split wrote no acc
      const float e = exp2f(ml[2 * s] - mx);
      l = fmaf(ls, e, l);
      acc = fma4(reinterpret_cast<const float4*>(part_acc + (row * splits + s) * D)[piece], e,
                 acc);
    }
  }
  reinterpret_cast<float4*>(out + row * D)[piece] =
      l > 0.f ? scale4(acc, 1.f / l) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// warps a split block of `chunk` keys runs: 4 while the split is one round
// of 4 warps (a larger block only adds idle warps and a longer merge), else
// 8, so a round folds twice the keys. The arena and the paged kernels take
// the same count, so the same keys fold in the same order.
template <int D>
int split_warps(int chunk) {
  return chunk > kUnroll * 4 * (128 / D) ? kMaxWarps : 4;
}

// the merge of the split kernel's partials (with more than one split)
template <int D>
cudaError_t merge(float* part_acc, float* part_ml, float* out, long long rows, int splits,
                  cudaStream_t stream) {
  constexpr int kRowsPerBlock = kMergeThreads / (D / 4);
  const unsigned blocks = static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  span_decode_merge_kernel<D><<<blocks, kMergeThreads, 0, stream>>>(
      part_acc, part_ml, out, static_cast<int>(rows), splits);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, const int* positions,
                   float* out, float* workspace, int batch, int heads, int span, int splits,
                   int chunk, long long k_slot, long long k_pos, long long k_head,
                   long long v_slot, long long v_pos, long long v_head, float scale,
                   cudaStream_t stream) {
  const long long rows = static_cast<long long>(batch) * heads;
  // the workspace: acc [rows, splits, D], then (m, l) [rows, splits, 2]
  float* part_acc = workspace;
  float* part_ml = workspace == nullptr ? nullptr : workspace + rows * splits * D;
  const dim3 grid(static_cast<unsigned>(splits), static_cast<unsigned>(heads),
                  static_cast<unsigned>(batch));
  if (split_warps<D>(chunk) == kMaxWarps)
    span_decode_kernel<D, kMaxWarps><<<grid, kMaxWarps * 32, 0, stream>>>(
        q, k, v, positions, out, part_acc, part_ml, span, chunk, k_slot, k_pos, k_head, v_slot,
        v_pos, v_head, scale * kLog2e);
  else
    span_decode_kernel<D, 4><<<grid, 4 * 32, 0, stream>>>(
        q, k, v, positions, out, part_acc, part_ml, span, chunk, k_slot, k_pos, k_head, v_slot,
        v_pos, v_head, scale * kLog2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return merge<D>(part_acc, part_ml, out, rows, splits, stream);
}

template <int D, int Q>
cudaError_t launch_paged(const float* q, const void* k, const void* v, const float* k_scale,
                         const float* v_scale, const int* tables, const int* positions,
                         float* out, float* workspace, int batch, int heads, int table_len,
                         int block_size, int num_blocks, int splits, int chunk, float scale,
                         cudaStream_t stream) {
  const long long rows = static_cast<long long>(batch) * heads;
  float* part_acc = workspace;
  float* part_ml = workspace == nullptr ? nullptr : workspace + rows * splits * D;
  const dim3 grid(static_cast<unsigned>(splits), static_cast<unsigned>(heads),
                  static_cast<unsigned>(batch));
  constexpr int kBytes = PagedRing<D, Q>::kBytes;
  if (split_warps<D>(chunk) == kMaxWarps)
    paged_span_decode_kernel<D, Q, kMaxWarps><<<grid, kMaxWarps * 32, kBytes, stream>>>(
        q, k, v, k_scale, v_scale, tables, positions, out, part_acc, part_ml, table_len,
        block_size, num_blocks, chunk, scale * kLog2e);
  else
    paged_span_decode_kernel<D, Q, 4><<<grid, 4 * 32, kBytes, stream>>>(
        q, k, v, k_scale, v_scale, tables, positions, out, part_acc, part_ml, table_len,
        block_size, num_blocks, chunk, scale * kLog2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return merge<D>(part_acc, part_ml, out, rows, splits, stream);
}

template <int D>
cudaError_t launch_paged_dtype(int kv_dtype, const float* q, const void* k, const void* v,
                               const float* k_scale, const float* v_scale, const int* tables,
                               const int* positions, float* out, float* workspace, int batch,
                               int heads, int table_len, int block_size, int num_blocks,
                               int splits, int chunk, float scale, cudaStream_t stream) {
  switch (kv_dtype) {
    case kFp:
      return launch_paged<D, kFp>(q, k, v, k_scale, v_scale, tables, positions, out, workspace,
                                  batch, heads, table_len, block_size, num_blocks, splits,
                                  chunk, scale, stream);
    case kInt8:
      return launch_paged<D, kInt8>(q, k, v, k_scale, v_scale, tables, positions, out,
                                    workspace, batch, heads, table_len, block_size, num_blocks,
                                    splits, chunk, scale, stream);
    case kInt4:
      return launch_paged<D, kInt4>(q, k, v, k_scale, v_scale, tables, positions, out,
                                    workspace, batch, heads, table_len, block_size, num_blocks,
                                    splits, chunk, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// every stored type's paged kernel at head dim D may take its ring's
// dynamic shared memory (over the default 48 KB) on the current device
template <int D, int Q, int W>
cudaError_t allow_paged_ring() {
  cudaError_t err = cudaFuncSetAttribute(paged_span_decode_kernel<D, Q, W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         PagedRing<D, Q>::kBytes);
  // L1 takes what the rings leave: cp.async.cg bypasses it
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(paged_span_decode_kernel<D, Q, W>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

template <int D>
cudaError_t allow_paged_rings() {
  cudaError_t err = allow_paged_ring<D, kFp, 4>();
  if (err == cudaSuccess) err = allow_paged_ring<D, kInt8, 4>();
  if (err == cudaSuccess) err = allow_paged_ring<D, kInt4, 4>();
  if (err == cudaSuccess) err = allow_paged_ring<D, kFp, kMaxWarps>();
  if (err == cudaSuccess) err = allow_paged_ring<D, kInt8, kMaxWarps>();
  if (err == cudaSuccess) err = allow_paged_ring<D, kInt4, kMaxWarps>();
  return err;
}

}  // namespace

// q, out: [batch, heads, head_dim] float32, contiguous; k, v: [batch, span,
// heads, head_dim] float32 views with element strides (slot, pos, head) and
// unit stride on head_dim, every stride a multiple of 4 and every base
// pointer 16-byte aligned; positions: [batch] int32 on the device. splits
// blocks of chunk key positions each cover the span (splits * chunk >=
// span); with splits > 1, workspace holds batch * heads * splits *
// (head_dim + 2) floats, 16-byte aligned, else it may be null.
extern "C" int elephas_span_decode(const void* q, const void* k, const void* v,
                                   const void* positions, void* out, void* workspace,
                                   int batch, int heads, int head_dim, int span, int splits,
                                   int chunk, long long k_slot, long long k_pos,
                                   long long k_head, long long v_slot, long long v_pos,
                                   long long v_head, float scale, void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 || span < 1 || splits < 1 ||
      chunk < 1 || static_cast<long long>(splits) * chunk < span ||
      (splits > 1 && workspace == nullptr))
    return cudaErrorInvalidValue;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* pos = static_cast<const int*>(positions);
  auto* of = static_cast<float*>(out);
  auto* ws = static_cast<float*>(workspace);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return launch<16>(qf, kf, vf, pos, of, ws, batch, heads, span, splits, chunk, k_slot,
                        k_pos, k_head, v_slot, v_pos, v_head, scale, st);
    case 32:
      return launch<32>(qf, kf, vf, pos, of, ws, batch, heads, span, splits, chunk, k_slot,
                        k_pos, k_head, v_slot, v_pos, v_head, scale, st);
    case 64:
      return launch<64>(qf, kf, vf, pos, of, ws, batch, heads, span, splits, chunk, k_slot,
                        k_pos, k_head, v_slot, v_pos, v_head, scale, st);
    case 128:
      return launch<128>(qf, kf, vf, pos, of, ws, batch, heads, span, splits, chunk, k_slot,
                         k_pos, k_head, v_slot, v_pos, v_head, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// q, out: [batch, heads, head_dim] float32, contiguous; k, v: the paged pool
// [num_blocks + 1, block_size, heads, stored] contiguous, float32 for
// kv_dtype 0 (fp), int8 codes for 1 (int8, stored = head_dim) and 2 (int4
// packed two a byte, stored = head_dim / 2), 16-byte aligned; k_scale,
// v_scale: [num_blocks + 1, block_size, heads] float32 contiguous (null for
// fp); tables: [batch, table_len] int32 contiguous, ids in [0, num_blocks]
// (num_blocks the sentinel, read as the sink block); positions: [batch]
// int32. The span is table_len * block_size; splits and chunk as for
// elephas_span_decode, and the workspace too. elephas_paged_span_decode_init
// must have run on the device.
extern "C" int elephas_paged_span_decode(const void* q, const void* k, const void* v,
                                         const void* k_scale, const void* v_scale,
                                         const void* tables, const void* positions, void* out,
                                         void* workspace, int batch, int heads, int head_dim,
                                         int kv_dtype, int block_size, int table_len,
                                         int num_blocks, int splits, int chunk, float scale,
                                         void* stream) {
  const long long span = static_cast<long long>(table_len) * block_size;
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 || block_size < 1 ||
      table_len < 1 || span > INT_MAX || num_blocks < 1 || splits < 1 || chunk < 1 ||
      static_cast<long long>(splits) * chunk < span || (splits > 1 && workspace == nullptr) ||
      kv_dtype < kFp || kv_dtype > kInt4 ||
      (kv_dtype != kFp && (k_scale == nullptr || v_scale == nullptr)))
    return cudaErrorInvalidValue;
  const auto* qf = static_cast<const float*>(q);
  const auto* ksc = static_cast<const float*>(k_scale);
  const auto* vsc = static_cast<const float*>(v_scale);
  const auto* tab = static_cast<const int*>(tables);
  const auto* pos = static_cast<const int*>(positions);
  auto* of = static_cast<float*>(out);
  auto* ws = static_cast<float*>(workspace);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return launch_paged_dtype<16>(kv_dtype, qf, k, v, ksc, vsc, tab, pos, of, ws, batch,
                                    heads, table_len, block_size, num_blocks, splits, chunk,
                                    scale, st);
    case 32:
      return launch_paged_dtype<32>(kv_dtype, qf, k, v, ksc, vsc, tab, pos, of, ws, batch,
                                    heads, table_len, block_size, num_blocks, splits, chunk,
                                    scale, st);
    case 64:
      return launch_paged_dtype<64>(kv_dtype, qf, k, v, ksc, vsc, tab, pos, of, ws, batch,
                                    heads, table_len, block_size, num_blocks, splits, chunk,
                                    scale, st);
    case 128:
      return launch_paged_dtype<128>(kv_dtype, qf, k, v, ksc, vsc, tab, pos, of, ws, batch,
                                     heads, table_len, block_size, num_blocks, splits, chunk,
                                     scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Lets every paged instantiation take its ring's shared memory on the
// current device. Call once a device before the first
// elephas_paged_span_decode there, outside any CUDA-graph capture; a launch
// without it fails with cudaErrorInvalidValue.
extern "C" int elephas_paged_span_decode_init() {
  cudaError_t err = allow_paged_rings<16>();
  if (err == cudaSuccess) err = allow_paged_rings<32>();
  if (err == cudaSuccess) err = allow_paged_rings<64>();
  if (err == cudaSuccess) err = allow_paged_rings<128>();
  return err;
}

extern "C" const char* elephas_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
