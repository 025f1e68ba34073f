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
// in flight. A lane group folds its keys into its own (m, l, acc); the
// groups of a warp merge by shuffles and the warps through shared memory,
// both in a fixed order.
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
// table_len * block_size, split by the same rule as the arena's. Only the
// loads change (ArenaRows / PagedRows below): for kv_dtype int8 a lane loads
// its 4 codes (4 bytes) and the (position, head) scale and dequantizes them
// in registers, one code * scale product a value as the reference's
// dequantize_rows; for int4 its 2 bytes of packed nibbles (low nibble the
// even index), unpacked by shifts. An fp row exists only in the lane's
// registers. With the same split and the same order, the output is bit-equal
// to the arena kernel over the gathered (dequantized) span. Bound: the bytes
// of the visible codes and scales, read once.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
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
  const float a = expf(m - mx), b = expf(m2 - mx);
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

// the stored type of a paged pool
enum KvDtype { kFp = 0, kInt8 = 1, kInt4 = 2 };

__device__ __forceinline__ float4 dequant4(int c0, int c1, int c2, int c3, float s) {
  return make_float4(static_cast<float>(c0) * s, static_cast<float>(c1) * s,
                     static_cast<float>(c2) * s, static_cast<float>(c3) * s);
}

// values 4p .. 4p + 3 of a stored row from the lane's piece of it: a float4
// (fp), 4 int8 codes, or 2 bytes of int4 nibbles (low nibble the even index,
// sign-extended by shifts), times the (position, head) scale
template <int Q>
__device__ __forceinline__ float4 load_piece(const void* row, int piece, const float* scale) {
  if constexpr (Q == kFp) {
    return __ldg(reinterpret_cast<const float4*>(row) + piece);
  } else if constexpr (Q == kInt8) {
    const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(row) + piece);
    return dequant4(static_cast<int8_t>(w), static_cast<int8_t>(w >> 8),
                    static_cast<int8_t>(w >> 16), static_cast<int8_t>(w >> 24), __ldg(scale));
  } else {
    const uint32_t w = __ldg(reinterpret_cast<const uint16_t*>(row) + piece);
    const int b0 = static_cast<int8_t>(w), b1 = static_cast<int8_t>(w >> 8);
    return dequant4(static_cast<int>(static_cast<uint32_t>(b0) << 28) >> 28, b0 >> 4,
                    static_cast<int>(static_cast<uint32_t>(b1) << 28) >> 28, b1 >> 4,
                    __ldg(scale));
  }
}

// K and V rows of one (slot, head) of a paged pool: key j in block
// table[j / block_size] (the sink for a sentinel), row j % block_size
template <int D, int Q>
struct PagedRows {
  static constexpr int kStored = Q == kInt4 ? D / 2 : D;  // stored values a row
  using Elem = typename std::conditional<Q == kFp, float, int8_t>::type;
  const Elem* kp;  // the pool's (head h, the lane's piece 0) element
  const Elem* vp;
  const float* ks;  // the scale planes at head h
  const float* vs;
  const int* table;  // the slot's table row
  int block_size, num_blocks, heads, piece;
  __device__ __forceinline__ void load(int j, float4& kr, float4& vr) const {
    const int id = min(max(__ldg(table + j / block_size), 0), num_blocks);
    const long long row = static_cast<long long>(id) * block_size + j % block_size;
    const long long at = row * heads * kStored;
    const float* k_sc = nullptr;
    const float* v_sc = nullptr;
    if constexpr (Q != kFp) {
      k_sc = ks + row * heads;
      v_sc = vs + row * heads;
    }
    kr = load_piece<Q>(kp + at, piece, k_sc);
    vr = load_piece<Q>(vp + at, piece, v_sc);
  }
};

// kUnroll keys of the round starting at `base`: key base + idx(u) for u <
// kUnroll, zeros past `end`
template <int D, class Rows>
__device__ __forceinline__ void load_round(float4 (&kr)[kUnroll], float4 (&vr)[kUnroll],
                                           const Rows& rows, int base, int lane_key, int end) {
  constexpr int kRowsPerWarp = 32 * 4 / D;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int j = base + lane_key + u * kWarps * kRowsPerWarp;
    if (j < end) {
      rows.load(j, kr[u], vr[u]);
    } else {
      kr[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      vr[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// One split kernel's block, (split, head, slot) = blockIdx, over the key
// rows `rows_of(piece)` gives a lane; `pos` is the slot's position.
template <int D, class RowsOf>
__device__ __forceinline__ void decode_split(const float* __restrict__ q, int pos,
                                             const RowsOf& rows_of, float* __restrict__ out,
                                             float* __restrict__ part_acc,
                                             float* __restrict__ part_ml, int span, int chunk,
                                             float scale) {
  constexpr int kLanesPerRow = D / 4;
  constexpr int kRowsPerWarp = 32 / kLanesPerRow;
  constexpr int kRowsPerRound = kUnroll * kWarps * kRowsPerWarp;
  __shared__ float4 s_acc[kWarps][kLanesPerRow];
  __shared__ float s_m[kWarps], s_l[kWarps];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x, heads = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int piece = lane % kLanesPerRow;  // which float4 of a row
  const int group = lane / kLanesPerRow;  // which of the warp's keys
  const int n = pos < 0 ? 0 : min(pos, span - 1) + 1;  // visible keys
  const int begin = split * chunk, end = min(begin + chunk, n);
  const long long row = static_cast<long long>(b) * heads + h;
  const long long part = row * splits + split;

  if (begin >= end) {  // uniform over the block: nothing visible in this range
    if (splits == 1) {
      for (int i = threadIdx.x; i < kLanesPerRow; i += kWarps * 32)
        reinterpret_cast<float4*>(out + row * D)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else if (threadIdx.x == 0) {
      part_ml[2 * part] = kNegInf;
      part_ml[2 * part + 1] = 0.f;
    }
    return;
  }

  const float4 qv = reinterpret_cast<const float4*>(q + row * D)[piece];
  const auto rows = rows_of(piece);
  const int lane_key = warp * kRowsPerWarp + group;

  float m = kNegInf, l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 kc[kUnroll], vc[kUnroll];
  load_round<D>(kc, vc, rows, begin, lane_key, end);
  // the loop bound is uniform over the block: every lane takes part in the
  // shuffles, and j < end guards the loads
  for (int base = begin; base < end; base += kRowsPerRound) {
    const int next = base + kRowsPerRound;
    float4 kn[kUnroll], vn[kUnroll];
    if (next < end) load_round<D>(kn, vn, rows, next, lane_key, end);

    float s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      s[u] = qv.x * kc[u].x + qv.y * kc[u].y + qv.z * kc[u].z + qv.w * kc[u].w;
#pragma unroll
    for (int o = kLanesPerRow / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
    }
    float mx = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool live = base + lane_key + u * kWarps * kRowsPerWarp < end;
      s[u] = live ? s[u] * scale : kNegInf;
      mx = fmaxf(mx, s[u]);
    }
    const float alpha = expf(m - mx);
    l *= alpha;
    acc = scale4(acc, alpha);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // a masked key adds nothing, also while no key has been seen
      const float p = s[u] > 0.5f * kNegInf ? expf(s[u] - mx) : 0.f;
      l += p;
      acc = fma4(vc[u], p, acc);
    }
    m = mx;
    if (next < end) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        kc[u] = kn[u];
        vc[u] = vn[u];
      }
    }
  }

  // the warp's key groups, then the warps in order
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
  m = s_m[0];
  l = s_l[0];
  acc = s_acc[0][piece];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) merge(m, l, acc, s_m[w], s_l[w], s_acc[w][piece]);
  if (splits == 1) {
    // a visible key makes l >= 1
    reinterpret_cast<float4*>(out + row * D)[piece] = scale4(acc, 1.f / l);
    return;
  }
  reinterpret_cast<float4*>(part_acc + part * D)[piece] = acc;
  if (piece == 0) {
    part_ml[2 * part] = m;
    part_ml[2 * part + 1] = l;
  }
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
span_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const int* __restrict__ positions,
                   float* __restrict__ out, float* __restrict__ part_acc,
                   float* __restrict__ part_ml, int span, int chunk, long long k_slot,
                   long long k_pos, long long k_head, long long v_slot, long long v_pos,
                   long long v_head, float scale) {
  const int h = blockIdx.y, b = blockIdx.z;
  const auto rows_of = [&](int piece) {
    return ArenaRows{k + b * k_slot + h * k_head + piece * 4,
                     v + b * v_slot + h * v_head + piece * 4, k_pos, v_pos};
  };
  decode_split<D>(q, positions[b], rows_of, out, part_acc, part_ml, span, chunk, scale);
}

// the paged pool [num_blocks + 1, block_size, heads, stored] (codes of the
// stored type), scale planes [num_blocks + 1, block_size, heads] (quantized
// only), tables [batch, table_len]
template <int D, int Q>
__global__ void __launch_bounds__(kWarps * 32)
paged_span_decode_kernel(const float* __restrict__ q, const void* __restrict__ k,
                         const void* __restrict__ v, const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale, const int* __restrict__ tables,
                         const int* __restrict__ positions, float* __restrict__ out,
                         float* __restrict__ part_acc, float* __restrict__ part_ml,
                         int table_len, int block_size, int num_blocks, int chunk, float scale) {
  using Rows = PagedRows<D, Q>;
  using Elem = typename Rows::Elem;
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const auto rows_of = [&](int piece) {
    return Rows{static_cast<const Elem*>(k) + h * Rows::kStored,
                static_cast<const Elem*>(v) + h * Rows::kStored,
                k_scale == nullptr ? nullptr : k_scale + h,
                v_scale == nullptr ? nullptr : v_scale + h,
                tables + static_cast<long long>(b) * table_len,
                block_size, num_blocks, heads, piece};
  };
  decode_split<D>(q, positions[b], rows_of, out, part_acc, part_ml, table_len * block_size,
                  chunk, scale);
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
      const float e = expf(ml[2 * s] - mx);
      l = fmaf(ls, e, l);
      acc = fma4(reinterpret_cast<const float4*>(part_acc + (row * splits + s) * D)[piece], e,
                 acc);
    }
  }
  reinterpret_cast<float4*>(out + row * D)[piece] =
      l > 0.f ? scale4(acc, 1.f / l) : make_float4(0.f, 0.f, 0.f, 0.f);
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
  span_decode_kernel<D><<<grid, kWarps * 32, 0, stream>>>(
      q, k, v, positions, out, part_acc, part_ml, span, chunk, k_slot, k_pos, k_head, v_slot,
      v_pos, v_head, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  constexpr int kRowsPerBlock = kMergeThreads / (D / 4);
  const unsigned blocks = static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  span_decode_merge_kernel<D><<<blocks, kMergeThreads, 0, stream>>>(
      part_acc, part_ml, out, static_cast<int>(rows), splits);
  return cudaGetLastError();
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
  paged_span_decode_kernel<D, Q><<<grid, kWarps * 32, 0, stream>>>(
      q, k, v, k_scale, v_scale, tables, positions, out, part_acc, part_ml, table_len,
      block_size, num_blocks, chunk, scale);
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
// elephas_span_decode, and the workspace too.
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

extern "C" const char* elephas_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
