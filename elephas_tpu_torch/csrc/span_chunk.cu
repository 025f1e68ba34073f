// Chunk attention over the fixed KV arena for Hopper (sm_90a): C query rows
// a slot, each at its own absolute position, over the first `span` positions
// of the slot's arena row, with the span split over the card and the splits
// merged by their lse.
//
// Replaces elephas_tpu/ops/flash_serving.py::flash_span_chunk (:93), plain
// XLA in the reference, not a Pallas kernel: the attention of chunked
// prefill, of the suffix prefill after a prefix-cache hit and of the
// speculative verify pass (elephas_tpu/serving/kv_cache.py:476, :603).
//
// What it computes, per (slot b, chunk row c, head h): with p = pos[b, c]
// read from device memory (no host sync), the keys j with j <= p and
// j < span are visible; s_j = q . k_j * scale in fp32, softmax over the
// visible keys in fp32 and out = sum_j p_j v_j, or zeros when no key is
// visible. A row's position past the span (a padded tail, an inactive
// lane) reads nothing beyond the span: its visible count is clamped, as the
// decode kernel clamps a stale cursor.
//
// Layout: q and out are contiguous [B, H, C, D]; pos is contiguous [B, C]
// int32; k and v are views of the arena [slots, maxlen, H, D] cut to
// [slots, span, H, D], passed as element strides (slot, position, head)
// with unit stride on D; row b of q reads arena slot slot_map[b] (int64,
// null = b), so a call over some of the arena's slots copies nothing.
//
// What bounds it on the H100: the K and V rows of the visible span are read
// once (2 * sum_b n_b * H * D * 4 bytes, n_b the slot's visible keys) and
// each serves C rows with 4 * D flops a key: 4 * C * D flops a key against
// 8 * D bytes, so at C = 64 it is bound by fp32 operations (67 TFLOP/s
// outside the tensor cores), and below C ~ 16 by device memory.
//
// Design. The difference from the decode kernel is reuse: the grid is
// (splits, heads, batch) and a block owns one fixed range of `chunk` key
// positions of one (slot, head) for ALL the slot's C rows. It stages a tile
// of kTile keys of K and V in shared memory once, and every query row of
// the slot reads it there. The rows go kRows a warp, four warps, 64 rows a
// group (larger C loops over groups; the q rows of a group sit in shared
// memory). In a tile, lane j computes the scores of key j for the warp's
// rows (K rows padded by 4 floats, so the float4 reads of 8 lanes hit
// distinct banks), the warp folds them into each row's (m, l) by shuffles,
// writes p to shared memory, and each lane accumulates the float4 piece of
// the output it owns over the tile's keys. The host picks `splits` from the
// span, batch * heads and the SM count (ops/flash_serving.py::span_splits),
// never from the positions. With more than one split each block writes its
// unnormalised partial (m, l, acc[D]) per row to a workspace the wrapper
// allocates, and a second kernel merges a row's partials in split order by
// lse. Every order is fixed: a call repeats bit for bit, and a CUDA graph
// replays it as it is.

#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kRows = 16;                    // query rows a warp
constexpr int kGroup = kWarps * kRows;       // query rows a block holds
constexpr int kTile = 32;                    // keys a tile: one a lane
constexpr int kMergeThreads = 128;

__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

__device__ __forceinline__ float4 fma4(float4 a, float s, float4 c) {
  return make_float4(fmaf(a.x, s, c.x), fmaf(a.y, s, c.y), fmaf(a.z, s, c.z),
                     fmaf(a.w, s, c.w));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float c) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, c))));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
struct Smem {
  static constexpr int kKStride = D + 4;  // floats a staged K row
  static constexpr int kQ = kGroup * D;
  static constexpr int kK = kTile * kKStride;
  static constexpr int kV = kTile * D;
  static constexpr int kP = kWarps * kRows * kTile;
  static constexpr size_t kBytes = (kQ + kK + kV + kP) * sizeof(float) + kGroup * sizeof(int);
};

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
span_chunk_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int* __restrict__ pos,
                  const long long* __restrict__ slot_map, float* __restrict__ out,
                  float* __restrict__ part_acc, float* __restrict__ part_ml, int rows_c,
                  int span, int chunk, int num_slots, long long k_slot, long long k_pos,
                  long long k_head, long long v_slot, long long v_pos, long long v_head,
                  float scale) {
  using S = Smem<D>;
  constexpr int kPieces = D / 4;  // float4 pieces of a row
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* q_s = smem;                  // [kGroup][D]
  float* k_s = q_s + S::kQ;           // [kTile][D + 4]
  float* v_s = k_s + S::kK;           // [kTile][D]
  float* p_s = v_s + S::kV;           // [kWarps][kRows][kTile]
  int* pos_s = reinterpret_cast<int*>(p_s + S::kP);  // [kGroup]
  __shared__ int s_nvis[kWarps];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x, heads = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long bh = static_cast<long long>(b) * heads + h;
  long long slot = slot_map == nullptr ? b : slot_map[b];
  const bool slot_ok = slot >= 0 && slot < num_slots;
  if (!slot_ok) slot = 0;
  const float* kb = k + slot * k_slot + h * k_head;
  const float* vb = v + slot * v_slot + h * v_head;
  const int begin = split * chunk;

  for (int g0 = 0; g0 < rows_c; g0 += kGroup) {
    __syncthreads();  // the previous group's readers are done with q_s, pos_s
    // the group's positions, and the visible keys of its deepest row
    int nv = 0;
    for (int r = threadIdx.x; r < kGroup; r += kWarps * 32) {
      const int c = g0 + r;
      int p = c < rows_c && slot_ok ? pos[static_cast<long long>(b) * rows_c + c] : -1;
      pos_s[r] = p;
      nv = max(nv, p < 0 ? 0 : min(p, span - 1) + 1);
    }
    nv = static_cast<int>(warp_max(static_cast<float>(nv)));
    if (lane == 0) s_nvis[warp] = nv;
    for (int i = threadIdx.x; i < kGroup * kPieces; i += kWarps * 32) {
      const int r = i / kPieces, piece = i % kPieces;
      const int c = g0 + r;
      reinterpret_cast<float4*>(q_s)[i] =
          c < rows_c ? reinterpret_cast<const float4*>(q + (bh * rows_c + c) * D)[piece]
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    int n_vis = s_nvis[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) n_vis = max(n_vis, s_nvis[w]);
    const int end = min(begin + chunk, n_vis);

    float m[kRows], l[kRows];
    float4 acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
      acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    // a row of this warp: group row warp * kRows + r
    const float* qw = q_s + warp * kRows * D;
    const int* pw = pos_s + warp * kRows;
    float* pp = p_s + warp * kRows * kTile;

    for (int t0 = begin; t0 < end; t0 += kTile) {  // uniform over the block
      __syncthreads();  // every warp is done with the previous tile
      for (int i = threadIdx.x; i < kTile * kPieces; i += kWarps * 32) {
        const int jj = i / kPieces, piece = i % kPieces;
        const int j = t0 + jj;
        float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
        if (j < end) {
          kv = __ldg(reinterpret_cast<const float4*>(kb + j * k_pos) + piece);
          vv = __ldg(reinterpret_cast<const float4*>(vb + j * v_pos) + piece);
        }
        reinterpret_cast<float4*>(k_s + jj * S::kKStride)[piece] = kv;
        reinterpret_cast<float4*>(v_s)[i] = vv;
      }
      __syncthreads();

      // scores of key t0 + lane for the warp's rows
      float s[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = 0.f;
      const float4* kr = reinterpret_cast<const float4*>(k_s + lane * S::kKStride);
#pragma unroll 4
      for (int piece = 0; piece < kPieces; ++piece) {
        const float4 kv = kr[piece];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          s[r] = dot4(reinterpret_cast<const float4*>(qw + r * D)[piece], kv, s[r]);
      }
      const int j = t0 + lane;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const bool live = j < end && j <= pw[r];
        const float sv = live ? s[r] * scale : kNegInf;
        const float mx = fmaxf(m[r], warp_max(sv));
        // a masked key adds nothing, also while no key has been seen
        const float p = sv > 0.5f * kNegInf ? expf(sv - mx) : 0.f;
        const float alpha = expf(m[r] - mx);
        l[r] = l[r] * alpha + warp_sum(p);
        acc[r] = scale4(acc[r], alpha);
        m[r] = mx;
        pp[r * kTile + lane] = p;
      }
      __syncwarp();
      if (lane < kPieces) {
        const float4* vr = reinterpret_cast<const float4*>(v_s) + lane;
#pragma unroll 4
        for (int jj = 0; jj < kTile; ++jj) {
          const float4 vv = vr[jj * kPieces];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r] = fma4(vv, pp[r * kTile + jj], acc[r]);
        }
      }
      __syncwarp();
    }

    // each row's result: the output itself with one split (a visible key
    // makes l >= 1), else the partial
    if (lane < kPieces) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int c = g0 + warp * kRows + r;
        if (c >= rows_c) break;
        const long long row = bh * rows_c + c;
        if (splits == 1) {
          reinterpret_cast<float4*>(out + row * D)[lane] =
              l[r] > 0.f ? scale4(acc[r], 1.f / l[r]) : make_float4(0.f, 0.f, 0.f, 0.f);
        } else {
          const long long part = (bh * splits + split) * rows_c + c;
          if (l[r] > 0.f) reinterpret_cast<float4*>(part_acc + part * D)[lane] = acc[r];
          if (lane == 0) {
            part_ml[2 * part] = l[r] > 0.f ? m[r] : kNegInf;
            part_ml[2 * part + 1] = l[r];
          }
        }
      }
    }
  }
}

// out[bh, c] <- the lse merge of the row's `splits` partials, in split
// order; D / 4 lanes a row
template <int D>
__global__ void __launch_bounds__(kMergeThreads)
span_chunk_merge_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                        float* __restrict__ out, long long rows, int rows_c, int splits) {
  constexpr int kLanesPerRow = D / 4;
  constexpr int kRowsPerBlock = kMergeThreads / kLanesPerRow;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kLanesPerRow;
  const int piece = threadIdx.x % kLanesPerRow;
  if (row >= rows) return;
  const long long bh = row / rows_c, c = row % rows_c;
  float mx = kNegInf;
  for (int s = 0; s < splits; ++s) {
    const long long part = (bh * splits + s) * rows_c + c;
    if (part_ml[2 * part + 1] > 0.f) mx = fmaxf(mx, part_ml[2 * part]);
  }
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const long long part = (bh * splits + s) * rows_c + c;
    const float ls = part_ml[2 * part + 1];
    if (ls > 0.f) {  // an empty split wrote no acc
      const float e = expf(part_ml[2 * part] - mx);
      l = fmaf(ls, e, l);
      acc = fma4(reinterpret_cast<const float4*>(part_acc + part * D)[piece], e, acc);
    }
  }
  reinterpret_cast<float4*>(out + row * D)[piece] =
      l > 0.f ? scale4(acc, 1.f / l) : make_float4(0.f, 0.f, 0.f, 0.f);
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, const int* pos,
                   const long long* slot_map, float* out, float* workspace, int batch,
                   int heads, int rows_c, int span, int splits, int chunk, int num_slots,
                   long long k_slot, long long k_pos, long long k_head, long long v_slot,
                   long long v_pos, long long v_head, float scale, cudaStream_t stream) {
  const long long rows = static_cast<long long>(batch) * heads * rows_c;
  // the workspace: acc [B·H, splits, C, D], then (m, l) [B·H, splits, C, 2]
  float* part_acc = workspace;
  float* part_ml = workspace == nullptr ? nullptr : workspace + rows * splits * D;
  constexpr size_t kSmem = Smem<D>::kBytes;
  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        span_chunk_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmem));
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  const dim3 grid(static_cast<unsigned>(splits), static_cast<unsigned>(heads),
                  static_cast<unsigned>(batch));
  span_chunk_kernel<D><<<grid, kWarps * 32, kSmem, stream>>>(
      q, k, v, pos, slot_map, out, part_acc, part_ml, rows_c, span, chunk, num_slots, k_slot,
      k_pos, k_head, v_slot, v_pos, v_head, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  constexpr int kRowsPerBlock = kMergeThreads / (D / 4);
  const unsigned blocks = static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  span_chunk_merge_kernel<D><<<blocks, kMergeThreads, 0, stream>>>(part_acc, part_ml, out,
                                                                   rows, rows_c, splits);
  return cudaGetLastError();
}

}  // namespace

// q, out: [batch, heads, rows_c, head_dim] float32, contiguous; k, v:
// [num_slots, span, heads, head_dim] float32 views with element strides
// (slot, pos, head) and unit stride on head_dim, every stride a multiple of
// 4 and every base pointer 16-byte aligned; pos: [batch, rows_c] int32 on
// the device; slot_map: [batch] int64 arena slots of q's rows, or null for
// row b = slot b (then batch <= num_slots). splits blocks of chunk key
// positions each cover the span (splits * chunk >= span); with splits > 1,
// workspace holds batch * heads * splits * rows_c * (head_dim + 2) floats,
// 16-byte aligned, else it may be null.
extern "C" int elephas_span_chunk(const void* q, const void* k, const void* v, const void* pos,
                                  const void* slot_map, void* out, void* workspace, int batch,
                                  int heads, int rows_c, int head_dim, int span, int splits,
                                  int chunk, int num_slots, long long k_slot, long long k_pos,
                                  long long k_head, long long v_slot, long long v_pos,
                                  long long v_head, float scale, void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 || rows_c < 1 || span < 1 ||
      splits < 1 || chunk < 1 || num_slots < 1 ||
      static_cast<long long>(splits) * chunk < span ||
      (slot_map == nullptr && batch > num_slots) || (splits > 1 && workspace == nullptr))
    return cudaErrorInvalidValue;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* pf = static_cast<const int*>(pos);
  const auto* sm = static_cast<const long long*>(slot_map);
  auto* of = static_cast<float*>(out);
  auto* ws = static_cast<float*>(workspace);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return launch<16>(qf, kf, vf, pf, sm, of, ws, batch, heads, rows_c, span, splits, chunk,
                        num_slots, k_slot, k_pos, k_head, v_slot, v_pos, v_head, scale, st);
    case 32:
      return launch<32>(qf, kf, vf, pf, sm, of, ws, batch, heads, rows_c, span, splits, chunk,
                        num_slots, k_slot, k_pos, k_head, v_slot, v_pos, v_head, scale, st);
    case 64:
      return launch<64>(qf, kf, vf, pf, sm, of, ws, batch, heads, rows_c, span, splits, chunk,
                        num_slots, k_slot, k_pos, k_head, v_slot, v_pos, v_head, scale, st);
    case 128:
      return launch<128>(qf, kf, vf, pf, sm, of, ws, batch, heads, rows_c, span, splits, chunk,
                         num_slots, k_slot, k_pos, k_head, v_slot, v_pos, v_head, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* elephas_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
