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

#include <cuda_runtime.h>

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

// kUnroll keys of the round starting at `base`: key base + idx(u) for u <
// kUnroll, zeros past `end`
template <int D>
__device__ __forceinline__ void load_round(float4 (&kr)[kUnroll], float4 (&vr)[kUnroll],
                                           const float* kb, const float* vb, long long k_pos,
                                           long long v_pos, int base, int lane_key, int end) {
  constexpr int kRowsPerWarp = 32 * 4 / D;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int j = base + lane_key + u * kWarps * kRowsPerWarp;
    if (j < end) {
      kr[u] = __ldg(reinterpret_cast<const float4*>(kb + j * k_pos));
      vr[u] = __ldg(reinterpret_cast<const float4*>(vb + j * v_pos));
    } else {
      kr[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      vr[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
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
  const int pos = positions[b];
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
  const float* kb = k + b * k_slot + h * k_head + piece * 4;
  const float* vb = v + b * v_slot + h * v_head + piece * 4;
  const int lane_key = warp * kRowsPerWarp + group;

  float m = kNegInf, l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 kc[kUnroll], vc[kUnroll];
  load_round<D>(kc, vc, kb, vb, k_pos, v_pos, begin, lane_key, end);
  // the loop bound is uniform over the block: every lane takes part in the
  // shuffles, and j < end guards the loads
  for (int base = begin; base < end; base += kRowsPerRound) {
    const int next = base + kRowsPerRound;
    float4 kn[kUnroll], vn[kUnroll];
    if (next < end) load_round<D>(kn, vn, kb, vb, k_pos, v_pos, next, lane_key, end);

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

extern "C" const char* elephas_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
