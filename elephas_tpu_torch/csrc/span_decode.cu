// Decode attention over the fixed KV arena for Hopper (sm_90a): one query
// row a slot, over the first `span` positions of the slot's arena row.
//
// Replaces elephas_tpu/ops/flash_serving.py::flash_span_decode (:153), which
// is flash_span_chunk (:93) with one query row: plain XLA in the reference,
// not a Pallas kernel. Every generated token pays it on every layer.
//
// What it computes, per (slot b, head h): with pos = positions[b] read from
// device memory (no host sync), the keys j with j <= pos and j < span are
// visible; s_j = q . k_j * scale in fp32, an online softmax (m, l, acc in
// fp32) and out = acc / l, or zeros when no key is visible (pos < 0). Only
// keys 0 .. min(pos, span - 1) are read: a stale cursor past the span on an
// inactive lane reads nothing beyond the span and outputs a finite value
// nobody reads.
//
// Layout: q and out are contiguous [B, H, D]; k and v are views of the arena
// [slots, maxlen, H, D] cut to [B, span, H, D], passed as element strides
// (slot, position, head) with unit stride on D, so nothing is copied.
//
// What bounds it on the H100: each visible K and V row is read once and
// used for 2 * D flops, so it is bound by device memory:
// 2 * sum_b min(pos_b + 1, span) * H * D * 4 bytes over 3.35 TB/s. At the
// engine's shapes (16 slots, 4 heads, spans up to 512) that is at most a few
// MB a call, microseconds, so launch latency dominates the call.
//
// Design (simple first): one block of kWarps warps per (b, h). A key row of
// D floats is split into D / 4 float4 pieces, one per lane, so a warp reads
// 32 * 4 / D keys at once (one at D = 128, eight at D = 16) with 16-byte
// loads; each lane group of a row keeps kUnroll keys in flight, reduces
// their dot products by shuffles within the group and folds them into its
// own (m, l, acc). The groups of a warp merge by shuffles, the warps through
// shared memory in a fixed order, so the result repeats bit for bit. The
// next design (ROADMAP Queue B) splits the span over more blocks with an lse
// merge, since B * H = 64 blocks leave most of the 132 SMs idle.

#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kUnroll = 4;

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

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
span_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const int* __restrict__ positions,
                   float* __restrict__ out, int heads, int span, long long k_slot,
                   long long k_pos, long long k_head, long long v_slot, long long v_pos,
                   long long v_head, float scale) {
  constexpr int kLanesPerRow = D / 4;
  constexpr int kRowsPerWarp = 32 / kLanesPerRow;
  constexpr int kRowsPerStep = kWarps * kRowsPerWarp;
  __shared__ float4 s_acc[kWarps][kLanesPerRow];
  __shared__ float s_m[kWarps], s_l[kWarps];

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int piece = lane % kLanesPerRow;  // which float4 of a row
  const int group = lane / kLanesPerRow;  // which of the warp's keys
  const int pos = positions[b];
  const int n = pos < 0 ? 0 : min(pos, span - 1) + 1;  // visible keys

  const long long row = static_cast<long long>(b) * heads + h;
  const float4 qv = reinterpret_cast<const float4*>(q + row * D)[piece];
  const float* kb = k + b * k_slot + h * k_head + piece * 4;
  const float* vb = v + b * v_slot + h * v_head + piece * 4;

  float m = kNegInf, l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  // the loop bound is uniform over the warp: every lane takes part in the
  // shuffles, and j < n guards the loads
  for (int base = warp * kRowsPerWarp; base < n; base += kUnroll * kRowsPerStep) {
    float s[kUnroll];
    float4 vv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + group + u * kRowsPerStep;
      s[u] = 0.f;
      vv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < n) {
        const float4 kv = *reinterpret_cast<const float4*>(kb + j * k_pos);
        vv[u] = *reinterpret_cast<const float4*>(vb + j * v_pos);
        s[u] = qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
    }
#pragma unroll
    for (int o = kLanesPerRow / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
    }
    float mx = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool live = base + group + u * kRowsPerStep < n;
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
      acc = fma4(vv[u], p, acc);
    }
    m = mx;
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
  const float inv = l > 0.f ? 1.f / l : 0.f;
  reinterpret_cast<float4*>(out + row * D)[piece] = scale4(acc, inv);
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, const int* positions,
                   float* out, int batch, int heads, int span, long long k_slot,
                   long long k_pos, long long k_head, long long v_slot, long long v_pos,
                   long long v_head, float scale, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(heads), static_cast<unsigned>(batch));
  span_decode_kernel<D><<<grid, kWarps * 32, 0, stream>>>(
      q, k, v, positions, out, heads, span, k_slot, k_pos, k_head, v_slot, v_pos, v_head,
      scale);
  return cudaGetLastError();
}

}  // namespace

// q, out: [batch, heads, head_dim] float32, contiguous; k, v: [batch, span,
// heads, head_dim] float32 views with element strides (slot, pos, head) and
// unit stride on head_dim, every stride a multiple of 4 and every base
// pointer 16-byte aligned; positions: [batch] int32 on the device.
extern "C" int elephas_span_decode(const void* q, const void* k, const void* v,
                                   const void* positions, void* out, int batch, int heads,
                                   int head_dim, int span, long long k_slot, long long k_pos,
                                   long long k_head, long long v_slot, long long v_pos,
                                   long long v_head, float scale, void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || span < 1) return cudaErrorInvalidValue;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* pos = static_cast<const int*>(positions);
  auto* of = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return launch<16>(qf, kf, vf, pos, of, batch, heads, span, k_slot, k_pos, k_head,
                        v_slot, v_pos, v_head, scale, st);
    case 32:
      return launch<32>(qf, kf, vf, pos, of, batch, heads, span, k_slot, k_pos, k_head,
                        v_slot, v_pos, v_head, scale, st);
    case 64:
      return launch<64>(qf, kf, vf, pos, of, batch, heads, span, k_slot, k_pos, k_head,
                        v_slot, v_pos, v_head, scale, st);
    case 128:
      return launch<128>(qf, kf, vf, pos, of, batch, heads, span, k_slot, k_pos, k_head,
                         v_slot, v_pos, v_head, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* elephas_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
