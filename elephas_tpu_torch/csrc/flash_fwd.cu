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
// type and lse = m + log(safe_l) in fp32. expf and logf, not the fast
// intrinsics.
//
// What bounds it on the H100: causal attention at the serving shapes does
// 2*BH*S^2*D flops on 4*BH*S*D elements. In fp32 that is above the card's
// ridge (compute-bound on the 67 TFLOP/s of fp32 FMA); in bf16 the tensor
// cores would make it memory-bound. This first version is simple on purpose:
// grid (q tiles, B*H), a loop over 64-row kv tiles staged as fp32 in shared
// memory, scores and p.v on the fp32 FMA units (no mma/wgmma, no TMA, no
// pipelining of the loads). Each q row is split over four threads (each
// holds 16 scores and D/4 accumulators), which keeps D = 128 in fp32 well
// inside the register file. Causal kv tiles wholly above the diagonal are
// skipped: their p is exactly 0. Making it fast is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreadsPerRow = 4;
constexpr int kThreads = kBlockQ * kThreadsPerRow;
constexpr int kKeysPerThread = kBlockK / kThreadsPerRow;
constexpr float kNegInf = -1e30f;

// element strides of one [B, H, S, D] operand; D has unit stride
struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Rows [row0, row0 + rows) of one [S, D] slice into shared memory as fp32,
// row stride D + 4 floats (float4-aligned, and consecutive rows start four
// banks apart); rows at or past n_rows are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long seq_stride,
                                          int row0, int n_rows, int rows) {
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int g = row0 + r;
    dst[r * (D + 4) + c] = g < n_rows ? to_float(src[g * seq_stride + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int H, int Sq, int Sk,
                 Strides qs, Strides ks, Strides vs, Strides os, float scale, int causal) {
  constexpr int kStride = D + 4;
  constexpr int kChunks = D / 16;  // float4 column chunks a thread owns
  extern __shared__ float4 smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kBlockQ * kStride;
  float* Vs = Ks + kBlockK * kStride;

  // causal tiles further down hold more work: start them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  // lanes 4r..4r+3 of a warp share q row r; sub picks keys and columns
  const int r = threadIdx.x / kThreadsPerRow;
  const int sub = threadIdx.x % kThreadsPerRow;
  const int row = q0 + r;
  const int lane_base = (threadIdx.x % 32) & ~(kThreadsPerRow - 1);

  q += b * qs.b + h * qs.h;
  k += b * ks.b + h * ks.h;
  v += b * vs.b + h * vs.h;
  load_tile<T, D>(Qs, q, qs.s, q0, Sq, kBlockQ);

  float m = kNegInf, l = 0.f;
  float acc[kChunks][4];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  // columns past the tile's last row are masked for every row of the tile
  const int kv_end = causal ? min(Sk, q0 + kBlockQ) : Sk;
  const float4* qrow = reinterpret_cast<const float4*>(Qs + r * kStride);

  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (and the q tile landed)
    load_tile<T, D>(Ks, k, ks.s, k0, Sk, kBlockK);
    load_tile<T, D>(Vs, v, vs.s, k0, Sk, kBlockK);
    __syncthreads();

    // scores of keys sub, sub + 4, ..., sub + 60 of this tile
    float s[kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 a = qrow[d4];
#pragma unroll
      for (int i = 0; i < kKeysPerThread; ++i) {
        const float4 kk =
            reinterpret_cast<const float4*>(Ks + (sub + i * kThreadsPerRow) * kStride)[d4];
        s[i] = fmaf(a.x, kk.x, s[i]);
        s[i] = fmaf(a.y, kk.y, s[i]);
        s[i] = fmaf(a.z, kk.z, s[i]);
        s[i] = fmaf(a.w, kk.w, s[i]);
      }
    }

    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      const int col = k0 + sub + i * kThreadsPerRow;
      s[i] *= scale;
      if (col >= Sk || (causal && col > row)) s[i] = kNegInf;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    // a row masked so far keeps p = 0, so l stays 0 and the row outputs zeros
    const bool dead = m_new <= 0.5f * kNegInf;
    float row_sum = 0.f;
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      s[i] = dead ? 0.f : expf(s[i] - m_new);
      row_sum += s[i];
    }
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 2);
    const float alpha = expf(m - m_new);
    l = l * alpha + row_sum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] *= alpha;

    // acc += p . v: key src + 4i's p lives in lane lane_base + src, register i;
    // this thread's columns are 16c + 4sub .. 16c + 4sub + 3
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
#pragma unroll
      for (int src = 0; src < kThreadsPerRow; ++src) {
        const float p = __shfl_sync(0xffffffffu, s[i], lane_base + src);
        const float4* vrow =
            reinterpret_cast<const float4*>(Vs + (src + i * kThreadsPerRow) * kStride);
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const float4 vv = vrow[c * kThreadsPerRow + sub];
          acc[c][0] = fmaf(p, vv.x, acc[c][0]);
          acc[c][1] = fmaf(p, vv.y, acc[c][1]);
          acc[c][2] = fmaf(p, vv.z, acc[c][2]);
          acc[c][3] = fmaf(p, vv.w, acc[c][3]);
        }
      }
    }
  }

  if (row < Sq) {
    const float safe_l = l == 0.f ? 1.f : l;
    T* orow = o + b * os.b + h * os.h + row * os.s;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        orow[16 * c + 4 * sub + e] = from_float<T>(acc[c][e] / safe_l);
    if (sub == 0) lse[static_cast<long long>(bh) * Sq + row] = m + logf(safe_l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                   int H, int Sq, int Sk, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, int causal, cudaStream_t stream) {
  const int smem = (kBlockQ + 2 * kBlockK) * (D + 4) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), H, Sq, Sk, qs, ks, vs, os, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, void* o, void* lse,
                       int B, int H, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
                       Strides os, float scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, H, Sq, Sk, qs, ks, vs, os, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, H, Sq, Sk, qs, ks, vs, os, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, H, Sq, Sk, qs, ks, vs, os, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, H, Sq, Sk, qs, ks, vs, os, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: [B, H, S, D] operands given by their (batch, head, seq)
// element strides, unit stride on D; lse: [B*H, Sq] fp32, contiguous.
// dtype 0 is float32, 1 is bfloat16; D is 16, 32, 64 or 128. Launches on
// `stream` without synchronising and returns cudaGetLastError().
extern "C" int elephas_flash_fwd(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int dtype, int B, int H, int Sq, int Sk, int D,
                                 long long q_sb, long long q_sh, long long q_ss,
                                 long long k_sb, long long k_sh, long long k_ss,
                                 long long v_sb, long long v_sh, long long v_ss,
                                 long long o_sb, long long o_sh, long long o_ss,
                                 float scale, int causal, void* stream) {
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(D, q, k, v, o, lse, B, H, Sq, Sk, qs, ks, vs, os, scale, causal, st);
    case 1: return dispatch_d<__nv_bfloat16>(D, q, k, v, o, lse, B, H, Sq, Sk, qs, ks, vs, os, scale, causal, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* elephas_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
