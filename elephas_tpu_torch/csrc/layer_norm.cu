// LayerNorm forward and backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of elephas_tpu/ops/layer_norm.py:
//   _fwd_kernel (:52, launched by _fwd_call :96) — row LayerNorm forward:
//     f32 mean, var = mean((x - mean)^2), rstd = rsqrt(var + eps),
//     y = (x - mean) * rstd * gamma + beta in x's type; mean, rstd in f32;
//   _bwd_kernel (:66, launched by _ln_bwd_rule :128) — with w = gamma,
//     dx = (w.dy - mean(w.dy) - xhat * mean(w.dy * xhat)) * rstd, and
//     dgamma = sum over rows of dy * xhat, dbeta = sum over rows of dy.
//
// The TPU backward carried dgamma/dbeta in VMEM scratch across its
// sequential row grid. Blocks of a GPU grid run in parallel and in no
// order, so here the backward is two launches: ln_bwd_kernel walks a fixed
// set of rows per block, writes dx, and writes the block's f32 partial sums
// as one row of [blocks, d]; ln_bwd_reduce_kernel then sums those rows in a
// fixed order. No atomics: the results repeat bit for bit from run to run.
//
// What bounds it on the H100: a LayerNorm does a handful of flops per
// element, far below the card's ridge, so both directions are bound by
// device memory: the forward reads x and writes y (plus 8 bytes a row),
// the backward reads x and dy and writes dx. The design keeps each row in
// registers (one warp, or two to eight warps for d > 512, per row, with
// VPT values a thread), so x is read from device memory once, and the
// two-pass statistics (mean first, then the mean of (x - mean)^2, never
// E[x^2] - mean^2) cost no second read. Loads are scalar and coalesced
// (thread t of a row reads columns t, t + threads, ...). Widths up to 8192
// are taken; the row tail is masked. Making it fast (vector loads, tuning
// the rows per block) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
// floats of the buffer that combines a block's row slots in the backward:
// rows per block x d is at most 8192 for every width the dispatch takes
constexpr int kCombine = 8192;
constexpr int kMaxWidth = 8192;
constexpr int kReduceCols = 32;
constexpr int kReduceLanes = 8;

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

// butterfly: every lane ends with the same bits (a + b == b + a)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the WPR warps of one row, in warp order; every thread of the
// block must call it (it synchronises the block when WPR > 1).
template <int WPR>
__device__ __forceinline__ float row_sum(float v, float* red) {
  v = warp_sum(v);
  if constexpr (WPR == 1) {
    return v;
  } else {
    const int warp = threadIdx.x / 32;
    const int first = warp - warp % WPR;
    __syncthreads();  // every thread has read the previous sum
    if (threadIdx.x % 32 == 0) red[warp] = v;
    __syncthreads();
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < WPR; ++w) total += red[first + w];
    return total;
  }
}

template <typename T, int VPT, int WPR>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, T* __restrict__ y, float* __restrict__ mean_out,
              float* __restrict__ rstd_out, int n_rows, int d, float eps) {
  constexpr int kTPR = 32 * WPR;  // threads per row
  constexpr int kRPB = kThreads / kTPR;
  __shared__ float red[kThreads / 32];
  const int t = threadIdx.x % kTPR;
  const long long row = static_cast<long long>(blockIdx.x) * kRPB + threadIdx.x / kTPR;
  const bool live = row < n_rows;
  const T* xr = x + row * d;

  float v[VPT];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = t + i * kTPR;
    v[i] = (live && c < d) ? to_float(xr[c]) : 0.f;
    sum += v[i];
  }
  const float mean = row_sum<WPR>(sum, red) / static_cast<float>(d);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = t + i * kTPR;
    v[i] = c < d ? v[i] - mean : 0.f;
    sq += v[i] * v[i];
  }
  const float rstd = rsqrtf(row_sum<WPR>(sq, red) / static_cast<float>(d) + eps);
  if (!live) return;  // no block-wide sync follows

  T* yr = y + row * d;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = t + i * kTPR;
    if (c < d) yr[c] = from_float<T>(v[i] * rstd * gamma[c] + beta[c]);
  }
  if (t == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// dx for the rows blockIdx.x * kRPB + slot + k * gridDim.x * kRPB, and the
// block's dgamma/dbeta partial sums as row blockIdx.x of [gridDim.x, d].
template <typename T, int VPT, int WPR>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma, const T* __restrict__ dy,
              const float* __restrict__ mean, const float* __restrict__ rstd, T* __restrict__ dx,
              float* __restrict__ dgamma_part, float* __restrict__ dbeta_part, int n_rows, int d) {
  constexpr int kTPR = 32 * WPR;
  constexpr int kRPB = kThreads / kTPR;
  static_assert(kRPB * kTPR == kThreads, "rows must tile the block");
  __shared__ float red[kThreads / 32];
  __shared__ float combine[kCombine];
  const int t = threadIdx.x % kTPR;
  const int slot = threadIdx.x / kTPR;

  float dg[VPT], db[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) dg[i] = db[i] = 0.f;

  const long long step = static_cast<long long>(gridDim.x) * kRPB;
  // the bound depends on blockIdx only: every thread of the block takes
  // the same trips, as row_sum's barriers need
  for (long long first = static_cast<long long>(blockIdx.x) * kRPB; first < n_rows;
       first += step) {
    const long long row = first + slot;
    const bool live = row < n_rows;
    const float m = live ? mean[row] : 0.f;
    const float r = live ? rstd[row] : 0.f;
    float xh[VPT], w[VPT];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = t + i * kTPR;
      if (live && c < d) {
        const float g = to_float(dy[row * d + c]);
        xh[i] = (to_float(x[row * d + c]) - m) * r;
        w[i] = g * gamma[c];
        dg[i] += g * xh[i];
        db[i] += g;
      } else {
        xh[i] = w[i] = 0.f;
      }
      s1 += w[i];
      s2 += w[i] * xh[i];
    }
    const float c1 = row_sum<WPR>(s1, red) / static_cast<float>(d);
    const float c2 = row_sum<WPR>(s2, red) / static_cast<float>(d);
    if (live) {
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        const int c = t + i * kTPR;
        if (c < d) dx[row * d + c] = from_float<T>((w[i] - c1 - xh[i] * c2) * r);
      }
    }
  }

  // the block's row slots, summed in slot order: dgamma, then dbeta
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = t + i * kTPR;
      if (c < d) combine[slot * d + c] = pass ? db[i] : dg[i];
    }
    __syncthreads();
    float* out = (pass ? dbeta_part : dgamma_part) + static_cast<long long>(blockIdx.x) * d;
    for (int c = threadIdx.x; c < d; c += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kRPB; ++k) s += combine[k * d + c];
      out[c] = s;
    }
  }
}

// dgamma[c] = sum over p of dgamma_part[p, c] (and dbeta alike), in a fixed
// order: lane l sums parts l, l + 8, ..., then lanes 0..7 are added in order.
__global__ void __launch_bounds__(kReduceCols * kReduceLanes)
ln_bwd_reduce_kernel(const float* __restrict__ dgamma_part, const float* __restrict__ dbeta_part,
                     float* __restrict__ dgamma, float* __restrict__ dbeta, int n_parts, int d) {
  __shared__ float sg[kReduceLanes][kReduceCols];
  __shared__ float sb[kReduceLanes][kReduceCols];
  const int c = blockIdx.x * kReduceCols + threadIdx.x;
  float g = 0.f, b = 0.f;
  if (c < d) {
    for (int p = threadIdx.y; p < n_parts; p += kReduceLanes) {
      g += dgamma_part[static_cast<long long>(p) * d + c];
      b += dbeta_part[static_cast<long long>(p) * d + c];
    }
  }
  sg[threadIdx.y][threadIdx.x] = g;
  sb[threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.y == 0 && c < d) {
    float tg = 0.f, tb = 0.f;
#pragma unroll
    for (int l = 0; l < kReduceLanes; ++l) {
      tg += sg[l][threadIdx.x];
      tb += sb[l][threadIdx.x];
    }
    dgamma[c] = tg;
    dbeta[c] = tb;
  }
}

template <int N>
using Int = std::integral_constant<int, N>;

// Calls f(Int<VPT>, Int<WPR>) for the smallest row layout that holds d:
// one warp per row up to d = 512, then 2, 4 and 8 warps.
template <typename F>
cudaError_t dispatch_width(int d, F&& f) {
  if (d < 1) return cudaErrorInvalidValue;
  if (d <= 32) return f(Int<1>{}, Int<1>{});
  if (d <= 64) return f(Int<2>{}, Int<1>{});
  if (d <= 128) return f(Int<4>{}, Int<1>{});
  if (d <= 256) return f(Int<8>{}, Int<1>{});
  if (d <= 512) return f(Int<16>{}, Int<1>{});
  if (d <= 1024) return f(Int<16>{}, Int<2>{});
  if (d <= 2048) return f(Int<16>{}, Int<4>{});
  if (d <= 4096) return f(Int<16>{}, Int<8>{});
  if (d <= kMaxWidth) return f(Int<32>{}, Int<8>{});
  return cudaErrorInvalidValue;
}

template <typename F>
cudaError_t dispatch_type(int dtype, F&& f) {
  switch (dtype) {
    case 0: return f(float{});
    case 1: return f(__nv_bfloat16{});
    default: return cudaErrorInvalidValue;
  }
}

template <int VPT, int WPR>
constexpr int rows_per_block() {
  return kThreads / (32 * WPR);
}

}  // namespace

// x, y: [n_rows, d] contiguous in dtype (0 float32, 1 bfloat16); gamma,
// beta: [d] float32; mean, rstd: [n_rows] float32. 1 <= d <= 8192,
// n_rows >= 1. Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int elephas_ln_fwd(const void* x, const void* gamma, const void* beta, void* y,
                              void* mean, void* rstd, int dtype, int n_rows, int d, float eps,
                              void* stream) {
  if (n_rows < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch_type(dtype, [&](auto tag) {
    using T = decltype(tag);
    return dispatch_width(d, [&](auto vpt, auto wpr) {
      constexpr int VPT = decltype(vpt)::value, WPR = decltype(wpr)::value;
      constexpr int kRPB = rows_per_block<VPT, WPR>();
      const unsigned blocks = static_cast<unsigned>((n_rows + kRPB - 1) / kRPB);
      ln_fwd_kernel<T, VPT, WPR><<<blocks, kThreads, 0, st>>>(
          static_cast<const T*>(x), static_cast<const float*>(gamma),
          static_cast<const float*>(beta), static_cast<T*>(y), static_cast<float*>(mean),
          static_cast<float*>(rstd), n_rows, d, eps);
      return cudaGetLastError();
    });
  });
}

// The backward's block count for these rows on the current device: as many
// blocks as fit on the card at once, at most one per row slot. The caller
// allocates the [blocks, d] partial-sum buffers for elephas_ln_bwd.
extern "C" int elephas_ln_bwd_blocks(int dtype, int n_rows, int d, int* blocks) {
  if (n_rows < 1) return cudaErrorInvalidValue;
  return dispatch_type(dtype, [&](auto tag) {
    using T = decltype(tag);
    return dispatch_width(d, [&](auto vpt, auto wpr) {
      constexpr int VPT = decltype(vpt)::value, WPR = decltype(wpr)::value;
      constexpr int kRPB = rows_per_block<VPT, WPR>();
      int device = 0, sms = 0, per_sm = 0;
      cudaError_t err = cudaGetDevice(&device);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, ln_bwd_kernel<T, VPT, WPR>, kThreads, 0);
      if (err != cudaSuccess) return err;
      const long long slots = (static_cast<long long>(n_rows) + kRPB - 1) / kRPB;
      const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
      *blocks = static_cast<int>(slots < resident ? slots : resident);
      return cudaSuccess;
    });
  });
}

// First launch of the backward. x, dy, dx: [n_rows, d] contiguous in dtype;
// gamma: [d] float32; mean, rstd: [n_rows] float32; dgamma_part,
// dbeta_part: [blocks, d] float32 (blocks from elephas_ln_bwd_blocks).
extern "C" int elephas_ln_bwd(const void* x, const void* gamma, const void* dy, const void* mean,
                              const void* rstd, void* dx, void* dgamma_part, void* dbeta_part,
                              int dtype, int n_rows, int d, int blocks, void* stream) {
  if (n_rows < 1 || blocks < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch_type(dtype, [&](auto tag) {
    using T = decltype(tag);
    return dispatch_width(d, [&](auto vpt, auto wpr) {
      constexpr int VPT = decltype(vpt)::value, WPR = decltype(wpr)::value;
      ln_bwd_kernel<T, VPT, WPR><<<blocks, kThreads, 0, st>>>(
          static_cast<const T*>(x), static_cast<const float*>(gamma), static_cast<const T*>(dy),
          static_cast<const float*>(mean), static_cast<const float*>(rstd), static_cast<T*>(dx),
          static_cast<float*>(dgamma_part), static_cast<float*>(dbeta_part), n_rows, d);
      return cudaGetLastError();
    });
  });
}

// Second launch of the backward: dgamma, dbeta [d] float32 from the
// [n_parts, d] partial sums.
extern "C" int elephas_ln_bwd_reduce(const void* dgamma_part, const void* dbeta_part,
                                     void* dgamma, void* dbeta, int n_parts, int d,
                                     void* stream) {
  if (n_parts < 1 || d < 1) return cudaErrorInvalidValue;
  const dim3 block(kReduceCols, kReduceLanes);
  const unsigned grid = static_cast<unsigned>((d + kReduceCols - 1) / kReduceCols);
  ln_bwd_reduce_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dgamma_part), static_cast<const float*>(dbeta_part),
      static_cast<float*>(dgamma), static_cast<float*>(dbeta), n_parts, d);
  return cudaGetLastError();
}

extern "C" const char* elephas_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
