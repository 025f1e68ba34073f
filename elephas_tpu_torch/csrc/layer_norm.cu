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
// device memory at the training rows (32768 x 1024): the forward reads x
// and writes y (plus 8 bytes a row), the backward reads x and dy and writes
// dx. At the serving rows (16 or 512 rows of 512) both are bound by latency:
// the launch, one round trip to memory and the row's reductions. Each row
// is held in registers, so x is read once, and the statistics are two-pass
// (mean first, then the mean of (x - mean)^2, never E[x^2] - mean^2) at no
// second read.
//
// The forward for d <= 1024 (every width the serving and training paths
// run) gives each row one warp and has no block barrier: a block is 1, 2, 4
// or 8 independent warps (the caller picks the count from the rows and the
// SM count), and a warp whose row is past the end leaves at once. Where the
// row is a whole number of 16-byte chunks and x, y, gamma and beta are
// 16-byte aligned, ln_fwd_vec_kernel moves x and y in 16-byte loads and
// stores (lane l takes chunks l, l + 32, ...) and gamma/beta as float4;
// otherwise (an odd width, a view that starts off alignment) the scalar
// ln_fwd_kernel<T, VPT, 1> reads column by column. Wider rows keep 4 or 8
// warps a row with block barriers in row_sum. mean/rstd may be null: the
// serving paths want y only. Sums run in a fixed order, so y is the same
// bits with or without the statistics, on a second call and from a graph.
// The backward keeps PR 2's layout (one to eight warps a row, 256 threads).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
// floats of the buffer that combines a block's row slots in the backward:
// rows per block x d is at most 8192 for every width the dispatch takes
constexpr int kCombine = 8192;
constexpr int kMaxWidth = 8192;
// the forward gives rows up to this width one warp (and no block barrier)
constexpr int kWarpRowWidth = 1024;
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
  __shared__ float red[kThreads / 32];
  const int t = threadIdx.x % kTPR;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / kTPR) + threadIdx.x / kTPR;
  const bool live = row < n_rows;
  if constexpr (WPR == 1) {
    if (!live) return;  // one warp a row: nothing below synchronises the block
  }
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
  if (t == 0 && mean_out != nullptr) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// 16 bytes of x or y as floats, and back (bf16 -> f32 is exact: the bits
// shifted up; f32 -> bf16 rounds to nearest even as from_float does)
__device__ __forceinline__ void unpack16(uint4 raw, float* v, float) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack16(uint4 raw, float* v, __nv_bfloat16) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[2 * q] = __uint_as_float(w[q] << 16);
    v[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack16(const float* v, float) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}
__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}
__device__ __forceinline__ uint4 pack16(const float* v, __nv_bfloat16) {
  return make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]), bf16_pair(v[4], v[5]),
                    bf16_pair(v[6], v[7]));
}

// One warp a row, 16-byte accesses: lane l holds chunks l, l + 32, ... (NC
// at most) of E values each. Rows whose lanes hold at most 16 values load
// their gamma/beta chunks before the reductions, so the reductions hide
// that latency; wider rows (d = 1024) load them after, to spare registers.
// x is read and y written once, with the streaming (evict-first) cache
// hints: at the training rows (256 MB moved a call) the pair was faster
// in a trial than plain loads and stores or either hint alone, and at the
// serving rows it changed nothing measurable.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
ln_fwd_vec_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, T* __restrict__ y,
                  float* __restrict__ mean_out, float* __restrict__ rstd_out, int n_rows, int d,
                  float eps) {
  constexpr int E = 16 / sizeof(T);  // values a chunk
  constexpr int G = E / 4;           // float4s of gamma a chunk
  constexpr bool kEarly = NC * E <= 16;
  constexpr int kParams = kEarly ? NC * G : 1;
  const int lane = threadIdx.x % 32;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= n_rows) return;  // the whole warp: nothing below synchronises the block
  const int chunks = d / E;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  const float4* g4 = reinterpret_cast<const float4*>(gamma);
  const float4* b4 = reinterpret_cast<const float4*>(beta);

  float v[NC][E];
  float4 gp[kParams], bp[kParams];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = lane + 32 * k;
    if (c < chunks) {
      unpack16(__ldcs(xr + c), v[k], T{});
    } else {
#pragma unroll
      for (int j = 0; j < E; ++j) v[k][j] = 0.f;
    }
  }
  if constexpr (kEarly) {
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = lane + 32 * k;
#pragma unroll
      for (int q = 0; q < G; ++q) {
        if (c < chunks) {
          gp[k * G + q] = __ldg(g4 + c * G + q);
          bp[k * G + q] = __ldg(b4 + c * G + q);
        }
      }
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < NC; ++k)
#pragma unroll
    for (int j = 0; j < E; ++j) sum += v[k][j];
  const float mean = warp_sum(sum) / static_cast<float>(d);
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const bool in = lane + 32 * k < chunks;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      v[k][j] = in ? v[k][j] - mean : 0.f;
      sq += v[k][j] * v[k][j];
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(d) + eps);

  uint4* yr = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = lane + 32 * k;
    if (c < chunks) {
      float o[E];
#pragma unroll
      for (int q = 0; q < G; ++q) {
        float4 g, b;
        if constexpr (kEarly) {
          g = gp[k * G + q];
          b = bp[k * G + q];
        } else {
          g = __ldg(g4 + c * G + q);
          b = __ldg(b4 + c * G + q);
        }
        const float* in = v[k] + 4 * q;
        o[4 * q] = in[0] * rstd * g.x + b.x;
        o[4 * q + 1] = in[1] * rstd * g.y + b.y;
        o[4 * q + 2] = in[2] * rstd * g.z + b.z;
        o[4 * q + 3] = in[3] * rstd * g.w + b.w;
      }
      __stcs(yr + c, pack16(o, T{}));
    }
  }
  if (lane == 0 && mean_out != nullptr) {
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

// Calls f(Int<NC>) with NC the 16-byte chunks a lane of a one-warp row
// holds: the row's chunks over 32, rounded up to a power of two.
template <typename F>
cudaError_t dispatch_chunks(int chunks, F&& f) {
  if (chunks <= 32) return f(Int<1>{});
  if (chunks <= 64) return f(Int<2>{});
  if (chunks <= 128) return f(Int<4>{});
  if (chunks <= 256) return f(Int<8>{});
  return cudaErrorInvalidValue;
}

// Calls f(Int<VPT>) for the scalar one-warp row: d over 32, rounded up to a
// power of two (d <= kWarpRowWidth).
template <typename F>
cudaError_t dispatch_warp_width(int d, F&& f) {
  if (d <= 32) return f(Int<1>{});
  if (d <= 64) return f(Int<2>{});
  if (d <= 128) return f(Int<4>{});
  if (d <= 256) return f(Int<8>{});
  if (d <= 512) return f(Int<16>{});
  if (d <= kWarpRowWidth) return f(Int<32>{});
  return cudaErrorInvalidValue;
}

// The forward's route for these operands: 0 one warp a row with 16-byte
// accesses, 1 one warp a row column by column, 2 four or eight warps a row
// (d > kWarpRowWidth); -1 for a width no route takes.
int fwd_route(const void* x, const void* gamma, const void* beta, const void* y, int item,
              int d) {
  if (d < 1 || d > kMaxWidth) return -1;
  if (d > kWarpRowWidth) return 2;
  const auto addr = [](const void* p) { return reinterpret_cast<unsigned long long>(p); };
  const bool aligned = (addr(x) | addr(gamma) | addr(beta) | addr(y)) % 16 == 0;
  return aligned && (static_cast<long long>(d) * item) % 16 == 0 ? 0 : 1;
}

template <int VPT, int WPR>
constexpr int rows_per_block() {
  return kThreads / (32 * WPR);
}

}  // namespace

// x, y: [n_rows, d] contiguous in dtype (0 float32, 1 bfloat16); gamma,
// beta: [d] float32; mean, rstd: [n_rows] float32, or both null to write y
// only. 1 <= d <= 8192, n_rows >= 1. block_rows (1, 2, 4 or 8) is the rows,
// one warp each, of a block where d <= 1024; wider rows take a fixed layout.
// Launches on `stream` without synchronising and returns cudaGetLastError().
extern "C" int elephas_ln_fwd(const void* x, const void* gamma, const void* beta, void* y,
                              void* mean, void* rstd, int dtype, int n_rows, int d, float eps,
                              int block_rows, void* stream) {
  if (n_rows < 1 || (mean == nullptr) != (rstd == nullptr) || block_rows < 1 ||
      block_rows > kThreads / 32 || (block_rows & (block_rows - 1)))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch_type(dtype, [&](auto tag) {
    using T = decltype(tag);
    const T* xt = static_cast<const T*>(x);
    const float* g = static_cast<const float*>(gamma);
    const float* b = static_cast<const float*>(beta);
    T* yt = static_cast<T*>(y);
    float* m = static_cast<float*>(mean);
    float* r = static_cast<float*>(rstd);
    const int route = fwd_route(x, gamma, beta, y, sizeof(T), d);
    const unsigned warp_blocks = static_cast<unsigned>((n_rows + block_rows - 1) / block_rows);
    const unsigned warp_threads = 32u * block_rows;
    if (route == 0) {
      return dispatch_chunks(d / (16 / static_cast<int>(sizeof(T))), [&](auto nc) {
        constexpr int NC = decltype(nc)::value;
        if constexpr (NC * (16 / sizeof(T)) > kWarpRowWidth / 32) {
          return cudaErrorInvalidValue;
        } else {
          ln_fwd_vec_kernel<T, NC><<<warp_blocks, warp_threads, 0, st>>>(xt, g, b, yt, m, r,
                                                                         n_rows, d, eps);
          return cudaGetLastError();
        }
      });
    }
    if (route == 1) {
      return dispatch_warp_width(d, [&](auto vpt) {
        constexpr int VPT = decltype(vpt)::value;
        ln_fwd_kernel<T, VPT, 1><<<warp_blocks, warp_threads, 0, st>>>(xt, g, b, yt, m, r,
                                                                       n_rows, d, eps);
        return cudaGetLastError();
      });
    }
    if (route != 2) return cudaErrorInvalidValue;
    return dispatch_width(d, [&](auto vpt, auto wpr) {
      constexpr int VPT = decltype(vpt)::value, WPR = decltype(wpr)::value;
      if constexpr (WPR < 4) {
        return cudaErrorInvalidValue;  // d <= kWarpRowWidth took a one-warp route
      } else {
        constexpr int kRPB = rows_per_block<VPT, WPR>();
        const unsigned blocks = static_cast<unsigned>((n_rows + kRPB - 1) / kRPB);
        ln_fwd_kernel<T, VPT, WPR><<<blocks, kThreads, 0, st>>>(xt, g, b, yt, m, r, n_rows, d,
                                                                eps);
        return cudaGetLastError();
      }
    });
  });
}

// The forward's route (see fwd_route) for these operands, or -1.
extern "C" int elephas_ln_fwd_route(const void* x, const void* gamma, const void* beta,
                                    const void* y, int dtype, int d) {
  if (dtype != 0 && dtype != 1) return -1;
  return fwd_route(x, gamma, beta, y, dtype == 0 ? 4 : 2, d);
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
