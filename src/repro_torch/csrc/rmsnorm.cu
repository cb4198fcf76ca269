// RMSNorm for Hopper (sm_90a), bound with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm/kernel.py
// `_rmsnorm_kernel` (via `rms_norm_pallas`). Same function, row by row over
// the last axis of x (rows x D):
//   y = x * rsqrt(mean(x^2) + eps) * scale
// in f32 arithmetic, cast back to x's dtype (bf16 or f32); scale is an f32
// vector of D.
//
// Bound on an H100 (3.35 TB/s): x read once and y written once, plus D*4
// bytes of scale, for about 4 operations an element: bytes bound it by a
// wide margin. At the dense path's prefill (2*2048 rows x 3072, bf16) that
// is 50.3 MB, 15.0 us; a decode step (8 rows x 3072) moves 98 KB, which
// takes less than one launch's latency, so launches bound it there.
//
// What the design does about it, as the TPU kernel did with VMEM tiles:
// the row stays in registers between the sum of squares and the scaling,
// so x is read from device memory once (the unfused form reads it twice).
// One block takes one row: 256 threads, each holding up to 8 vectors of
// 16 bytes (8 bf16 or 4 f32), so every load and store is 16 bytes wide and
// neighbouring threads touch neighbouring addresses. A row of at most 32
// vectors (D = 64 in the reduced configs) takes one warp. The sum of
// squares is reduced in a fixed order: each thread over its own vectors,
// then xor shuffles inside each warp, then the warps' sums from shared
// memory, added by every thread in the same order; there are no atomics,
// so y repeats bit for bit from run to run. Built without --fmad=false.
//
// The gradient (`rmsnorm_backward_kernel`, then `rmsnorm_dscale_kernel`)
// replaces no TPU kernel: the JAX package differentiates its jnp RMSNorm,
// and the port's gradient was PyTorch ops (the plain version
// kernels/rmsnorm/ref.py `rms_norm_backward_ref`). With rstd =
// rsqrt(mean(x^2) + eps) and the cotangent g of y, in f32:
//   dx     = rstd * (g*scale - x * rstd^2 * mean(x * g*scale))  -> x's dtype
//   dscale = sum over all rows of g * x * rstd                   -> f32 (D,)
// Bound: x and g read once, dx written once, scale and dscale 8*D bytes,
// ~10 operations an element: bytes, 22.5 us at (2*2048, 3072) bf16.
// Design: one pass over each row, the row of x and of g kept in registers
// as the forward keeps x (16-byte vectors, the forward's VPT/BLOCK tiers by
// D, and one vector a thread on 128 or 256 threads up to 256 vectors); the
// next row's x and g are loaded while this one is reduced; both sums (x^2
// and x*g*scale) in one sweep, each reduced in a fixed order as the
// forward's. dscale is a sum down the columns, so the grid is
// persistent (as many blocks as fit on the card at once, each walking the
// rows blockIdx.x, + gridDim.x, ...): a thread owns fixed columns and keeps
// their partial dscale in f32 registers across its rows, and each block
// writes one row of partials (blocks x D f32, a few percent of the bytes);
// the second launch adds them over the blocks in a fixed order. No
// atomics: two runs give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "launch_plan.h"

// The arguments of the gradient's launches, packed by the wrapper with
// "=6Qiifiii" (kernels/rmsnorm/kernel.py `_pack_backward`).
struct RmsBackArgs {
  const void* x;
  const float* scale;
  const void* g;
  void* dx;
  float* partial;  // blocks x d f32 scratch
  float* dscale;
  int rows;
  int d;
  float eps;
  int dtype;   // 0 = f32, 1 = bf16
  int blocks;  // the first launch's grid, at most rmsnorm_backward_blocks
  int pad;
};
static_assert(sizeof(RmsBackArgs) == 72 && offsetof(RmsBackArgs, rows) == 48 &&
                  offsetof(RmsBackArgs, eps) == 56,
              "RmsBackArgs must match the wrapper's struct format =6Qiifiii");

namespace {

constexpr int BLOCK = 256;

template <typename T>
struct Pack;  // one 16-byte vector of T, unpacked to f32

template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 is the high half of an f32: widening is exact
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // round to nearest even, as PyTorch's .to(torch.bfloat16)
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <typename T, int VPT, int THREADS>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ y, int d, float eps) {
  constexpr int N = Pack<T>::N;
  constexpr int WARPS = THREADS / 32;
  __shared__ float warp_sums[WARPS];
  const int nvec = d / N;
  const int64_t row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  uint4* yr = reinterpret_cast<uint4*>(y + row * d);
  const float4* sr = reinterpret_cast<const float4*>(scale);

  float v[VPT][N];
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    if (idx < nvec) {
      Pack<T>::unpack(xr[idx], v[i]);
#pragma unroll
      for (int e = 0; e < N; ++e) ss += v[i][e] * v[i][e];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (WARPS > 1) {
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = ss;
    __syncthreads();
    ss = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) ss += warp_sums[w];
  }
  const float r = rsqrtf(ss / (float)d + eps);

#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    if (idx < nvec) {
      float s[N];
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 s4 = sr[idx * (N / 4) + q];
        s[4 * q] = s4.x;
        s[4 * q + 1] = s4.y;
        s[4 * q + 2] = s4.z;
        s[4 * q + 3] = s4.w;
      }
      float o[N];
#pragma unroll
      for (int e = 0; e < N; ++e) o[e] = v[i][e] * r * s[e];
      yr[idx] = Pack<T>::pack(o);
    }
  }
}

// The gradient's first launch: dx, and each block's partial dscale.
template <typename T, int VPT, int THREADS>
__global__ void __launch_bounds__(THREADS)
rmsnorm_backward_kernel(const T* __restrict__ x,
                        const float* __restrict__ scale,
                        const T* __restrict__ g, T* __restrict__ dx,
                        float* __restrict__ partial, int rows, int d,
                        float eps) {
  constexpr int N = Pack<T>::N;
  constexpr int WARPS = THREADS / 32;
  __shared__ float warp_sums[2][WARPS];
  const int nvec = d / N;
  const float4* sr = reinterpret_cast<const float4*>(scale);
  const float inv_d = 1.0f / (float)d;

  float s[VPT][N], ds[VPT][N];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int idx = threadIdx.x + i * THREADS;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      s[i][e] = 0.f;
      ds[i][e] = 0.f;
    }
    if (idx < nvec) {
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 s4 = sr[idx * (N / 4) + q];
        s[i][4 * q] = s4.x;
        s[i][4 * q + 1] = s4.y;
        s[i][4 * q + 2] = s4.z;
        s[i][4 * q + 3] = s4.w;
      }
    }
  }

  // the next row's x and g are loaded while this one is reduced
  uint4 xn[VPT], gn[VPT];
  auto fetch = [&](int64_t row) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
    const uint4* gr = reinterpret_cast<const uint4*>(g + row * d);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      if (idx < nvec) {
        xn[i] = xr[idx];
        gn[i] = gr[idx];
      }
    }
  };
  if (blockIdx.x < rows) fetch(blockIdx.x);
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    uint4* dr = reinterpret_cast<uint4*>(dx + row * d);
    float xv[VPT][N], gv[VPT][N];
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      if (idx < nvec) {
        Pack<T>::unpack(xn[i], xv[i]);
        Pack<T>::unpack(gn[i], gv[i]);
      }
    }
    if (row + gridDim.x < rows) fetch(row + gridDim.x);
    float ss = 0.f, sg = 0.f;  // sum of x^2, sum of x * g * scale
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      if (idx < nvec) {
#pragma unroll
        for (int e = 0; e < N; ++e) {
          ss += xv[i][e] * xv[i][e];
          sg += xv[i][e] * (gv[i][e] * s[i][e]);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      sg += __shfl_xor_sync(0xffffffffu, sg, off);
    }
    if (WARPS > 1) {
      if ((threadIdx.x & 31) == 0) {
        warp_sums[0][threadIdx.x >> 5] = ss;
        warp_sums[1][threadIdx.x >> 5] = sg;
      }
      __syncthreads();
      ss = 0.f;
      sg = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        ss += warp_sums[0][w];
        sg += warp_sums[1][w];
      }
      __syncthreads();  // warp_sums is written again for the next row
    }
    const float r = rsqrtf(ss * inv_d + eps);
    const float m = r * r * sg * inv_d;  // rstd * mean(xhat * g * scale)
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      if (idx < nvec) {
        float o[N];
#pragma unroll
        for (int e = 0; e < N; ++e) {
          o[e] = r * (gv[i][e] * s[i][e] - xv[i][e] * m);
          ds[i][e] = fmaf(gv[i][e], xv[i][e] * r, ds[i][e]);
        }
        dr[idx] = Pack<T>::pack(o);
      }
    }
  }
  float4* pr = reinterpret_cast<float4*>(partial + (int64_t)blockIdx.x * d);
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    if (idx < nvec) {
#pragma unroll
      for (int q = 0; q < N / 4; ++q)
        pr[idx * (N / 4) + q] = make_float4(ds[i][4 * q], ds[i][4 * q + 1],
                                            ds[i][4 * q + 2], ds[i][4 * q + 3]);
    }
  }
}

// The gradient's second launch: dscale[c] = sum over b of partial[b][c],
// b in order. A block takes 32 columns; its 8 warps take every 8th row of
// partials, and their sums are added in warp order.
constexpr int DS_COLS = 32, DS_GROUPS = 8;
__global__ void __launch_bounds__(DS_COLS* DS_GROUPS)
rmsnorm_dscale_kernel(const float* __restrict__ partial,
                      float* __restrict__ dscale, int blocks, int d) {
  __shared__ float part[DS_GROUPS][DS_COLS];
  const int col = blockIdx.x * DS_COLS + threadIdx.x % DS_COLS;
  const int grp = threadIdx.x / DS_COLS;
  float acc = 0.f;
  if (col < d)
    for (int b = grp; b < blocks; b += DS_GROUPS)
      acc += partial[(int64_t)b * d + col];
  part[grp][threadIdx.x % DS_COLS] = acc;
  __syncthreads();
  if (grp == 0 && col < d) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < DS_GROUPS; ++q) s += part[q][threadIdx.x];
    dscale[col] = s;
  }
}

// The forward's geometry for rows x d of dtype T: a block a row, of 32
// threads up to 32 16-byte vectors a row, else BLOCK; `variant` the vectors
// a thread holds (VPT), 0 where d is too wide
template <typename T>
Plan forward_plan(int rows, int d) {
  const int nvec = d / Pack<T>::N;
  Plan p{dim3(rows), dim3(BLOCK), 0, 0};
  if (nvec <= 32)
    p = Plan{dim3(rows), dim3(32), 0, 1};
  else if (nvec <= 2 * BLOCK)
    p.variant = 2;
  else if (nvec <= 4 * BLOCK)
    p.variant = 4;
  else if (nvec <= 8 * BLOCK)
    p.variant = 8;
  return p;
}

template <typename T>
const void* forward_kernel(int variant) {
  switch (variant) {
    case 1:
      return (const void*)rmsnorm_kernel<T, 1, 32>;
    case 2:
      return (const void*)rmsnorm_kernel<T, 2, BLOCK>;
    case 4:
      return (const void*)rmsnorm_kernel<T, 4, BLOCK>;
    case 8:
      return (const void*)rmsnorm_kernel<T, 8, BLOCK>;
    default:
      return nullptr;
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, void* y, int rows,
                   int d, float eps, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const Plan p = forward_plan<T>(rows, d);
  switch (p.variant) {
    case 1:
      rmsnorm_kernel<T, 1, 32><<<p.grid, p.block, p.smem, stream>>>(
          xt, scale, yt, d, eps);
      break;
    case 2:
      rmsnorm_kernel<T, 2, BLOCK><<<p.grid, p.block, p.smem, stream>>>(
          xt, scale, yt, d, eps);
      break;
    case 4:
      rmsnorm_kernel<T, 4, BLOCK><<<p.grid, p.block, p.smem, stream>>>(
          xt, scale, yt, d, eps);
      break;
    case 8:
      rmsnorm_kernel<T, 8, BLOCK><<<p.grid, p.block, p.smem, stream>>>(
          xt, scale, yt, d, eps);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The gradient's first launch for d of dtype T on `blocks` blocks: its
// tier as `variant` (1: 1 vector a thread, 32 threads; 2: 1, 128; 3: 1,
// BLOCK; 4: 2, BLOCK; 5: 4, BLOCK; 6: 8, BLOCK; 0: d too wide)
template <typename T>
Plan backward_plan(int blocks, int d) {
  const int nvec = d / Pack<T>::N;
  const int tier = nvec <= 32          ? 1
                   : nvec <= 128       ? 2
                   : nvec <= BLOCK     ? 3
                   : nvec <= 2 * BLOCK ? 4
                   : nvec <= 4 * BLOCK ? 5
                   : nvec <= 8 * BLOCK ? 6
                                       : 0;
  const int threads = tier == 1 ? 32 : tier == 2 ? 128 : BLOCK;
  return Plan{dim3(blocks), dim3(threads), 0, tier};
}

// The gradient's second launch: DS_COLS columns a block
Plan dscale_plan(int d) {
  return Plan{dim3((d + DS_COLS - 1) / DS_COLS), dim3(DS_COLS * DS_GROUPS), 0,
              0};
}

// With `blocks` set: the most blocks of this tier that are resident on the
// current device at once. Otherwise both launches of the gradient, the
// first by `p`.
template <typename T, int VPT, int THREADS>
cudaError_t backward_tier(const RmsBackArgs& a, const Plan& p,
                          cudaStream_t stream, int* blocks) {
  const auto kernel = rmsnorm_backward_kernel<T, VPT, THREADS>;
  if (blocks != nullptr) {
    int dev = 0, sms = 0, per = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel,
                                                          THREADS, 0);
    *blocks = sms * per;
    return err;
  }
  kernel<<<p.grid, p.block, p.smem, stream>>>(
      static_cast<const T*>(a.x), a.scale, static_cast<const T*>(a.g),
      static_cast<T*>(a.dx), a.partial, a.rows, a.d, a.eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const Plan q = dscale_plan(a.d);
  rmsnorm_dscale_kernel<<<q.grid, q.block, q.smem, stream>>>(
      a.partial, a.dscale, a.blocks, a.d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(const RmsBackArgs& a, cudaStream_t stream, int* blocks) {
  const Plan p = backward_plan<T>(a.blocks, a.d);
  switch (p.variant) {
    case 1:
      return backward_tier<T, 1, 32>(a, p, stream, blocks);
    case 2:
      return backward_tier<T, 1, 128>(a, p, stream, blocks);
    case 3:
      return backward_tier<T, 1, BLOCK>(a, p, stream, blocks);
    case 4:
      return backward_tier<T, 2, BLOCK>(a, p, stream, blocks);
    case 5:
      return backward_tier<T, 4, BLOCK>(a, p, stream, blocks);
    case 6:
      return backward_tier<T, 8, BLOCK>(a, p, stream, blocks);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
const void* backward_kernel(int variant) {
  switch (variant) {
    case 1:
      return (const void*)rmsnorm_backward_kernel<T, 1, 32>;
    case 2:
      return (const void*)rmsnorm_backward_kernel<T, 1, 128>;
    case 3:
      return (const void*)rmsnorm_backward_kernel<T, 1, BLOCK>;
    case 4:
      return (const void*)rmsnorm_backward_kernel<T, 2, BLOCK>;
    case 5:
      return (const void*)rmsnorm_backward_kernel<T, 4, BLOCK>;
    case 6:
      return (const void*)rmsnorm_backward_kernel<T, 8, BLOCK>;
    default:
      return nullptr;
  }
}

cudaError_t backward_any(const RmsBackArgs& a, cudaStream_t stream,
                         int* blocks) {
  if (a.d <= 0) return cudaErrorInvalidValue;
  if (a.dtype == 0) return backward<float>(a, stream, blocks);
  if (a.dtype == 1) return backward<__nv_bfloat16>(a, stream, blocks);
  return cudaErrorInvalidValue;
}

// The plan and the kernel of a launch at args = {which (0 the forward, 1
// the gradient's first kernel, 2 its dscale kernel), rows, d, dtype (0 f32,
// 1 bf16), blocks (the gradient's grid)}; false for arguments no launcher
// takes
bool plan_of(const int* args, Plan* p, const void** fn) {
  const int which = args[0], rows = args[1], d = args[2], dtype = args[3];
  if (d <= 0 || (dtype != 0 && dtype != 1)) return false;
  const bool bf16 = dtype == 1;
  if (which == 0) {
    *p = bf16 ? forward_plan<__nv_bfloat16>(rows, d)
              : forward_plan<float>(rows, d);
    *fn = bf16 ? forward_kernel<__nv_bfloat16>(p->variant)
               : forward_kernel<float>(p->variant);
  } else if (which == 1) {
    *p = bf16 ? backward_plan<__nv_bfloat16>(args[4], d)
              : backward_plan<float>(args[4], d);
    *fn = bf16 ? backward_kernel<__nv_bfloat16>(p->variant)
               : backward_kernel<float>(p->variant);
  } else if (which == 2) {
    *p = dscale_plan(d);
    *fn = (const void*)rmsnorm_dscale_kernel;
  } else {
    return false;
  }
  return *fn != nullptr;
}

}  // namespace

extern "C" {

const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The arguments of one launch in one buffer, which the wrapper packs with
// Python's struct format "=QQQiifi" (kernels/rmsnorm/kernel.py `_pack`):
// ctypes converts one pointer argument in a fraction of the time it takes
// for seven, and decode launches this kernel 49 or 57 times a step.
struct RmsArgs {
  const void* x;
  const float* scale;
  void* y;
  int rows;
  int d;
  float eps;
  int dtype;  // 0 = f32, 1 = bf16
};
static_assert(sizeof(RmsArgs) == 40 && offsetof(RmsArgs, rows) == 24 &&
                  offsetof(RmsArgs, eps) == 32,
              "RmsArgs must match the wrapper's struct format =QQQiifi");

// x and y are rows x d, contiguous, 16-byte aligned, d a multiple of 16
// bytes' worth of elements (the wrapper checks). Launches on `stream`,
// allocates nothing, returns cudaGetLastError().
int rmsnorm_forward(const RmsArgs* a, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->rows <= 0 || a->d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a->dtype == 0)
    return static_cast<int>(launch<float>(a->x, a->scale, a->y, a->rows,
                                          a->d, a->eps, s));
  if (a->dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(a->x, a->scale, a->y,
                                                  a->rows, a->d, a->eps, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The gradient's grid limit for rows of `d` elements of `dtype` (0 = f32,
// 1 = bf16): the blocks of the first launch that are resident on the
// current device at once. The wrapper launches min(rows, this) blocks and
// allocates that many rows of partials.
int rmsnorm_backward_blocks(int d, int dtype, int* blocks) {
  RmsBackArgs a{};
  a.d = d;
  a.dtype = dtype;
  return static_cast<int>(backward_any(a, nullptr, blocks));
}

// dx (x's shape and dtype) and dscale (d f32) of y = rms_norm(x, scale) for
// the cotangent g (x's shape and dtype): rows x d, contiguous, 16-byte
// aligned, d a multiple of 16 bytes' worth of elements, 1 <= blocks <=
// rows (the wrapper checks). Launches both kernels on `stream`, allocates
// nothing, returns cudaGetLastError().
int rmsnorm_backward(const RmsBackArgs* a, void* stream) {
  if (a->rows <= 0 || a->blocks <= 0 || a->blocks > a->rows)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      backward_any(*a, static_cast<cudaStream_t>(stream), nullptr));
}

// The geometry of a launch (`plan_of`'s args), as the launchers above use
// it: out as launch_plan.h `write_plan`'s.
int rmsnorm_plan(const int* args, int* out) {
  Plan p;
  const void* fn;
  if (!plan_of(args, &p, &fn)) return static_cast<int>(cudaErrorInvalidValue);
  write_plan(p, out);
  return 0;
}

// The attributes of that launch's kernel on the current device, and its
// blocks an SM at that geometry: out as `write_attributes`'.
int rmsnorm_attributes(const int* args, int* out) {
  Plan p;
  const void* fn;
  if (!plan_of(args, &p, &fn)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(write_attributes(fn, p, out));
}

}  // extern "C"
