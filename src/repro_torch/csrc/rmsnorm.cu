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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

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

template <typename T>
cudaError_t launch(const void* x, const float* scale, void* y, int rows,
                   int d, float eps, cudaStream_t stream) {
  const int nvec = d / Pack<T>::N;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const dim3 grid(rows);
  if (nvec <= 32)
    rmsnorm_kernel<T, 1, 32><<<grid, 32, 0, stream>>>(xt, scale, yt, d, eps);
  else if (nvec <= 2 * BLOCK)
    rmsnorm_kernel<T, 2, BLOCK><<<grid, BLOCK, 0, stream>>>(xt, scale, yt, d,
                                                           eps);
  else if (nvec <= 4 * BLOCK)
    rmsnorm_kernel<T, 4, BLOCK><<<grid, BLOCK, 0, stream>>>(xt, scale, yt, d,
                                                           eps);
  else if (nvec <= 8 * BLOCK)
    rmsnorm_kernel<T, 8, BLOCK><<<grid, BLOCK, 0, stream>>>(xt, scale, yt, d,
                                                           eps);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
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

}  // extern "C"
