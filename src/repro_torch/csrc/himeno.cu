// Himeno 19-point Jacobi sweep for Hopper (sm_90a), bound with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/himeno/kernel.py
// `_jacobi_kernel` (via `himeno_jacobi_pallas`). Same function: for every
// interior point
//   s0 = a0*p[i+1] + a1*p[j+1] + a2*p[k+1]
//      + b0*(p[i+1,j+1] - p[i+1,j-1] - p[i-1,j+1] + p[i-1,j-1])
//      + b1*(p[j+1,k+1] - p[j-1,k+1] - p[j+1,k-1] + p[j-1,k-1])
//      + b2*(p[i+1,k+1] - p[i-1,k+1] - p[i+1,k-1] + p[i-1,k-1])
//      + c0*p[i-1] + c1*p[j-1] + c2*p[k-1] + wrk1
//   ss = (s0*a3 - p) * bnd
// and gosa = sum(ss^2). Two epilogues share that body:
//   himeno_sweep_f32   writes p_new = p + omega*ss (boundary points pass
//                      through), the TPU kernel's own output;
//   himeno_stencil_f32 writes the interior ss, shape (I-2, J-2, K-2), for
//                      the app's separately placeable stencil units.
// Both write one gosa partial per block; the caller sums them (torch.sum),
// as the TPU wrapper sums its per-i-slab partials with jnp.sum.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s f32): each point reads 13 f32
// arrays (p, a x4, b x3, c x3, bnd, wrk1) and writes one, 56 B a point, for
// 34 FLOP a point. At the paper's L grid (512x256x256, 33.5 M points) that
// is 1.88 GB a sweep, 0.56 ms at the memory rate against 0.02 ms of
// arithmetic: memory-bound by a wide margin.
//
// What the design does about it: every array is read from device memory
// once. One thread owns one (j, k) column; k, the contiguous axis, runs
// across the 32 threads of a warp so every load is coalesced. A block takes
// a (TJ x TK) tile and marches along i through a chunk of planes, keeping a
// rolling window of three p planes (tile plus a one-point halo) in shared
// memory: the 19-point reuse of p comes from there, and the 11 coefficient
// arrays stream straight from global memory. The gosa partial of a block is
// summed in registers and reduced in shared memory in a fixed order; there
// are no float atomics, so gosa repeats bit for bit from run to run. It is
// compiled with --fmad=false (see kernel.py) so that every product and sum
// rounds as the plain version's do.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TK = 32;       // threads along k (one warp)
constexpr int TJ = 8;        // threads along j
constexpr int ICHUNK = 32;   // planes a block marches through
constexpr int HK = TK + 2;   // tile width with halo
constexpr int HJ = TJ + 2;
constexpr int NTHREADS = TK * TJ;

__device__ __forceinline__ void load_plane(float* __restrict__ dst,
                                           const float* __restrict__ p,
                                           int i, int j0, int k0, int I,
                                           int J, int K, int tid) {
  // dst[(jj)*HK + kk] = p[i, j0-1+jj, k0-1+kk], zero outside the grid.
  const bool plane_ok = (i >= 0) && (i < I);
  const int64_t base = (int64_t)i * J * K;
  for (int e = tid; e < HJ * HK; e += NTHREADS) {
    const int jj = e / HK, kk = e - jj * HK;
    const int j = j0 - 1 + jj, k = k0 - 1 + kk;
    float v = 0.0f;
    if (plane_ok && j >= 0 && j < J && k >= 0 && k < K)
      v = p[base + (int64_t)j * K + k];
    dst[e] = v;
  }
}

template <bool SWEEP>
__global__ void __launch_bounds__(NTHREADS)
himeno_kernel(const float* __restrict__ p, const float* __restrict__ a,
              const float* __restrict__ b, const float* __restrict__ c,
              const float* __restrict__ bnd, const float* __restrict__ wrk1,
              float* __restrict__ out, float* __restrict__ parts, int I,
              int J, int K, float omega) {
  __shared__ float win[3][HJ * HK];
  __shared__ float red[NTHREADS];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TK + tx;
  const int k0 = blockIdx.x * TK, j0 = blockIdx.y * TJ;
  const int i_begin = blockIdx.z * ICHUNK;
  const int i_end = min(i_begin + ICHUNK, I);
  const int j = j0 + ty, k = k0 + tx;
  const bool in_grid = (j < J) && (k < K);
  const bool jk_interior = (j >= 1) && (j <= J - 2) && (k >= 1) && (k <= K - 2);

  const int64_t N = (int64_t)I * J * K;
  const int64_t jk = (int64_t)j * K + k;
  const int c0 = (ty + 1) * HK + (tx + 1);  // this thread's cell in a plane

  float* pm = win[0];
  float* pc = win[1];
  float* pp = win[2];
  load_plane(pm, p, i_begin - 1, j0, k0, I, J, K, tid);
  load_plane(pc, p, i_begin, j0, k0, I, J, K, tid);

  float acc = 0.0f;
  for (int i = i_begin; i < i_end; ++i) {
    load_plane(pp, p, i + 1, j0, k0, I, J, K, tid);
    __syncthreads();

    const float pcc = pc[c0];
    const int64_t idx = (int64_t)i * J * K + jk;
    if (in_grid && jk_interior && i >= 1 && i <= I - 2) {
      const float s0 =
          a[idx] * pp[c0] + a[N + idx] * pc[c0 + HK] +
          a[2 * N + idx] * pc[c0 + 1] +
          b[idx] * (pp[c0 + HK] - pp[c0 - HK] - pm[c0 + HK] + pm[c0 - HK]) +
          b[N + idx] *
              (pc[c0 + HK + 1] - pc[c0 - HK + 1] - pc[c0 + HK - 1] +
               pc[c0 - HK - 1]) +
          b[2 * N + idx] * (pp[c0 + 1] - pm[c0 + 1] - pp[c0 - 1] + pm[c0 - 1]) +
          c[idx] * pm[c0] + c[N + idx] * pc[c0 - HK] +
          c[2 * N + idx] * pc[c0 - 1] + wrk1[idx];
      const float ss = (s0 * a[3 * N + idx] - pcc) * bnd[idx];
      acc += ss * ss;
      if (SWEEP) {
        out[idx] = pcc + omega * ss;
      } else {
        out[((int64_t)(i - 1) * (J - 2) + (j - 1)) * (K - 2) + (k - 1)] = ss;
      }
    } else if (SWEEP && in_grid) {
      out[idx] = pcc;  // boundary points pass through
    }
    __syncthreads();  // the next load overwrites the oldest plane
    float* t = pm;
    pm = pc;
    pc = pp;
    pp = t;
  }

  // Fixed-order tree reduction of the block's gosa partial.
  red[tid] = acc;
  __syncthreads();
  for (int s = NTHREADS / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  if (tid == 0) {
    const int blk = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                    blockIdx.x;
    parts[blk] = red[0];
  }
}

dim3 grid_for(int I, int J, int K) {
  return dim3((K + TK - 1) / TK, (J + TJ - 1) / TJ, (I + ICHUNK - 1) / ICHUNK);
}

}  // namespace

extern "C" {

const char* himeno_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Number of gosa partials (one per block) the launches below write.
int himeno_num_partials(int I, int J, int K) {
  const dim3 g = grid_for(I, J, K);
  return (int)(g.x * g.y * g.z);
}

int himeno_sweep_f32(const void* p, const void* a, const void* b,
                     const void* c, const void* bnd, const void* wrk1,
                     void* p_new, void* parts, int I, int J, int K,
                     float omega, void* stream) {
  himeno_kernel<true><<<grid_for(I, J, K), dim3(TK, TJ), 0,
                        (cudaStream_t)stream>>>(
      (const float*)p, (const float*)a, (const float*)b, (const float*)c,
      (const float*)bnd, (const float*)wrk1, (float*)p_new, (float*)parts, I,
      J, K, omega);
  return (int)cudaGetLastError();
}

int himeno_stencil_f32(const void* p, const void* a, const void* b,
                       const void* c, const void* bnd, const void* wrk1,
                       void* ss, void* parts, int I, int J, int K,
                       void* stream) {
  himeno_kernel<false><<<grid_for(I, J, K), dim3(TK, TJ), 0,
                         (cudaStream_t)stream>>>(
      (const float*)p, (const float*)a, (const float*)b, (const float*)c,
      (const float*)bnd, (const float*)wrk1, (float*)ss, (float*)parts, I, J,
      K, 0.0f);
  return (int)cudaGetLastError();
}

}  // extern "C"
