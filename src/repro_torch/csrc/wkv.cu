// The RWKV6 WKV recurrence for Hopper (sm_90a), bound with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv/kernel.py
// `_wkv_kernel` (via `wkv_pallas`). For each batch row b and head h, over
// t = 0..S-1, with S_{-1} the initial state (zero if none is given):
//   out_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
//   S_t   = diag(exp lw_t) S_{t-1} + k_t v_t^T
// r, k, v, lw are f32 (B, H, S, D) with any strides whose last is 1, u is
// (H, D), the state (B, H, D, D) f32, indexed [key row i][value column j].
// Returns out (f32, B x H x S x D, strides of its own) and the final state.
//
// This is the recurrence as the sequential oracle `wkv_ref`
// (src/repro/kernels/wkv/ref.py) states it. The TPU kernel's chunked form
// computes exp(-cum) over a chunk's summed log-decays, which overflows f32
// under strong decay (NaN at lw = -1.5 and chunks of 64); nothing here
// multiplies by a growing factor, so every lw <= 0 is safe, down to
// exp(lw) = 0.
//
// Bound on an H100, at the forward's shape (B, H, S, D) = (2, 32, 2048, 64):
// bytes: r, k, v, lw read once, out written once, the state written once,
// 168.8 MB, 50.4 us at 3.35 TB/s, which bounds it; operations: 5 D^2 a
// step of one head (D^2 fused multiply-adds for r_t . S_{t-1}, D^2
// multiplies and D^2 fused multiply-adds for exp(lw) S + k v; the bonus
// term is O(D)), 2.68 GFLOP, 40.1 us at the f32 rate of 67 TFLOP/s. A
// decode step (S = 1, B = 8) moves the state in and out, 8.7 MB: 2.6 us,
// bytes.
//
// Design. Columns j of S are independent: column j of head (b, h) is
// updated from r_t, k_t, exp(lw_t) and v_t[j] alone, and the bonus term
// splits off: out_t[j] = r_t . S_{t-1}[:, j] + v_t[j] (r_t . diag(u) k_t),
// whose second factor is one number a step, formed once while the step is
// staged. SPLIT threads of one warp share a column, each keeping D / SPLIT
// of its rows in registers, so a head takes D * SPLIT threads (512 at
// D = 64, eight times the one thread a column of the plain design) and a
// block takes COLS columns of one head. The only dependence from step to
// step is each register's own S = exp(lw) S + k v: a step's partial sums of
// r_t . S_{t-1}[:, j] go to shared memory, not through shuffles, and the
// step loop is unrolled, so the steps' chains interleave; the partial sums
// are added after each stage, in a fixed order. Rows are dealt to the SPLIT
// lanes four at a time, so a lane reads its r, k and exp(lw) as 16-byte
// vectors from shared memory, and the SPLIT lanes of a column read
// neighbouring vectors (no bank conflicts; the columns of a warp read the
// same ones, a broadcast). The block stages T steps at a time: r, k, lw (as
// exp(lw), once per element) and its columns of v, loaded with coalesced
// 16-byte reads into registers while the previous stage's steps run, so
// the loads' latency hides behind the steps. Any S >= 1 works: the last
// stage is short. The state is read once at the start and written once at
// the end by the thread that owns it, so state_in may be state_out: a
// decode step updates its state in place.
//
// Accurate expf (not __expf), as torch.exp. Built without --fmad=false: the
// fused multiply-adds change out by rounding only, about 1e-7 of max |out|,
// far below the tolerance the kernel is held to against the plain version
// (1e-5 of max |out| and of max |state|; see kernels/wkv/kernel.py).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int D, int SPLIT, int COLS, int T>
__global__ void __launch_bounds__(COLS * SPLIT)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ lw,
           const float* __restrict__ u, const float* state_in,
           float* state_out, float* __restrict__ out, int H, int S,
           int64_t in_sb, int64_t in_sh, int64_t in_ss, int64_t out_sb,
           int64_t out_sh, int64_t out_ss) {
  constexpr int NPER = D / SPLIT;  // rows a thread owns
  constexpr int NQ = NPER / 4;     // ... as 16-byte vectors
  constexpr int DV = D / 4;        // 16-byte vectors of a row
  constexpr int THREADS = COLS * SPLIT;
  static_assert(NPER % 4 == 0 && 32 % SPLIT == 0 && D % COLS == 0 &&
                    DV <= 32 && THREADS % DV == 0 && THREADS % 32 == 0,
                "shape");
  __shared__ float4 r_s[T][DV];
  __shared__ float4 k_s[T][DV];
  __shared__ float4 w_s[T][DV];
  __shared__ float v_s[T][COLS];
  __shared__ float c_s[T];                  // r_t . diag(u) k_t
  __shared__ float part_s[T][COLS][SPLIT];  // partial r_t . S_{t-1}[:, j]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int j0 = blockIdx.x * COLS;
  const int p = threadIdx.x % SPLIT;   // which rows
  const int jl = threadIdx.x / SPLIT;  // which column of the block's
  const int j = j0 + jl;
  // row of register (q, e): 4 * (q * SPLIT + p) + e

  float st[NPER];
  const int64_t sbase = (int64_t)bh * D * D;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 4 * (q * SPLIT + p) + e;
      st[4 * q + e] = state_in ? state_in[sbase + (int64_t)row * D + j] : 0.f;
    }
  }
  // the staging threads' own 16-byte vector of u (THREADS % DV == 0)
  const float4 u4 =
      reinterpret_cast<const float4*>(u + (int64_t)h * D)[threadIdx.x % DV];

  const int64_t in_base = (int64_t)b * in_sb + (int64_t)h * in_sh;
  const float* rb = r + in_base;
  const float* kb = k + in_base;
  const float* vb = v + in_base;
  const float* lb = lw + in_base;
  float* ob = out + (int64_t)b * out_sb + (int64_t)h * out_sh;

  // A stage's operands pass through registers: the loads of stage c + 1
  // are issued before stage c's steps run and stored to shared memory after
  // them, so their latency hides behind the steps.
  constexpr int LOADS = (T * DV + THREADS - 1) / THREADS;    // of r, k, lw
  constexpr int VLOADS = (T * COLS + THREADS - 1) / THREADS;  // of v
  float4 pr[LOADS], pk[LOADS], pl[LOADS];
  float pv[VLOADS];
  auto fetch = [&](int t0) {
    const int n = min(T, S - t0);
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      if (idx < n * DV) {
        const int64_t off = (int64_t)(t0 + idx / DV) * in_ss + 4 * (idx % DV);
        pr[i] = *reinterpret_cast<const float4*>(rb + off);
        pk[i] = *reinterpret_cast<const float4*>(kb + off);
        pl[i] = *reinterpret_cast<const float4*>(lb + off);
      }
    }
#pragma unroll
    for (int i = 0; i < VLOADS; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      if (idx < n * COLS)
        pv[i] = vb[(int64_t)(t0 + idx / COLS) * in_ss + j0 + idx % COLS];
    }
  };

  fetch(0);
  for (int t0 = 0; t0 < S; t0 += T) {
    const int n = min(T, S - t0);
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const bool live = idx < n * DV;  // alike for the DV lanes of a step
      float c = 0.f;
      if (live) {
        const int tt = idx / DV, q = idx % DV;
        r_s[tt][q] = pr[i];
        k_s[tt][q] = pk[i];
        w_s[tt][q] = make_float4(expf(pl[i].x), expf(pl[i].y), expf(pl[i].z),
                                 expf(pl[i].w));
        c = pr[i].x * u4.x * pk[i].x + pr[i].y * u4.y * pk[i].y +
            pr[i].z * u4.z * pk[i].z + pr[i].w * u4.w * pk[i].w;
      }
      // the bonus term r_t . diag(u) k_t, summed over the DV lanes of a step
#pragma unroll
      for (int off = DV / 2; off > 0; off >>= 1)
        c += __shfl_xor_sync(0xffffffffu, c, off);
      if (live && threadIdx.x % DV == 0) c_s[idx / DV] = c;
    }
#pragma unroll
    for (int i = 0; i < VLOADS; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      if (idx < n * COLS) v_s[idx / COLS][idx % COLS] = pv[i];
    }
    __syncthreads();
    if (t0 + T < S) fetch(t0 + T);

    // the recurrence: each step depends on the last only through st, so
    // unrolled steps interleave; partial sums go to shared memory
#pragma unroll 4
    for (int tt = 0; tt < n; ++tt) {
      const float vj = v_s[tt][jl];
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float4 r4 = r_s[tt][q * SPLIT + p];
        const float4 k4 = k_s[tt][q * SPLIT + p];
        const float4 w4 = w_s[tt][q * SPLIT + p];
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& s = st[4 * q + e];
          acc = fmaf(rr[e], s, acc);
          s = fmaf(ww[e], s, kk[e] * vj);
        }
      }
      part_s[tt][jl][p] = acc;
    }
    __syncthreads();

    // out_t[j] = r_t . S_{t-1}[:, j] + v_t[j] (r_t . diag(u) k_t)
    for (int idx = threadIdx.x; idx < n * COLS; idx += THREADS) {
      const int tt = idx / COLS, c = idx % COLS;
      float o = 0.f;
#pragma unroll
      for (int q = 0; q < SPLIT; ++q) o += part_s[tt][c][q];
      ob[(int64_t)(t0 + tt) * out_ss + j0 + c] = fmaf(v_s[tt][c], c_s[tt], o);
    }
    // the next stage writes the staging buffers only after every thread
    // has passed the barrier above, and part_s after the one below them
    __syncthreads();
  }

#pragma unroll
  for (int q = 0; q < NQ; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 4 * (q * SPLIT + p) + e;
      state_out[sbase + (int64_t)row * D + j] = st[4 * q + e];
    }
  }
}

template <int D, int SPLIT, int COLS, int T>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* lw, const float* u, const float* state_in,
                   float* state_out, float* out, int B, int H, int S,
                   const int64_t* in_strides, const int64_t* out_strides,
                   cudaStream_t stream) {
  const dim3 grid(D / COLS, B * H);
  wkv_kernel<D, SPLIT, COLS, T><<<grid, COLS * SPLIT, 0, stream>>>(
      r, k, v, lw, u, state_in, state_out, out, H, S, in_strides[0],
      in_strides[1], in_strides[2], out_strides[0], out_strides[1],
      out_strides[2]);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* wkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// r, k, v, lw: f32 (B, H, S, D) with element strides in_strides (b, h, s)
// and 1 along D, all four alike; out: f32 with strides out_strides (b, h,
// s) and 1 along D; u: (H, D) contiguous; state_in (may be null: zeros) and
// state_out: (B, H, D, D) contiguous, and may be the same buffer. Every
// pointer 16-byte aligned and in_strides multiples of 4 (the wrapper
// checks). D is 16 or 64. Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
int wkv_forward(const float* r, const float* k, const float* v,
                const float* lw, const float* u, const float* state_in,
                float* state_out, float* out, int B, int H, int S, int D,
                const int64_t* in_strides, const int64_t* out_strides,
                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || S <= 0 || (int64_t)B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 16:
      return static_cast<int>(launch<16, 4, 16, 64>(
          r, k, v, lw, u, state_in, state_out, out, B, H, S, in_strides,
          out_strides, s));
    case 64:
      return static_cast<int>(launch<64, 8, 16, 32>(
          r, k, v, lw, u, state_in, state_out, out, B, H, S, in_strides,
          out_strides, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
