// Flash-attention forward for Hopper (sm_90a), bound with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/
// kernel.py `_flash_kernel` (via `flash_attention_pallas`). Same function:
// softmax(q k^T * scale + mask) v over q (B,H,S,D) and k, v (B,KH,S,D),
// with an online softmax over KV tiles (running max m, running sum l and
// the accumulator in f32; P stays f32 into PV, as in the Pallas kernel),
// optional causal mask and, with it, a sliding window (k > q - window).
// Masked logits are NEG_INF = -0.7 * FLT_MAX, the reference's constant, so
// a row that is masked in a tile and has no real maximum yet is wiped by
// alpha = exp(NEG_INF - m) = 0 once its first unmasked key comes. Output in
// q's dtype (bf16 or f32). Head dims 16, 64 and 128.
//
// GQA: the kernel reads K/V head h / (H/KH) for query head h, so attention()
// never materialises the repeated K/V (the reference's _repeat_kv).
//
// Bound on an H100 at the dense path's prefill (B=2, H=24, KH=8, S=2048,
// D=128, causal, bf16): QK^T and PV over the 2.1 M unmasked (q,k) pairs of
// each of the 48 heads are 51.6 GFLOP, 52 us at 989 TFLOP/s (dense bf16);
// the bytes (q, k, v read once with native GQA, o written once) are 67 MB,
// 20 us at 3.35 TB/s. Operations bound it.
//
// This first kernel does the arithmetic in scalar f32 FMA, not on the
// tensor cores, so it cannot approach that bound; wgmma/TMA are later work.
// What it does do:
// - one block per (q tile of 64 rows, batch*head); the loop over KV tiles
//   inside the block takes the place of the TPU's sequential kv grid axis;
//   heavy (late) causal q tiles are launched first;
// - KV tiles wholly above the causal frontier or wholly outside the window
//   are skipped, not masked (the Pallas docstring leaves that as a
//   follow-up; the result is the same);
// - the ragged edge (S not a multiple of 64) is masked here, so every S
//   goes through the kernel;
// - Q, then K and V in turn, are held in shared memory as f32 (one buffer
//   for K and V keeps 2 blocks on an SM at D=128); each thread computes a
//   4x4 tile of S = Q K^T from 16-byte shared loads (its 4 key columns are
//   16 apart, so a quarter-warp's loads hit 8 distinct bank groups) and a
//   4 x D/16 tile of O; the softmax statistics of a row are reduced over
//   the 16 threads that share it with xor shuffles, in a fixed order.
// Results repeat bit for bit from run to run. Built without --fmad=false:
// the f32 tolerance it is held to (2e-5) is far above FMA's rounding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows a block
constexpr int BK = 64;        // keys a KV tile
constexpr int THREADS = 256;  // 16 x 16: ty picks 4 rows, tx 4 key columns
constexpr int PSTR = BK + 4;  // row stride of the P tile (floats)
constexpr float NEG_INF = -0.7f * FLT_MAX;

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
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);  // widening bf16 is exact
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ void from_float(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);  // round to nearest even, as .to(bf16)
}

// Copy rows [0, 64) of a row-major (rows x D) tile into shared memory as
// f32 with row stride D + 4; rows at or past `valid` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src,
                                          int valid) {
  constexpr int N = Pack<T>::N;
  constexpr int CPR = D / N;  // 16-byte chunks a row
  constexpr int STR = D + 4;
  for (int e = threadIdx.x; e < 64 * CPR; e += THREADS) {
    const int r = e / CPR, c = e - r * CPR;
    float f[N];
    if (r < valid) {
      Pack<T>::unpack(*reinterpret_cast<const uint4*>(src + r * D + c * N),
                      f);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) f[i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(dst + r * STR + c * N + i) =
          make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
  }
}

template <int D>
__device__ __forceinline__ int out_col(int tx, int c) {
  // columns of O a thread owns: float4 groups 64 apart for D >= 64, so a
  // half-warp reads one contiguous 256-byte row segment of V; one column
  // for D = 16
  if constexpr (D >= 64) return (c >> 2) * 64 + tx * 4 + (c & 3);
  else return tx * (D / 16) + c;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int KH,
                 int S, float scale, int causal, int window) {
  constexpr int STR = D + 4;
  constexpr int TN = D / 16;  // O columns a thread owns
  extern __shared__ float smem[];
  float* Qs = smem;             // BQ x STR
  float* KVs = Qs + BQ * STR;   // BK x STR: K, then V, of the current tile
  float* Ps = KVs + BK * STR;   // BQ x PSTR

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heavy causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int bkh = b * KH + h / (H / KH);
  const int q0 = qt * BQ;
  const T* qb = q + ((int64_t)bh * S + q0) * D;
  const T* kb = k + (int64_t)bkh * S * D;
  const T* vb = v + (int64_t)bkh * S * D;

  load_tile<T, D>(Qs, qb, S - q0);

  float m[4], l[4], acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[i][c] = 0.0f;
  }

  const int last_row = min(q0 + BQ, S) - 1;
  int kt_lo = 0, kt_hi = (S - 1) / BK;
  if (causal) {
    kt_hi = last_row / BK;
    if (window) kt_lo = max(0, q0 - window + 1) / BK;
  }

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's PV is done with KVs and Ps
    load_tile<T, D>(KVs, kb + (int64_t)k0 * D, S - k0);
    __syncthreads();

    // S = Q K^T for rows ty*4+i and key columns tx+16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * STR + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(KVs + (tx + 16 * j) * STR + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y +
                     qv[i].z * kv[j].z + qv[i].w * kv[j].w;
    }

    // scale, mask, online softmax; P to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        bool ok = col < S;
        if (causal) {
          ok = ok && col <= row;
          if (window) ok = ok && col > row - window;
        }
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(ty * 4 + i) * PSTR + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // S is done with K; P is complete
    load_tile<T, D>(KVs, vb + (int64_t)k0 * D, S - k0);
    __syncthreads();

    // O += P V
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * PSTR + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = KVs + (j + jj) * STR;
        float vv[TN];
        if constexpr (D >= 64) {
#pragma unroll
          for (int g = 0; g < TN / 4; ++g) {
            const float4 t =
                *reinterpret_cast<const float4*>(vrow + g * 64 + tx * 4);
            vv[4 * g] = t.x;
            vv[4 * g + 1] = t.y;
            vv[4 * g + 2] = t.z;
            vv[4 * g + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < TN; ++c) vv[c] = vrow[out_col<D>(tx, c)];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = jj == 0 ? p4[i].x : jj == 1 ? p4[i].y
                        : jj == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int c = 0; c < TN; ++c) acc[i][c] += p * vv[c];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= S) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-20f);
    T* orow = o + ((int64_t)bh * S + q0 + r) * D;
#pragma unroll
    for (int c = 0; c < TN; ++c) from_float(orow + out_col<D>(tx, c),
                                            acc[i][c] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KH, int S, float scale, int causal,
                   int window, cudaStream_t stream) {
  constexpr int STR = D + 4;
  constexpr size_t SMEM = sizeof(float) * (2 * 64 * STR + BQ * PSTR);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, THREADS, SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KH, S, scale, causal,
      window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int H, int KH, int S, int D, float scale,
                     int causal, int window, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, H, KH, S, scale, causal, window,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, KH, S, scale, causal, window,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, KH, S, scale, causal, window,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, o: (B, H, S, D); k, v: (B, KH, S, D); contiguous, 16-byte aligned,
// H a multiple of KH, D in {16, 64, 128}, B*H <= 65535 (the wrapper
// checks). dtype: 0 = f32, 1 = bf16. causal and window as in the Pallas
// kernel (window applies only with causal; 0 = none). Launches on `stream`,
// allocates nothing, returns cudaGetLastError().
int flash_attention_forward(const void* q, const void* k, const void* v,
                            void* o, int B, int H, int KH, int S, int D,
                            float scale, int causal, int window, int dtype,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || KH <= 0 || S <= 0 || H % KH)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(dispatch<float>(q, k, v, o, B, H, KH, S, D, scale,
                                            causal, window, s));
  if (dtype == 1)
    return static_cast<int>(dispatch<__nv_bfloat16>(
        q, k, v, o, B, H, KH, S, D, scale, causal, window, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
