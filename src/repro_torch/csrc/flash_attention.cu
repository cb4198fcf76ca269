// Flash attention for Hopper (sm_90a), bound with ctypes: the forward as
// two kernels, a tensor-core one for bf16 and a scalar one for the rest,
// and its backward alike (parts 3 and 4 below).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/
// kernel.py `_flash_kernel` (via `flash_attention_pallas`). Same function:
// softmax(q k^T * scale + mask) v over q (B,H,S,D) and k, v (B,KH,S,D),
// with an online softmax over KV tiles (running max m, running sum l and
// the accumulator in f32), optional causal mask and, with it, a sliding
// window (k > q - window). Masked logits are NEG_INF = -0.7 * FLT_MAX, the
// reference's constant, so a row that is masked in a tile and has no real
// maximum yet is wiped by alpha = exp(NEG_INF - m) = 0 once its first
// unmasked key comes; l is floored at 1e-20. Output in q's dtype.
//
// GQA: both kernels read K/V head h / (H/KH) for query head h, so
// attention() never materialises the repeated K/V (the reference's
// _repeat_kv). Both skip KV tiles wholly above the causal frontier or wholly
// outside the window (the Pallas docstring leaves that as a follow-up; the
// result is the same), mask only the tiles that cross the frontier, the
// window's edge or the ragged end (S not a multiple of the tile), and launch
// the heavy (late) causal q tiles first.
//
// Query offset (the forward only): q may be Sq rows at q_offset in a
// sequence whose Sk keys k and v hold (a model rank's query rows under
// prefill's `seq_inner`, against the sequence's all-gathered K/V). Every
// mask counts whole-sequence positions, query row i at q_offset + i: the
// causal mask keeps keys j <= q_offset + i, the window keys j > q_offset +
// i - window, and the key-tile range, the edge tiles and the ragged end
// (Sk) move with them. A launch at offset 0 with Sq = Sk is the one-length
// launch. At an offset that is a multiple of the query tile a block does
// what the whole launch's block over the same rows does, bit for bit.
//
// Bound on an H100 at the dense path's prefill (B=2, H=24, KH=8, S=2048,
// D=128, causal, bf16): QK^T and PV over the 2.1 M unmasked (q,k) pairs of
// each of the 48 heads are 51.6 GFLOP, 52 us at 989 TFLOP/s (dense bf16);
// the bytes (q, k, v read once with native GQA, o written once) are 67 MB,
// 20 us at 3.35 TB/s. Operations bound it, so only the tensor cores can
// approach it.
//
// Which kernel takes a call (kernels/flash_attention/kernel.py
// `kernel_for`, an explicit rule, never a fallback after a failure):
// bf16 with head dim 64, 112 or 128 -> the tensor-core kernel; f32, and
// head dim 16, -> the scalar kernel. An f32 product on the tensor cores
// would be TF32 (about 1e-3 relative), which the f32 checks (2e-5) refuse.
//
// 1. The tensor-core kernel (`flash_fwd_tc`, bf16, D = 64, 112 or 128),
//    built as the hopper-kernels guide sets a fast kernel out:
// - one block takes 128 query rows of one (batch, head): two consumer
//   warpgroups of 64 rows each and a producer warpgroup, of which one
//   thread issues every TMA load (`setmaxnreg` gives the producer's
//   registers back; ptxas still compiles the consumers to 168);
// - Q is loaded once; K and V tiles of 128 keys x D stream through a ring
//   of 3 stages, with one full mbarrier each for K and V and one empty
//   mbarrier a stage (at D = 128: 32 KB of Q and 3 x 64 KB of K+V);
// - the tensor maps are 3-D (D, S, B*H), so rows past S are zero-filled and
//   never read from the next head; each box is 64 columns (128 bytes) x 128
//   rows in the 128-byte swizzle, which wgmma reads through its descriptor;
// - D = 112 (zamba2-7b's shared attention) is laid out in shared memory as
//   D = 128: the tensor maps keep the true D and its row stride of 224
//   bytes, the second box reads columns 64-127, and columns 112-127 lie
//   outside the tensor, so TMA fills them with zeros. QK^T runs the 7
//   k-steps of the true D; PV runs at N = 128 against V's zero columns
//   (the MN-major 128-byte swizzle takes N in whole 64-column atoms), and
//   the epilogue stores the 112 true columns. Shared memory and registers
//   are those of D = 128;
// - S = Q K^T by wgmma m64n128k16 f32.bf16.bf16, Q and K both K-major in
//   shared memory; P by wgmma's register A operand (m64nDk16) against V,
//   which is MN-major in shared memory (the descriptor's transpose bit);
// - in each warpgroup tile i's QK^T is issued with tile i-1's PV behind it,
//   and the softmax of tile i runs while that PV does; the two warpgroups
//   take turns to issue (named barriers), so one's softmax also overlaps
//   the other's products (FlashAttention-3's two schedules);
// - the online softmax runs on the accumulator fragment in the exp2 domain
//   (the scale * log2 e folded into one FMA before each MUFU.EX2), a row's
//   max taken over the 4 lanes that share it by xor shuffles, its sum kept
//   per lane and reduced once at the end, both in a fixed order; O is
//   rescaled by alpha in registers;
// - epilogue: O / l rounded to bf16, staged swizzled in the warpgroup's own
//   rows of the Q buffer, stored in 16-byte rows (rows past S dropped);
// - the grid is (B*H, q tiles), heavy tiles first, so the query heads that
//   share a K/V head run side by side and share it in L2.
//   ptxas serialises every wgmma of the kernel (warning C7513) if an
//   instruction other than a wgmma writes a register of one in flight: the
//   descriptors' warpgroup index is broadcast so they stay in uniform
//   registers, the first QK^T step overwrites S (an output only), P is
//   rounded into the PV operand only after the previous PV retires, and
//   the live registers stay within the 168 ptxas allocates.
//   Numerics: P is rounded to bf16 before PV, as the port's plain version
//   (attention_ref casts the normalised probabilities to v's dtype); the
//   Pallas kernel keeps P in f32 into PV. Here P is rounded unnormalised
//   (exp2(s - m), m the running max) and l is summed from the unrounded p;
//   ex2.approx.ftz flushes p below 2^-126 to 0. No atomics: results repeat
//   bit for bit.
//   Times at the main shape on an NVIDIA H100 80GB HBM3 at 700.00 W are in
//   PERF.md (chip_smoke.py).
//
// 2. The scalar kernel (`flash_fwd_kernel`, f32 at D = 16, 64, 112, 128
//    and bf16 at D = 16) does the arithmetic in scalar f32 FMA (P stays f32
//    into PV, as in the Pallas kernel):
// - one block per (q tile of 64 rows, batch*head); the loop over KV tiles
//   inside the block takes the place of the TPU's sequential kv grid axis;
// - Q, then K and V in turn, are held in shared memory as f32 (one buffer
//   for K and V keeps 2 blocks on an SM at D=128); each thread computes a
//   4x4 tile of S = Q K^T from 16-byte shared loads (its 4 key columns are
//   16 apart, so a quarter-warp's loads hit 8 distinct bank groups) and a
//   4 x D/16 tile of O (at D = 112, 7 neighbouring columns: an odd stride,
//   so a half-warp's scalar loads of V hit 16 distinct banks); the softmax
//   statistics of a row are reduced over the 16 threads that share it with
//   xor shuffles, in a fixed order.
// Results repeat bit for bit from run to run. Built without --fmad=false:
// the f32 tolerance it is held to (2e-5) is far above FMA's rounding.
//
// Both forward kernels take an optional lse pointer (null on every serving
// call, which then writes nothing more; the tensor-core kernel is then its
// instance without the write): (B, H, S) f32, each row's log-sum-exp in
// the log2 domain, m log2 e + log2 l (the tensor-core kernel: m scale
// log2 e + log2 l over raw logits), written in the epilogue only, after
// the last PV retired.
//
// The backward: the gradient of o = softmax(q k^T scale + mask) v, what
// jax.grad of src/repro/kernels/flash_attention/ref.py computes (the JAX
// package has no backward kernel; its training differentiates the einsum
// attention). The Pallas kernel it belongs to is the same `_flash_kernel`.
// From the forward's o and lse and the cotangent do:
//   P = exp2(s scale log2 e - lse), recomputed, no online softmax;
//   D_i = sum_d do_id o_id in f32 (a pre-pass, one warp a row);
//   dV = P^T dO, P rounded to v's dtype first; dP = dO V^T in f32;
//   dS = P (dP - D) scale, rounded to q's dtype; dQ = dS K, dK = dS^T Q;
// dK and dV summed in f32 over the query tiles and the H/KH query heads of
// their K/V head and rounded once, as jax.grad rounds them. Two kernels,
// so every sum has one owner and no atomics: one over key tiles for dK
// and dV, one over query tiles for dQ, which recomputes S and dP (three
// products more than the function needs). Results repeat bit for bit.
// Bound at llama3.2-3b's training shape (B=2, H=24, KH=8, S=2048, D=128,
// causal, bf16): the gradient's four products over the 2.1 M unmasked
// pairs of each of 48 heads, 103 GFLOP, 104 us at 989 TFLOP/s (twice the
// forward's); the kernels' own seven products are 1.75 times that.
//
// 3. The tensor-core backward (`flash_bwd_dkdv_tc`, `flash_bwd_dq_tc`; bf16,
//    D = 64, 112, 128): two consumer warpgroups a block and no producer
//    warpgroup (a dK/dV warpgroup keeps 2 x 64 f32 accumulators and two
//    64 x 64 products in registers, 234 of them at D = 128, which a
//    producer's 168 cap would not hold); thread 0 issues every TMA load
//    and refills a stage of the 3-stage ring once all 256 threads have
//    arrived on its empty mbarrier.
// - dK/dV: a block owns 128 keys of one (batch, K/V head), 64 a
//   warpgroup; K and V are loaded once; Q, dO (64 queries each) and their
//   (lse, D) stream through the ring for every query head of the group
//   and every query tile that sees the keys (causal: from the key tile on;
//   window: up to k0 + 127 + window - 1). Keys are the M rows of every
//   product: S^T = K Q^T and dP^T = V dO^T (m64n64k16, all K-major), so
//   P^T and dS^T come out in the accumulator layout, which is wgmma's
//   register A fragment: dV += P^T dO and dK += dS^T Q (m64nDPk16, dO and
//   Q MN-major through the descriptor's transpose bit). The grid is
//   (B*KH, key tiles), early (heavy) causal key tiles first.
// - dQ: a block owns 128 queries of one (batch, head), 64 a warpgroup; Q,
//   dO and their (lse, D) loaded once; K/V tiles of 64 keys stream; S = Q
//   K^T, dP = dO V^T, dS into dQ += dS K (K MN-major). The grid is (B*H,
//   query tiles), heavy causal tiles first.
// - tiles wholly above the causal frontier or outside the window are not
//   loaded, a warpgroup's whole-hidden 64 rows skip their products, and
//   only tiles that cross the frontier, the window's edge or the ragged end
//   are masked. D = 112 is laid out as 128 columns (TMA's zero fill), as in
//   the forward; the epilogues stage each warpgroup's bf16 rows swizzled
//   over its own rows of K and V (or Q) and store the D true columns.
//   Within a tile the element-wise work overlaps the products: P (or P^T)
//   is formed while dP's product runs, dS^T while dV's does; no other
//   instruction writes a register of a wgmma in flight, so ptxas
//   serialises none (no C7513). The pre-pass reads o and do in 16-byte
//   loads.
//
// 4. The scalar backward (`flash_bwd_dkdv_kernel`, `flash_bwd_dq_kernel`;
//    f32 at D = 16, 64, 112, 128 and bf16 at D = 16): the same two passes
//    in scalar f32 FMA, the forward scalar kernel's layout (64-row tiles
//    in shared memory as f32, 16 x 16 threads each on a 4 x 4 tile of S,
//    then its PV loop for dV, dK and dQ), rounding P and dS to T as above.
#include <cuda.h>  // CUtensorMap and its enums; libcuda is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "launch_plan.h"

namespace {

constexpr int BQ = 64;        // query rows a block
constexpr int BK = 64;        // keys a KV tile
constexpr int THREADS = 256;  // 16 x 16: ty picks 4 rows, tx 4 key columns
constexpr int PSTR = BK + 4;  // row stride of the P tile (floats)
constexpr float NEG_INF = -0.7f * FLT_MAX;
constexpr float LOG2E_F = 1.4426950408889634f;

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
  // columns of O a thread owns: float4 groups 64 apart where D is a
  // multiple of 64, so a half-warp reads one contiguous 256-byte row
  // segment of V; D / 16 neighbouring columns otherwise (D = 16 and 112)
  if constexpr (D % 64 == 0) return (c >> 2) * 64 + tx * 4 + (c & 3);
  else return tx * (D / 16) + c;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int KH, int Sq, int Sk,
                 int q_offset, float scale, int causal, int window) {
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
  const T* qb = q + ((int64_t)bh * Sq + q0) * D;
  const T* kb = k + (int64_t)bkh * Sk * D;
  const T* vb = v + (int64_t)bkh * Sk * D;

  load_tile<T, D>(Qs, qb, Sq - q0);

  float m[4], l[4], acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[i][c] = 0.0f;
  }

  // rows and keys by their place in the whole sequence: query row i is
  // row q_offset + i there
  const int g0 = q_offset + q0;
  const int last_row = q_offset + min(q0 + BQ, Sq) - 1;
  int kt_lo = 0, kt_hi = (Sk - 1) / BK;
  if (causal) {
    kt_hi = last_row / BK;
    if (window) kt_lo = max(0, g0 - window + 1) / BK;
  }

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's PV is done with KVs and Ps
    load_tile<T, D>(KVs, kb + (int64_t)k0 * D, Sk - k0);
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
      const int row = g0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        bool ok = col < Sk;
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
    load_tile<T, D>(KVs, vb + (int64_t)k0 * D, Sk - k0);
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
        if constexpr (D % 64 == 0) {
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
    if (q0 + r >= Sq) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-20f);
    // m is the row's largest scaled logit: log2 of sum exp = m log2 e +
    // log2 l, in the log2 domain the backward recomputes P in
    if (lse != nullptr && tx == 0)
      lse[(int64_t)bh * Sq + q0 + r] = m[i] * LOG2E_F + log2f(fmaxf(l[i],
                                                                   1e-20f));
    T* orow = o + ((int64_t)bh * Sq + q0 + r) * D;
#pragma unroll
    for (int c = 0; c < TN; ++c) from_float(orow + out_col<D>(tx, c),
                                            acc[i][c] * inv);
  }
}

// The scalar forward's geometry: a block a 64-row query tile of a head
template <typename T, int D>
Plan forward_plan(int B, int H, int Sq) {
  constexpr int STR = D + 4;
  return Plan{dim3((Sq + BQ - 1) / BQ, B * H), dim3(THREADS),
              (unsigned)(sizeof(float) * (2 * 64 * STR + BQ * PSTR)), 0};
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int KH, int Sq, int Sk,
                   int q_offset, float scale, int causal, int window,
                   cudaStream_t stream) {
  const Plan p = forward_plan<T, D>(B, H, Sq);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)p.smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  flash_fwd_kernel<T, D><<<p.grid, p.block, p.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, KH, Sq, Sk,
      q_offset, scale, causal, window);
  return cudaGetLastError();
}

// f32 at D = 16, 64, 112 and 128; bf16 at D = 16 only (bf16 at 64, 112 and
// 128 is the tensor-core kernel's)
template <template <typename, int> class F, typename... A>
cudaError_t by_type_and_dim(int dtype, int D, A... args) {
  if (dtype == 1)
    return D == 16 ? F<__nv_bfloat16, 16>::run(args...)
                   : cudaErrorInvalidValue;
  if (dtype != 0) return cudaErrorInvalidValue;
  switch (D) {
    case 16:
      return F<float, 16>::run(args...);
    case 64:
      return F<float, 64>::run(args...);
    case 112:
      return F<float, 112>::run(args...);
    case 128:
      return F<float, 128>::run(args...);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, int D>
struct Forward {
  template <typename... A>
  static cudaError_t run(A... args) { return launch<T, D>(args...); }
};

// ---------------------------------------------------------------------------
// The backward (see the header note, parts 3 and 4): a pre-pass, then the
// scalar kernels; the tensor-core ones are in namespace tc.
// ---------------------------------------------------------------------------

// x rounded to T's precision, back in f32: where jax.grad rounds (P to v's
// dtype before dV, the scaled dS to q's before dQ and dK)
template <typename T>
__device__ __forceinline__ float rounded(float x) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16_rn(x));
  else return x;
}

// The pre-pass: stats[(bh SP + i) 2 + {0, 1}] = (lse_i, D_i), the forward's
// log-sum-exp (log2 domain) and D_i = sum_d do_id o_id in f32, one warp a
// row in 16-byte loads, summed in a fixed order; rows i in [S, SP) get
// (0, 0). SP is S
// padded to 128 rows, so a tile's stats are whole and 16-byte aligned.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_prep(const T* __restrict__ o, const T* __restrict__ dout,
               const float* __restrict__ lse, float* __restrict__ stats,
               int BH, int S, int SP) {
  const int64_t row = ((int64_t)blockIdx.x * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (int64_t)BH * SP) return;  // whole warps
  const int bh = static_cast<int>(row / SP), i = static_cast<int>(row % SP);
  constexpr int N = Pack<T>::N;  // elements a 16-byte load
  float acc = 0.0f, l2 = 0.0f;
  if (i < S) {
    const int64_t at = ((int64_t)bh * S + i) * D;
    for (int c = lane; c < D / N; c += 32) {
      float a[N], b[N];
      Pack<T>::unpack(*reinterpret_cast<const uint4*>(dout + at + c * N), a);
      Pack<T>::unpack(*reinterpret_cast<const uint4*>(o + at + c * N), b);
#pragma unroll
      for (int e = 0; e < N; ++e) acc = fmaf(a[e], b[e], acc);
    }
    l2 = lse[(int64_t)bh * S + i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0)
    *reinterpret_cast<float2*>(stats + 2 * row) = make_float2(l2, acc);
}

__device__ __forceinline__ bool visible(int row, int col, int S, int causal,
                                        int window) {
  bool ok = row < S && col < S;
  if (causal) {
    ok = ok && col <= row;
    if (window) ok = ok && col > row - window;
  }
  return ok;
}

// dS = P (dP - D) for one (query row, key) pair, P recomputed from the
// logit s and the row's log-sum-exp; both rounded to T as jax.grad rounds
// them, dS with the scale folded in
template <typename T>
__device__ __forceinline__ void p_and_ds(float s, float dp, float l2,
                                         float dd, bool ok, float scale,
                                         float* p_out, float* ds_out) {
  const float p = ok ? exp2f(fmaf(s, scale * LOG2E_F, -l2)) : 0.0f;
  *p_out = rounded<T>(p);
  *ds_out = rounded<T>(p * (dp - dd) * scale);
}

// rows ty*4+i of A (row stride STR) against rows tx+16j of B: the 4 x 4
// dot products over D, from 16-byte shared loads
template <int D>
__device__ __forceinline__ void dots(float (&out)[4][4],
                                     const float* __restrict__ A,
                                     const float* __restrict__ B, int ty,
                                     int tx) {
  constexpr int STR = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty * 4 + i) * STR + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * STR + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[i][j] += a[i].x * b[j].x + a[i].y * b[j].y + a[i].z * b[j].z +
                     a[i].w * b[j].w;
  }
}

// acc[i][c] += sum_j W[ty*4+i][j] X[j][out_col(tx, c)] over the 64 rows j
// of X (row stride STR), W with row stride PSTR: the forward's PV loop
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[4][D / 16],
                                           const float* __restrict__ W,
                                           const float* __restrict__ X,
                                           int ty, int tx) {
  constexpr int STR = D + 4;
  constexpr int TN = D / 16;
#pragma unroll 2
  for (int j = 0; j < 64; j += 4) {
    float4 w4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w4[i] = *reinterpret_cast<const float4*>(W + (ty * 4 + i) * PSTR + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float* xrow = X + (j + jj) * STR;
      float xv[TN];
#pragma unroll
      for (int c = 0; c < TN; ++c) xv[c] = xrow[out_col<D>(tx, c)];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = jj == 0 ? w4[i].x : jj == 1 ? w4[i].y
                      : jj == 2 ? w4[i].z : w4[i].w;
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[i][c] += w * xv[c];
      }
    }
  }
}

template <typename T, int D>
__device__ __forceinline__ void store_rows(T* __restrict__ out,
                                           const float (&acc)[4][D / 16],
                                           int r0, int S, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= S) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      from_float(out + (int64_t)r * D + out_col<D>(tx, c), acc[i][c]);
  }
}

// dK and dV of 64 keys of one K/V head: one block a (key tile, batch * K/V
// head), a loop over the H/KH query heads it serves and the query tiles
// that see its keys; dK and dV summed in f32 registers and rounded once
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ stats, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int KH, int S, int SP,
                      float scale, int causal, int window) {
  constexpr int STR = D + 4;
  constexpr int TN = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;               // BK x STR
  float* Vs = Ks + BK * STR;
  float* Qs = Vs + BK * STR;      // BQ x STR
  float* dOs = Qs + BQ * STR;
  float* Ps = dOs + BQ * STR;     // BK x PSTR: P^T, keys x queries
  float* dSs = Ps + BK * PSTR;    // BK x PSTR: (dS scale)^T
  float* St = dSs + BK * PSTR;    // BQ x 2: the queries' (lse, D)

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * BK;
  const int bkh = blockIdx.y;
  const int b = bkh / KH, kh = bkh - b * KH, G = H / KH;
  load_tile<T, D>(Ks, k + ((int64_t)bkh * S + k0) * D, S - k0);
  load_tile<T, D>(Vs, v + ((int64_t)bkh * S + k0) * D, S - k0);

  float dk_acc[4][TN], dv_acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < TN; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.0f;

  // the query tiles that see a key of this tile
  int qt_lo = 0, qt_hi = (S - 1) / BQ;
  if (causal) {
    qt_lo = k0 / BQ;
    if (window) qt_hi = min(S - 1, k0 + BK - 1 + window - 1) / BQ;
  }
  for (int g = 0; g < G; ++g) {
    const int bh = b * H + kh * G + g;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's products are done
      load_tile<T, D>(Qs, q + ((int64_t)bh * S + q0) * D, S - q0);
      load_tile<T, D>(dOs, dout + ((int64_t)bh * S + q0) * D, S - q0);
      if (tid < 2 * BQ) St[tid] = stats[((int64_t)bh * SP + q0) * 2 + tid];
      __syncthreads();
      // S^T and dP^T: keys ty*4+i against queries tx+16j
      float s[4][4], dp[4][4];
      dots<D>(s, Ks, Qs, ty, tx);
      dots<D>(dp, Vs, dOs, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qi = tx + 16 * j;
          p_and_ds<T>(s[i][j], dp[i][j], St[2 * qi], St[2 * qi + 1],
                      visible(q0 + qi, k0 + ty * 4 + i, S, causal, window),
                      scale, Ps + (ty * 4 + i) * PSTR + qi,
                      dSs + (ty * 4 + i) * PSTR + qi);
        }
      __syncthreads();
      accumulate<D>(dv_acc, Ps, dOs, ty, tx);   // dV += P^T dO
      accumulate<D>(dk_acc, dSs, Qs, ty, tx);   // dK += dS^T Q
    }
  }
  store_rows<T, D>(dk + (int64_t)bkh * S * D, dk_acc, k0, S, ty, tx);
  store_rows<T, D>(dv + (int64_t)bkh * S * D, dv_acc, k0, S, ty, tx);
}

// dQ of 64 query rows of one head: one block a (query tile, batch * head),
// heavy causal tiles first, a loop over the key tiles the rows see
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ stats, T* __restrict__ dq,
                    int H, int KH, int S, int SP, float scale, int causal,
                    int window) {
  constexpr int STR = D + 4;
  constexpr int TN = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;               // BQ x STR
  float* dOs = Qs + BQ * STR;
  float* Ks = dOs + BQ * STR;     // BK x STR
  float* Vs = Ks + BK * STR;
  float* dSs = Vs + BK * STR;     // BQ x PSTR: dS scale
  float* St = dSs + BQ * PSTR;    // BQ x 2

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heavy tiles first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int bkh = b * KH + h / (H / KH);
  load_tile<T, D>(Qs, q + ((int64_t)bh * S + q0) * D, S - q0);
  load_tile<T, D>(dOs, dout + ((int64_t)bh * S + q0) * D, S - q0);
  if (tid < 2 * BQ) St[tid] = stats[((int64_t)bh * SP + q0) * 2 + tid];

  float acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[i][c] = 0.0f;

  const int last_row = min(q0 + BQ, S) - 1;
  int kt_lo = 0, kt_hi = (S - 1) / BK;
  if (causal) {
    kt_hi = last_row / BK;
    if (window) kt_lo = max(0, q0 - window + 1) / BK;
  }
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's dQ product is done
    load_tile<T, D>(Ks, k + ((int64_t)bkh * S + k0) * D, S - k0);
    load_tile<T, D>(Vs, v + ((int64_t)bkh * S + k0) * D, S - k0);
    __syncthreads();
    // S and dP: queries ty*4+i against keys tx+16j
    float s[4][4], dp[4][4];
    dots<D>(s, Qs, Ks, ty, tx);
    dots<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p;
        p_and_ds<T>(s[i][j], dp[i][j], St[2 * qi], St[2 * qi + 1],
                    visible(q0 + qi, k0 + tx + 16 * j, S, causal, window),
                    scale, &p, dSs + qi * PSTR + tx + 16 * j);
      }
    }
    __syncthreads();
    accumulate<D>(acc, dSs, Ks, ty, tx);  // dQ += dS K
  }
  store_rows<T, D>(dq + (int64_t)bh * S * D, acc, q0, S, ty, tx);
}

// The backward's pre-pass (either backward's): a warp a row of the B*H*SP
// rows of stats
Plan prep_plan(int B, int H, int SP) {
  const int64_t rows = (int64_t)B * H * SP;
  return Plan{dim3((unsigned)((rows * 32 + THREADS - 1) / THREADS)),
              dim3(THREADS), 0, 0};
}

// The scalar backward's dK/dV kernel: a block a 64-key tile of a K/V head
template <typename T, int D>
Plan dkdv_plan(int B, int KH, int S) {
  constexpr int STR = D + 4;
  return Plan{dim3((S + 63) / 64, B * KH), dim3(THREADS),
              (unsigned)(sizeof(float) *
                         (4 * 64 * STR + 2 * 64 * PSTR + 2 * BQ)),
              0};
}

// ... and its dQ kernel: a block a 64-row query tile of a head
template <typename T, int D>
Plan dq_plan(int B, int H, int S) {
  constexpr int STR = D + 4;
  return Plan{dim3((S + 63) / 64, B * H), dim3(THREADS),
              (unsigned)(sizeof(float) * (4 * 64 * STR + BQ * PSTR + 2 * BQ)),
              0};
}

template <typename T, int D>
cudaError_t launch_backward(const void* q, const void* k, const void* v,
                            const void* o, const float* lse, const void* dout,
                            void* dq, void* dk, void* dv, float* stats,
                            int B, int H, int KH, int S, int SP, float scale,
                            int causal, int window, cudaStream_t stream) {
  const Plan pp = prep_plan(B, H, SP), pk = dkdv_plan<T, D>(B, KH, S),
             pq = dq_plan<T, D>(B, H, S);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pk.smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)pq.smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  flash_bwd_prep<T, D><<<pp.grid, pp.block, pp.smem, stream>>>(
      static_cast<const T*>(o), tdo, lse, stats, B * H, S, SP);
  flash_bwd_dkdv_kernel<T, D><<<pk.grid, pk.block, pk.smem, stream>>>(
      tq, tk, tv, tdo, stats, static_cast<T*>(dk), static_cast<T*>(dv), H,
      KH, S, SP, scale, causal, window);
  flash_bwd_dq_kernel<T, D><<<pq.grid, pq.block, pq.smem, stream>>>(
      tq, tk, tv, tdo, stats, static_cast<T*>(dq), H, KH, S, SP, scale,
      causal, window);
  return cudaGetLastError();
}

template <typename T, int D>
struct Backward {
  template <typename... A>
  static cudaError_t run(A... args) { return launch_backward<T, D>(args...); }
};

// ---------------------------------------------------------------------------
// 1. The tensor-core kernel (bf16, D = 64, 112 or 128)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BQ = 128;             // query rows a block
constexpr int BK = 128;             // keys a KV tile
constexpr int CONSUMERS = 2;        // warpgroups of 64 query rows
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int STAGES = 3;           // K/V ring
constexpr int BOX = 128 * 128;      // bytes of one TMA box: 128 rows x 64 bf16
constexpr float LOG2E = 1.4426950408889634f;

// the width of a tile in shared memory: D rounded up to whole 64-column
// boxes (112 -> 128; the columns past D are TMA's zero fill)
__host__ __device__ constexpr int padded(int d) { return (d + 63) / 64 * 64; }

template <int DP>
struct Smem {
  static constexpr int TILE = (DP / 64) * BOX;  // 128 rows of Q, K or V
  static constexpr int KV = TILE;              // stage s: K at KV + 2s TILE,
  static constexpr int BYTES = TILE * (1 + 2 * STAGES);  // V one TILE on
  static constexpr int ALLOC = BYTES + 1024;   // slack to align to 1024
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box (64 columns x 128 rows of one head) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_one() {  // all but the newest
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of a wgmma's registers
// (its accumulator, or its A operand, which it reads asynchronously)
// across the wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ACC16(i) ACC4(i), ACC4(i + 4), ACC4(i + 8), ACC4(i + 12)
#define ACC_REGS32                                         \
  "%0, %1, %2, %3, %4, %5, %6, %7, "                       \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                 \
  "%16, %17, %18, %19, %20, %21, %22, %23, "               \
  "%24, %25, %26, %27, %28, %29, %30, %31"
#define ACC_REGS64                                         \
  ACC_REGS32 ", "                                          \
  "%32, %33, %34, %35, %36, %37, %38, %39, "               \
  "%40, %41, %42, %43, %44, %45, %46, %47, "               \
  "%48, %49, %50, %51, %52, %53, %54, %55, "               \
  "%56, %57, %58, %59, %60, %61, %62, %63"

// d (64 x 128, f32) += A (64 x 16) B^T (128 x 16), both K-major in shared
// memory
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" ACC_REGS64 "}, %64, %65, 1, 1, 1, 0, 0;\n"
      : ACC16(0), ACC16(16), ACC16(32), ACC16(48)
      : "l"(a), "l"(b));
}

// the same with d overwritten (scale-d false): d is an output only, so
// whatever wrote its registers before (the softmax) is no wgmma input, and
// ptxas need not serialise the wgmmas in flight around it
#define OUT4(i) "=f"(d[i]), "=f"(d[i + 1]), "=f"(d[i + 2]), "=f"(d[i + 3])
#define OUT16(i) OUT4(i), OUT4(i + 4), OUT4(i + 8), OUT4(i + 12)
__device__ __forceinline__ void wgmma_qk_first(float (&d)[64], uint64_t a,
                                               uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" ACC_REGS64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : OUT16(0), OUT16(16), OUT16(32), OUT16(48)
      : "l"(a), "l"(b), "r"(0));
}
// d (64 x 64, f32) += A (64 x 16) B^T (64 x 16), both K-major in shared
// memory; the backward's S, dP and their transposes
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" ACC_REGS32 "}, %32, %33, 1, 1, 1, 0, 0;\n"
      : ACC16(0), ACC16(16)
      : "l"(a), "l"(b));
}
__device__ __forceinline__ void wgmma_ss64_first(float (&d)[32], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" ACC_REGS32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : OUT16(0), OUT16(16)
      : "l"(a), "l"(b), "r"(0));
}
#undef OUT4
#undef OUT16

// d (64 x N, f32) += A (64 x 16 bf16, registers) B (16 x N), B MN-major in
// shared memory
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" ACC_REGS64 "}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : ACC16(0), ACC16(16), ACC16(32), ACC16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" ACC_REGS32 "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : ACC16(0), ACC16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

#undef ACC4
#undef ACC16
#undef ACC_REGS32
#undef ACC_REGS64

// 2^x in one MUFU.EX2 (exp2f adds a range fix for results below 2^-126,
// which only moves o by less than 1e-38 of |v|)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // round to nearest
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Named barriers: 1 and 2 close a consumer warpgroup's epilogue; TURN + w
// is consumer warpgroup w's turn to issue its products (the other one
// arrives, 128 + 128 threads).
constexpr int TURN = 3;

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// issue S = Q K^T for one tile: D/16 steps of 16 columns, 4 in each
// 128-byte box; committed as one group
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t qa,
                                         uint32_t kd) {
  wgmma_fence();
  wgmma_qk_first(sc, sw128_desc(qa, 16, 1024), sw128_desc(kd, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
    wgmma_qk(sc, sw128_desc(qa + off, 16, 1024),
             sw128_desc(kd + off, 16, 1024));
  }
  wgmma_commit();
}

// issue O += P V for one tile: 8 steps of 16 keys; V is MN-major, 8 keys of
// 128 bytes apart by 1024 bytes, its boxes of 64 columns apart by BOX;
// committed as one group
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         uint32_t (&p)[32], uint32_t vd) {
  fence_regs(acc);
  fence_regs(p);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                           p[4 * kk + 3]};
    wgmma_pv<D>(acc, a, sw128_desc(vd + kk * 16 * 128, BOX, 1024));
  }
  wgmma_commit();
}

// The thread's two rows of the online softmax over one tile of S (raw
// logits), in place: scale into the exp2 domain, mask if the tile is on an
// edge, take the rows' max over the 4 lanes that share them, S becomes
// P = exp2(s - m) in f32, l = alpha l + rowsum(P) (over the lane's own
// columns; the lanes' sums are added once, at the end), alpha for O left in
// al. P is rounded to bf16 into the PV operand only once the previous PV is
// done: ptxas serialises every wgmma if an instruction other than a wgmma
// writes a register of one in flight, and it also does so when the live
// registers outgrow its budget (168 a thread, whatever setmaxnreg gives) and
// it reuses those of the operand in flight.
struct Rows {
  int row0;  // the first row in the whole sequence; the second is 8 below
  int cq;    // the lane's first column in each 8-column chunk
  float m[2], l[2], al[2];
};

// k0 and q0 (the block's first query row) count in the whole sequence, of
// Sk keys.
__device__ __forceinline__ void online_softmax(float (&sc)[64],
                                               Rows& r,
                                               int k0, int q0, int Sk,
                                               int causal, int window,
                                               float scale_log2) {
  const bool edge = k0 + BK > Sk ||
                    (causal && (k0 + BK - 1 > q0 ||
                                (window && k0 <= q0 + BQ - 1 - window)));
  if (edge) {
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * n + r.cq + (e & 1);
        const int row = r.row0 + 8 * (e >> 1);
        bool ok = col < Sk;
        if (causal) {
          ok = ok && col <= row;
          if (window) ok = ok && col > row - window;
        }
        if (!ok) sc[4 * n + e] = NEG_INF;
      }
  }
  float mx[2] = {NEG_INF, NEG_INF}, off_[2];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      mx[hf] = fmaxf(mx[hf], fmaxf(sc[4 * n + 2 * hf], sc[4 * n + 2 * hf + 1]));
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1)
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], off));
    const float mn = fmaxf(r.m[hf], mx[hf]);  // raw logits
    r.al[hf] = exp2_ftz((r.m[hf] - mn) * scale_log2);
    r.m[hf] = mn;
    // exp2(s scale - m scale) in one FMA; a row with no unmasked key yet
    // takes offset 0, so its masked logits give exp2(NEG_INF scale) = 0
    off_[hf] = mn == NEG_INF ? 0.0f : -mn * scale_log2;
  }
  float rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * n + e] = exp2_ftz(fmaf(sc[4 * n + e], scale_log2, off_[e >> 1]));
      rs[e >> 1] += sc[4 * n + e];
    }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) r.l[hf] = r.l[hf] * r.al[hf] + rs[hf];
}

// Accumulator fragment of wgmma m64nN (f32), for thread t of a warpgroup:
// rows 16*(t/32) + (t%32)/4 and 8 more; in 8-column chunk n, d[4n], d[4n+1]
// are the first row at columns 8n + 2*(t%4) + {0, 1}, d[4n+2], d[4n+3] the
// second. Chunks 2j and 2j+1 of S are, as they stand, the register A
// fragment of P for keys 16j..16j+15.
template <int D, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H,
             int KH, int Sq, int Sk, int q_offset, float scale_log2,
             int causal, int window) {
  constexpr int DP = padded(D);  // columns a tile holds in shared memory
  using L = Smem<DP>;
  constexpr int NB = DP / 64;   // boxes across DP
  extern __shared__ uint8_t smem_raw[];
  // q, then full K, full V and empty, one a stage
  __shared__ __align__(8) uint64_t bars[1 + 3 * STAGES];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_addr(smem);
  const uint32_t q_bar = smem_addr(bars);
  auto full_k = [&](int s) { return q_bar + 8 * (1 + s); };
  auto full_v = [&](int s) { return q_bar + 8 * (1 + STAGES + s); };
  auto empty = [&](int s) { return q_bar + 8 * (1 + 2 * STAGES + s); };

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heavy causal tiles first
  const int q0 = qt * BQ;  // of q's Sq rows
  const int g0 = q_offset + q0;  // the same row in the whole sequence
  const int b = bh / H, h = bh - b * H;
  const int bkh = b * KH + h / (H / KH);
  const int last_row = q_offset + min(q0 + BQ, Sq) - 1;
  int kt_lo = 0, kt_hi = (Sk - 1) / BK;
  if (causal) {
    kt_hi = last_row / BK;
    if (window) kt_lo = max(0, g0 - window + 1) / BK;
  }

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp-uniform for the compiler (a broadcast), so that the descriptors
  // built from it live in uniform registers and no move into them lands
  // between two wgmmas (ptxas would serialise them)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == CONSUMERS) {
    // the producer: one thread keeps the ring of K/V tiles filled
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == CONSUMERS * 128) {
      mbar_expect_tx(q_bar, L::TILE);
      for (int c = 0; c < NB; ++c)
        tma_load(base + c * BOX, &qmap, q_bar, 64 * c, q0, bh);
      for (int kt = kt_lo, i = 0; kt <= kt_hi; ++kt, ++i) {
        const int s = i % STAGES;
        const uint32_t kd = base + L::KV + 2 * s * L::TILE;
        mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);  // the first pass is free
        mbar_expect_tx(full_k(s), L::TILE);
        for (int c = 0; c < NB; ++c)
          tma_load(kd + c * BOX, &kmap, full_k(s), 64 * c, kt * BK, bkh);
        mbar_expect_tx(full_v(s), L::TILE);
        for (int c = 0; c < NB; ++c)
          tma_load(kd + L::TILE + c * BOX, &vmap, full_v(s), 64 * c, kt * BK,
                   bkh);
      }
    }
    return;
  }

  // the consumers: warpgroup wg takes query rows q0 + 64 wg ... + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r_lo = 16 * (t / 32) + lane / 4;  // rows r_lo and r_lo + 8
  const int row0 = q0 + 64 * wg + r_lo;  // of q; q_offset + row0 in all
  const int cq = 2 * (lane % 4);
  const uint32_t qa = base + wg * 64 * 128;  // this warpgroup's rows of Q

  float acc[DP / 2];  // O over DP columns; those past D stay 0
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
  Rows rows{q_offset + row0, cq, {NEG_INF, NEG_INF}, {0.0f, 0.0f},
            {1.0f, 1.0f}};
  auto kd = [&](int i) { return base + L::KV + 2 * (i % STAGES) * L::TILE; };
  auto phase = [](int i) { return static_cast<uint32_t>((i / STAGES) & 1); };

  // Tile i's S = Q K^T runs on the tensor cores with tile i-1's O += P V
  // behind it; the softmax of tile i waits only for the first, so it
  // overlaps the second. The two warpgroups take turns to issue their
  // products, so one's softmax also runs while the other's products do.
  float sc[64];
  uint32_t p[32];  // P in bf16 pairs: A fragments, 4 for each 16 keys
  const int n_tiles = kt_hi - kt_lo + 1;
  if (wg == 1) named_arrive(TURN);  // warpgroup 0 goes first
  mbar_wait(q_bar, 0);
  mbar_wait(full_k(0), 0);
  named_sync(TURN + wg);
  issue_qk<D>(sc, qa, kd(0));
  named_arrive(TURN + 1 - wg);
  wgmma_wait();
  fence_regs(sc);
  online_softmax(sc, rows, kt_lo * BK, g0, Sk, causal, window, scale_log2);
#pragma unroll
  for (int j = 0; j < 32; ++j) p[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);
  for (int i = 1; i < n_tiles; ++i) {
    const int ps = (i - 1) % STAGES;
    fence_regs(acc);  // O's rescale and P land before any product is issued
    fence_regs(p);
    mbar_wait(full_k(i % STAGES), phase(i));
    mbar_wait(full_v(ps), phase(i - 1));
    named_sync(TURN + wg);
    issue_qk<D>(sc, qa, kd(i));
    issue_pv<DP>(acc, p, kd(i - 1) + L::TILE);
    named_arrive(TURN + 1 - wg);
    wgmma_wait_one();  // S of tile i
    fence_regs(sc);
    online_softmax(sc, rows, (kt_lo + i) * BK, g0, Sk, causal, window,
                   scale_log2);
    wgmma_wait();  // PV of tile i-1
    fence_regs(acc);
    fence_regs(p);
    mbar_arrive(empty(ps));
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[4 * n] *= rows.al[0];
      acc[4 * n + 1] *= rows.al[0];
      acc[4 * n + 2] *= rows.al[1];
      acc[4 * n + 3] *= rows.al[1];
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) p[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);
  }
  {
    const int i = n_tiles - 1;
    mbar_wait(full_v(i % STAGES), phase(i));
    named_sync(TURN + wg);
    issue_pv<DP>(acc, p, kd(i) + L::TILE);
    if (wg == 0) named_arrive(TURN + 1);  // warpgroup 1 has no turn left
    wgmma_wait();
    fence_regs(acc);
    fence_regs(p);
  }
  float l0 = rows.l[0], l1 = rows.l[1];

  // epilogue: O / l in bf16, staged swizzled in this warpgroup's rows of
  // Q; only the D true columns are staged and stored
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.0f / fmaxf(l0, 1e-20f), inv1 = 1.0f / fmaxf(l1, 1e-20f);
  // the rows' log-sum-exp for the backward, in the exp2 domain: m scale
  // log2 e + log2 l; only here, after the last PV retired, so no register
  // of a wgmma in flight is written (ptxas would serialise them all)
  if (LSE && lane % 4 == 0) {
    if (row0 < Sq)
      lse[(int64_t)bh * Sq + row0] = fmaf(rows.m[0], scale_log2, log2f(
          fmaxf(l0, 1e-20f)));
    if (row0 + 8 < Sq)
      lse[(int64_t)bh * Sq + row0 + 8] = fmaf(rows.m[1], scale_log2, log2f(
          fmaxf(l1, 1e-20f)));
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r_lo + 8 * hf;
      const float inv = hf ? inv1 : inv0;
      const int byte = (n / 8) * BOX + (64 * wg + r) * 128 +
                       (((n % 8) ^ (r & 7)) * 16) + (lane % 4) * 4;
      *reinterpret_cast<uint32_t*>(smem + byte) =
          pack_bf16(acc[4 * n + 2 * hf] * inv, acc[4 * n + 2 * hf + 1] * inv);
    }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  constexpr int CPR = D / 8;  // 16-byte chunks a row of o
  for (int i = t; i < 64 * CPR; i += 128) {
    const int r = i / CPR, c = i % CPR;
    const int row = q0 + 64 * wg + r;
    if (row >= Sq) continue;
    const uint4 val = *reinterpret_cast<const uint4*>(
        smem + (c / 8) * BOX + (64 * wg + r) * 128 + (((c % 8) ^ (r & 7)) * 16));
    *reinterpret_cast<uint4*>(o + ((int64_t)bh * Sq + row) * D + c * 8) = val;
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (heads, S, D) bf16, contiguous: boxes of 64 columns x `rows` (128 unless
// given) rows x 1 head in
// the 128-byte swizzle; rows past S, and columns past D (D = 112), read as
// zeros. The row stride, 2 D bytes, is a multiple of 16 as TMA needs.
bool tensor_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                int heads, int S, int D, int rows = BQ) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor-core forward's geometry: a block a 128-row query tile of a
// head
template <int D>
Plan forward_plan(int B, int H, int Sq) {
  return Plan{dim3(B * H, (Sq + BQ - 1) / BQ), dim3(THREADS),
              (unsigned)Smem<padded(D)>::ALLOC, 0};
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int KH, int Sq, int Sk,
                   int q_offset, float scale, int causal, int window,
                   cudaStream_t stream) {
  const Plan p = forward_plan<D>(B, H, Sq);
  static bool configured = false;
  if (!configured) {
    const int bytes = (int)p.smem;
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_tc<D, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_fwd_tc<D, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap qm, km, vm;
  // q's map has Sq rows a head, K's and V's Sk: the rows past each end
  // read as TMA's zero fill
  if (!tensor_map(encode, &qm, q, B * H, Sq, D) ||
      !tensor_map(encode, &km, k, B * KH, Sk, D) ||
      !tensor_map(encode, &vm, v, B * KH, Sk, D))
    return cudaErrorInvalidValue;
  // without lse (the serving call) the instance whose epilogue has no
  // write of it: the untaken branch alone slowed every launch measurably
  auto kernel = lse != nullptr ? flash_fwd_tc<D, true>
                               : flash_fwd_tc<D, false>;
  kernel<<<p.grid, p.block, p.smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, H, KH, Sq, Sk,
      q_offset, scale * LOG2E, causal, window);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 3. The tensor-core backward (bf16, D = 64, 112 or 128)
// ---------------------------------------------------------------------------

constexpr int BWD_THREADS = 256;  // two warpgroups of 64 rows, no producer
constexpr int BWD_STAGES = 3;     // the ring of streamed tiles
constexpr int BIG_ROWS = 128;     // the block's own tile: keys, or queries
constexpr int SMALL_ROWS = 64;    // a streamed tile
constexpr int SMALL_BOX = SMALL_ROWS * 128;  // bytes of its TMA box
constexpr int STATS_BYTES = SMALL_ROWS * 8;  // (lse, D) of 64 queries

// Shared memory of both backward kernels: two tiles of 128 rows the block
// keeps (K and V, or Q and dO), then the ring: in each stage two tiles of
// 64 rows (Q and dO, or K and V), then each stage's stats (dK/dV kernel)
template <int DP>
struct BwdSmem {
  static constexpr int BIG = (DP / 64) * BOX;
  static constexpr int SMALL = (DP / 64) * SMALL_BOX;
  static constexpr int RING = 2 * BIG;
  static constexpr int STATS = RING + BWD_STAGES * 2 * SMALL;
  static constexpr int BYTES = STATS + BWD_STAGES * STATS_BYTES;
  static constexpr int ALLOC = BYTES + 1024;
};

// one contiguous run of bytes (16-byte aligned, a multiple of 16) into
// shared memory, reported to an mbarrier as TMA's tiles are
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// issue d (64 x 64) = A B^T over D: A the warpgroup's 64 rows of a 128-row
// tile, B a 64-row tile, both K-major; D/16 steps, d overwritten by the
// first; committed as one group
template <int D>
__device__ __forceinline__ void issue_ss(float (&d)[32], uint32_t a,
                                         uint32_t b) {
  wgmma_fence();
  wgmma_ss64_first(d, sw128_desc(a, 16, 1024), sw128_desc(b, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    wgmma_ss64(d, sw128_desc(a + (kk / 4) * BOX + (kk % 4) * 32, 16, 1024),
               sw128_desc(b + (kk / 4) * SMALL_BOX + (kk % 4) * 32, 16,
                          1024));
  wgmma_commit();
}

// issue acc (64 x DP) += A B over 64 rows of B: A in registers (bf16
// pairs, 4 a step of 16), B a 64-row tile, MN-major; committed as one group
template <int DP>
__device__ __forceinline__ void issue_rs(float (&acc)[DP / 2],
                                         uint32_t (&a)[16], uint32_t b) {
  fence_regs(acc);
  fence_regs(a);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < SMALL_ROWS / 16; ++kk) {
    const uint32_t f[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                           a[4 * kk + 3]};
    wgmma_pv<DP>(acc, f, sw128_desc(b + kk * 16 * 128, SMALL_BOX, 1024));
  }
  wgmma_commit();
}

// Stage a warpgroup's accumulator (64 rows x the D true columns) in bf16
// into its rows of a 128-row tile, swizzled as the forward's epilogue
// stages O
template <int D, int DP>
__device__ __forceinline__ void stage_rows(uint8_t* tile,
                                           const float (&acc)[DP / 2],
                                           int wg, int r_lo, int lane) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r_lo + 8 * hf;
      const int byte = (n / 8) * BOX + (64 * wg + r) * 128 +
                       (((n % 8) ^ (r & 7)) * 16) + (lane % 4) * 4;
      *reinterpret_cast<uint32_t*>(tile + byte) =
          pack_bf16(acc[4 * n + 2 * hf], acc[4 * n + 2 * hf + 1]);
    }
}

// ... and store them, rows r0 + 64 wg + r below S, in 16-byte rows
template <int D>
__device__ __forceinline__ void store_rows_tc(__nv_bfloat16* __restrict__ out,
                                              const uint8_t* tile, int wg,
                                              int t, int r0, int S) {
  constexpr int CPR = D / 8;  // 16-byte chunks a row
  for (int i = t; i < 64 * CPR; i += 128) {
    const int r = i / CPR, c = i % CPR;
    const int row = r0 + 64 * wg + r;
    if (row >= S) continue;
    const uint4 val = *reinterpret_cast<const uint4*>(
        tile + (c / 8) * BOX + (64 * wg + r) * 128 +
        (((c % 8) ^ (r & 7)) * 16));
    *reinterpret_cast<uint4*>(out + (int64_t)row * D + c * 8) = val;
  }
}

// dK and dV of 128 keys of one K/V head. Warpgroup wg owns keys k0 + 64 wg
// ... + 63 as the M rows of every product: S^T = K Q^T and dP^T = V dO^T
// (m64n64, K and V K-major, Q and dO K-major), then P^T and dS^T, which
// sit in the accumulator layout that is wgmma's register A fragment, into
// dV += P^T dO and dK += dS^T Q (m64nDP, dO and Q MN-major). The Q, dO and
// stats tiles of 64 queries, of every query head of the group in turn,
// stream through the ring; thread 0 refills a stage once both warpgroups
// have arrived on its empty barrier.
template <int D>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_bwd_dkdv_tc(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap domap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const float* __restrict__ stats,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, int H, int KH, int S,
                  int SP, float scale, float scale_log2, int causal,
                  int window) {
  constexpr int DP = padded(D);
  constexpr int NB = DP / 64;
  using L = BwdSmem<DP>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * BWD_STAGES];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_addr(smem);
  const uint32_t kv_bar = smem_addr(bars);
  auto full = [&](int s) { return kv_bar + 8 * (1 + s); };
  auto empty = [&](int s) { return kv_bar + 8 * (1 + BWD_STAGES + s); };
  auto q_at = [&](int s) { return base + L::RING + 2 * s * L::SMALL; };
  auto st_at = [&](int s) { return L::STATS + s * STATS_BYTES; };

  const int bkh = blockIdx.x;
  const int k0 = blockIdx.y * BIG_ROWS;  // heavy (early) causal tiles first
  const int b = bkh / KH, kh = bkh - b * KH, G = H / KH;
  int qt_lo = 0, qt_hi = (S - 1) / SMALL_ROWS;  // the queries that see a key
  if (causal) {
    qt_lo = k0 / SMALL_ROWS;
    if (window)
      qt_hi = min(S - 1, k0 + BIG_ROWS - 1 + window - 1) / SMALL_ROWS;
  }
  const int nq = qt_hi - qt_lo + 1;
  const int n_tiles = G * nq;  // every query head of the group in turn
  auto tile_q0 = [&](int i) { return (qt_lo + i % nq) * SMALL_ROWS; };
  auto tile_bh = [&](int i) { return b * H + kh * G + i / nq; };
  auto load = [&](int i) {  // thread 0: tile i into stage i % BWD_STAGES
    const int s = i % BWD_STAGES, q0 = tile_q0(i), bh = tile_bh(i);
    mbar_expect_tx(full(s), 2 * L::SMALL + STATS_BYTES);
    for (int c = 0; c < NB; ++c) {
      tma_load(q_at(s) + c * SMALL_BOX, &qmap, full(s), 64 * c, q0, bh);
      tma_load(q_at(s) + L::SMALL + c * SMALL_BOX, &domap, full(s), 64 * c,
               q0, bh);
    }
    bulk_load(base + st_at(s), stats + ((int64_t)bh * SP + q0) * 2,
              STATS_BYTES, full(s));
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < BWD_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), BWD_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(kv_bar, 2 * L::BIG);
    for (int c = 0; c < NB; ++c) {
      tma_load(base + c * BOX, &kmap, kv_bar, 64 * c, k0, bkh);
      tma_load(base + L::BIG + c * BOX, &vmap, kv_bar, 64 * c, k0, bkh);
    }
    for (int i = 0; i < min(BWD_STAGES - 1, n_tiles); ++i) load(i);
  }

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r_lo = 16 * (t / 32) + lane / 4;  // key rows r_lo and r_lo + 8
  const int cq = 2 * (lane % 4);  // first query column in each 8-column chunk
  const int kw0 = k0 + 64 * wg;   // the warpgroup's first key
  const uint32_t ka = base + wg * 64 * 128;  // its rows of K, then of V
  const uint32_t va = ka + L::BIG;

  float dv_acc[DP / 2], dk_acc[DP / 2];  // columns past D stay 0
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dv_acc[i] = dk_acc[i] = 0.0f;
  float sc[32], dp[32];
  uint32_t pf[16], sf[16];  // P^T and dS^T in bf16 pairs: A fragments
  mbar_wait(kv_bar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % BWD_STAGES;
    if (threadIdx.x == 0 && i + BWD_STAGES - 1 < n_tiles) {
      const int j = i + BWD_STAGES - 1;  // into the stage tile i-1 held
      if (j >= BWD_STAGES)
        mbar_wait(empty(j % BWD_STAGES), (j / BWD_STAGES - 1) & 1);
      load(j);
    }
    __syncwarp();
    const int q0 = tile_q0(i);
    // a warpgroup whose 64 keys no query of the tile sees (or past S)
    const bool hidden = kw0 >= S ||
                        (causal && (kw0 > q0 + SMALL_ROWS - 1 ||
                                    (window && kw0 + 63 + window <= q0)));
    mbar_wait(full(s), (i / BWD_STAGES) & 1);
    if (!hidden) {
      issue_ss<D>(sc, ka, q_at(s));            // S^T = K Q^T
      issue_ss<D>(dp, va, q_at(s) + L::SMALL);  // dP^T = V dO^T
      const bool edge = q0 + SMALL_ROWS > S || kw0 + 64 > S ||
                        (causal && (kw0 + 63 > q0 ||
                                    (window && kw0 <= q0 + 63 - window)));
      const float* st = reinterpret_cast<const float*>(smem + st_at(s));
      // P^T while dP^T's product runs, then dV's product while dS^T is
      // formed: no register of a wgmma in flight is written
      wgmma_wait_one();
      fence_regs(sc);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        // lse of queries q0 + 8n + cq and the next
        const float4 w =
            *reinterpret_cast<const float4*>(st + 2 * (8 * n + cq));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kw0 + r_lo + 8 * (e >> 1);
          const int query = q0 + 8 * n + cq + (e & 1);
          sc[4 * n + e] = (!edge || visible(query, key, S, causal, window))
                              ? exp2_ftz(fmaf(sc[4 * n + e], scale_log2,
                                              (e & 1) ? -w.z : -w.x))
                              : 0.0f;
        }
        pf[2 * n] = pack_bf16(sc[4 * n], sc[4 * n + 1]);
        pf[2 * n + 1] = pack_bf16(sc[4 * n + 2], sc[4 * n + 3]);
      }
      issue_rs<DP>(dv_acc, pf, q_at(s) + L::SMALL);  // dV += P^T dO
      wgmma_wait_one();  // dP^T
      fence_regs(dp);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float4 w =
            *reinterpret_cast<const float4*>(st + 2 * (8 * n + cq));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * n + e] = sc[4 * n + e] *
                          (dp[4 * n + e] - ((e & 1) ? w.w : w.y)) * scale;
        sf[2 * n] = pack_bf16(dp[4 * n], dp[4 * n + 1]);
        sf[2 * n + 1] = pack_bf16(dp[4 * n + 2], dp[4 * n + 3]);
      }
      issue_rs<DP>(dk_acc, sf, q_at(s));             // dK += dS^T Q
      wgmma_wait();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pf);
      fence_regs(sf);
    }
    mbar_arrive(empty(s));
  }
  // epilogue: each warpgroup stages its rows of dK and dV in bf16 over its
  // own rows of K and V (which only it read) and stores the D true columns
  stage_rows<D, DP>(smem, dk_acc, wg, r_lo, lane);
  stage_rows<D, DP>(smem + L::BIG, dv_acc, wg, r_lo, lane);
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  store_rows_tc<D>(dk + (int64_t)bkh * S * D, smem, wg, t, k0, S);
  store_rows_tc<D>(dv + (int64_t)bkh * S * D, smem + L::BIG, wg, t, k0, S);
}

// dQ of 128 query rows of one head: warpgroup wg owns rows q0 + 64 wg ...
// + 63; S = Q K^T and dP = dO V^T (m64n64), dS in the accumulator layout
// into dQ += dS K (m64nDP, K MN-major). K/V tiles of 64 keys stream through
// the ring; heavy causal tiles first.
template <int D>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_bwd_dq_tc(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap domap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const float* __restrict__ stats,
                __nv_bfloat16* __restrict__ dq, int H, int KH, int S, int SP,
                float scale, float scale_log2, int causal, int window) {
  constexpr int DP = padded(D);
  constexpr int NB = DP / 64;
  using L = BwdSmem<DP>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * BWD_STAGES];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_addr(smem);
  const uint32_t qd_bar = smem_addr(bars);
  auto full = [&](int s) { return qd_bar + 8 * (1 + s); };
  auto empty = [&](int s) { return qd_bar + 8 * (1 + BWD_STAGES + s); };
  auto k_at = [&](int s) { return base + L::RING + 2 * s * L::SMALL; };

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BIG_ROWS;  // heavy first
  const int b = bh / H, h = bh - b * H;
  const int bkh = b * KH + h / (H / KH);
  const int last_row = min(q0 + BIG_ROWS, S) - 1;
  int kt_lo = 0, kt_hi = (S - 1) / SMALL_ROWS;
  if (causal) {
    kt_hi = last_row / SMALL_ROWS;
    if (window) kt_lo = max(0, q0 - window + 1) / SMALL_ROWS;
  }
  const int n_tiles = kt_hi - kt_lo + 1;
  auto load = [&](int i) {  // thread 0: K/V tile i into stage i % BWD_STAGES
    const int s = i % BWD_STAGES, k0 = (kt_lo + i) * SMALL_ROWS;
    mbar_expect_tx(full(s), 2 * L::SMALL);
    for (int c = 0; c < NB; ++c) {
      tma_load(k_at(s) + c * SMALL_BOX, &kmap, full(s), 64 * c, k0, bkh);
      tma_load(k_at(s) + L::SMALL + c * SMALL_BOX, &vmap, full(s), 64 * c,
               k0, bkh);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(qd_bar, 1);
    for (int s = 0; s < BWD_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), BWD_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(qd_bar, 2 * L::BIG);
    for (int c = 0; c < NB; ++c) {
      tma_load(base + c * BOX, &qmap, qd_bar, 64 * c, q0, bh);
      tma_load(base + L::BIG + c * BOX, &domap, qd_bar, 64 * c, q0, bh);
    }
    for (int i = 0; i < min(BWD_STAGES - 1, n_tiles); ++i) load(i);
  }

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r_lo = 16 * (t / 32) + lane / 4;  // query rows r_lo and r_lo + 8
  const int cq = 2 * (lane % 4);  // first key column in each 8-column chunk
  const int qw0 = q0 + 64 * wg;   // the warpgroup's first query
  const uint32_t qa = base + wg * 64 * 128;  // its rows of Q, then of dO
  const uint32_t doa = qa + L::BIG;
  // the two rows' (lse, D); SP covers every row of the block
  float2 st[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    st[hf] = *reinterpret_cast<const float2*>(
        stats + ((int64_t)bh * SP + qw0 + r_lo + 8 * hf) * 2);

  float acc[DP / 2];  // dQ; columns past D stay 0
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
  float sc[32], dp[32];
  uint32_t sf[16];  // dS in bf16 pairs: A fragments
  mbar_wait(qd_bar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % BWD_STAGES;
    if (threadIdx.x == 0 && i + BWD_STAGES - 1 < n_tiles) {
      const int j = i + BWD_STAGES - 1;
      if (j >= BWD_STAGES)
        mbar_wait(empty(j % BWD_STAGES), (j / BWD_STAGES - 1) & 1);
      load(j);
    }
    __syncwarp();
    const int k0 = (kt_lo + i) * SMALL_ROWS;
    const bool hidden = qw0 >= S ||
                        (causal && (k0 > qw0 + 63 ||
                                    (window && k0 + 63 + window <= qw0)));
    mbar_wait(full(s), (i / BWD_STAGES) & 1);
    if (!hidden) {
      issue_ss<D>(sc, qa, k_at(s));             // S = Q K^T
      issue_ss<D>(dp, doa, k_at(s) + L::SMALL);  // dP = dO V^T
      const bool edge = qw0 + 64 > S || k0 + SMALL_ROWS > S ||
                        (causal && (k0 + 63 > qw0 ||
                                    (window && k0 <= qw0 + 63 - window)));
      wgmma_wait_one();  // S; P while dP's product runs
      fence_regs(sc);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hf = e >> 1;
          const int row = qw0 + r_lo + 8 * hf;
          const int key = k0 + 8 * n + cq + (e & 1);
          sc[4 * n + e] = (!edge || visible(row, key, S, causal, window))
                              ? exp2_ftz(fmaf(sc[4 * n + e], scale_log2,
                                              -st[hf].x))
                              : 0.0f;
        }
      wgmma_wait();
      fence_regs(dp);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * n + e] = sc[4 * n + e] *
                          (dp[4 * n + e] - st[e >> 1].y) * scale;
        sf[2 * n] = pack_bf16(dp[4 * n], dp[4 * n + 1]);
        sf[2 * n + 1] = pack_bf16(dp[4 * n + 2], dp[4 * n + 3]);
      }
      issue_rs<DP>(acc, sf, k_at(s));  // dQ += dS K
      wgmma_wait();
      fence_regs(acc);
      fence_regs(sf);
    }
    mbar_arrive(empty(s));
  }
  // epilogue: staged over the warpgroup's own rows of Q
  stage_rows<D, DP>(smem, acc, wg, r_lo, lane);
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  store_rows_tc<D>(dq + (int64_t)bh * S * D, smem, wg, t, q0, S);
}

// The tensor-core backward's dK/dV kernel: a block a 128-key tile of a
// K/V head
template <int D>
Plan dkdv_plan(int B, int KH, int S) {
  return Plan{dim3(B * KH, (S + BIG_ROWS - 1) / BIG_ROWS), dim3(BWD_THREADS),
              (unsigned)BwdSmem<padded(D)>::ALLOC, 0};
}

// ... and its dQ kernel: a block a 128-row query tile of a head
template <int D>
Plan dq_plan(int B, int H, int S) {
  return Plan{dim3(B * H, (S + BIG_ROWS - 1) / BIG_ROWS), dim3(BWD_THREADS),
              (unsigned)BwdSmem<padded(D)>::ALLOC, 0};
}

template <int D>
cudaError_t launch_backward(const void* q, const void* k, const void* v,
                            const void* o, const float* lse, const void* dout,
                            void* dq, void* dk, void* dv, float* stats,
                            int B, int H, int KH, int S, int SP, float scale,
                            int causal, int window, cudaStream_t stream) {
  constexpr int ALLOC = BwdSmem<padded(D)>::ALLOC;
  const Plan pp = prep_plan(B, H, SP), pk = dkdv_plan<D>(B, KH, S),
             pq = dq_plan<D>(B, H, S);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        ALLOC);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dq_tc<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 ALLOC);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  // 64-row boxes of what a kernel streams, 128-row boxes of what it keeps
  CUtensorMap q64, do64, k128, v128, q128, do128, k64, v64;
  if (!tensor_map(encode, &q64, q, B * H, S, D, SMALL_ROWS) ||
      !tensor_map(encode, &do64, dout, B * H, S, D, SMALL_ROWS) ||
      !tensor_map(encode, &k128, k, B * KH, S, D, BIG_ROWS) ||
      !tensor_map(encode, &v128, v, B * KH, S, D, BIG_ROWS) ||
      !tensor_map(encode, &q128, q, B * H, S, D, BIG_ROWS) ||
      !tensor_map(encode, &do128, dout, B * H, S, D, BIG_ROWS) ||
      !tensor_map(encode, &k64, k, B * KH, S, D, SMALL_ROWS) ||
      !tensor_map(encode, &v64, v, B * KH, S, D, SMALL_ROWS))
    return cudaErrorInvalidValue;
  flash_bwd_prep<__nv_bfloat16, D><<<pp.grid, pp.block, pp.smem, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, stats, B * H, S, SP);
  flash_bwd_dkdv_tc<D><<<pk.grid, pk.block, pk.smem, stream>>>(
      q64, do64, k128, v128, stats, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, KH, S, SP, scale, scale * LOG2E,
      causal, window);
  flash_bwd_dq_tc<D><<<pq.grid, pq.block, pq.smem, stream>>>(
      q128, do128, k64, v64, stats, static_cast<__nv_bfloat16*>(dq), H, KH,
      S, SP, scale, scale * LOG2E, causal, window);
  return cudaGetLastError();
}

}  // namespace tc

// The backward's stats rows a head: S padded to a multiple of 128, as the
// wrapper pads them (kernels/flash_attention/kernel.py STATS_ROWS)
int stats_rows(int S) { return (S + 127) / 128 * 128; }

// The plan and the kernel of a scalar launch (`plan_of`'s args)
template <typename T, int D>
struct Geometry {
  static cudaError_t run(const int* a, Plan* p, const void** fn) {
    const int B = a[1], H = a[2], KH = a[3], S = a[4];
    switch (a[0]) {
      case 0:
        *p = forward_plan<T, D>(B, H, S);
        *fn = (const void*)flash_fwd_kernel<T, D>;
        return cudaSuccess;
      case 2:
        *p = prep_plan(B, H, stats_rows(S));
        *fn = (const void*)flash_bwd_prep<T, D>;
        return cudaSuccess;
      case 3:
        *p = dkdv_plan<T, D>(B, KH, S);
        *fn = (const void*)flash_bwd_dkdv_kernel<T, D>;
        return cudaSuccess;
      case 4:
        *p = dq_plan<T, D>(B, H, S);
        *fn = (const void*)flash_bwd_dq_kernel<T, D>;
        return cudaSuccess;
      default:
        return cudaErrorInvalidValue;
    }
  }
};

// ... and of a tensor-core launch
template <int D>
cudaError_t tc_geometry(const int* a, Plan* p, const void** fn) {
  const int B = a[1], H = a[2], KH = a[3], S = a[4];
  switch (a[0]) {
    case 1:
      *p = tc::forward_plan<D>(B, H, S);
      *fn = a[7] ? (const void*)tc::flash_fwd_tc<D, true>
                 : (const void*)tc::flash_fwd_tc<D, false>;
      return cudaSuccess;
    case 5:
      *p = prep_plan(B, H, stats_rows(S));
      *fn = (const void*)flash_bwd_prep<__nv_bfloat16, D>;
      return cudaSuccess;
    case 6:
      *p = tc::dkdv_plan<D>(B, KH, S);
      *fn = (const void*)tc::flash_bwd_dkdv_tc<D>;
      return cudaSuccess;
    case 7:
      *p = tc::dq_plan<D>(B, H, S);
      *fn = (const void*)tc::flash_bwd_dq_tc<D>;
      return cudaSuccess;
    default:
      return cudaErrorInvalidValue;
  }
}

// The plan and the kernel of a launch at args = {which, B, H, KH, Sq, Sk,
// D, flag}: which 0 the scalar forward, 2, 3 and 4 the scalar backward's
// pre-pass, dK/dV and dQ kernels (flag the dtype: 0 f32, 1 bf16); 1 the
// tensor-core forward (flag 1 with lse), 5, 6 and 7 the tensor-core
// backward's three (Sq the backward's S)
cudaError_t plan_of(const int* a, Plan* p, const void** fn) {
  if (a[1] <= 0 || a[2] <= 0 || a[3] <= 0 || a[4] <= 0 || a[2] % a[3])
    return cudaErrorInvalidValue;
  if (a[0] == 1 || (a[0] >= 5 && a[0] <= 7)) {
    switch (a[6]) {
      case 64:
        return tc_geometry<64>(a, p, fn);
      case 112:
        return tc_geometry<112>(a, p, fn);
      case 128:
        return tc_geometry<128>(a, p, fn);
      default:
        return cudaErrorInvalidValue;
    }
  }
  return by_type_and_dim<Geometry>(a[7], a[6], a, p, fn);
}

}  // namespace

extern "C" {

const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The scalar kernel: q, o (B, H, Sq, D); k, v (B, KH, Sk, D); contiguous,
// 16-byte aligned, H a multiple of KH, B*H <= 65535 (the wrapper checks).
// dtype: 0 = f32 with D in {16, 64, 112, 128}, 1 = bf16 with D = 16.
// causal and window as in the Pallas kernel (window applies only with
// causal; 0 = none), over positions in the whole sequence of Sk keys:
// query row i is row q_offset + i there, so the causal mask keeps keys
// j <= q_offset + i and the window keys j > q_offset + i - window
// (q_offset + Sq <= Sk under a mask; an unmasked call takes any Sq, Sk).
// lse: null, or (B, H, Sq) f32 that gets each row's log-sum-exp in the
// log2 domain (for the backward). Launches on `stream`, allocates
// nothing, returns cudaGetLastError().
int flash_attention_forward(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int H, int KH, int Sq,
                            int Sk, int q_offset, int D, float scale,
                            int causal, int window, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || KH <= 0 || Sq <= 0 || Sk <= 0 || H % KH ||
      q_offset < 0 || (causal && q_offset + Sq > Sk))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(by_type_and_dim<Forward>(
      dtype, D, q, k, v, o, static_cast<float*>(lse), B, H, KH, Sq, Sk,
      q_offset, scale, causal, window, s));
}

// The tensor-core kernel: bf16 q, o (B, H, Sq, D) and k, v (B, KH, Sk,
// D), contiguous, 16-byte aligned, H a multiple of KH, D in {64, 112, 128}
// (the wrapper checks). causal, window, q_offset and lse as above.
// Launches on `stream`, allocates nothing, returns the first CUDA error
// (cudaErrorNotSupported if cuTensorMapEncodeTiled cannot be found).
int flash_attention_forward_tc(const void* q, const void* k, const void* v,
                               void* o, void* lse, int B, int H, int KH,
                               int Sq, int Sk, int q_offset, int D,
                               float scale, int causal, int window,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (B <= 0 || H <= 0 || KH <= 0 || Sq <= 0 || Sk <= 0 || H % KH ||
      q_offset < 0 || (causal && q_offset + Sq > Sk))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64:
      return static_cast<int>(tc::launch<64>(q, k, v, o, l, B, H, KH, Sq,
                                             Sk, q_offset, scale, causal,
                                             window, s));
    case 112:
      return static_cast<int>(tc::launch<112>(q, k, v, o, l, B, H, KH, Sq,
                                              Sk, q_offset, scale, causal,
                                              window, s));
    case 128:
      return static_cast<int>(tc::launch<128>(q, k, v, o, l, B, H, KH, Sq,
                                              Sk, q_offset, scale, causal,
                                              window, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward, three launches on `stream`: the pre-pass, then the dK/dV
// and the dQ kernel. q, o, dout, dq (B, H, S, D); k, v, dk, dv (B, KH, S,
// D); lse (B, H, S) f32 from the forward; stats scratch of B*H*SP*2 f32,
// SP a multiple of 128 and >= S. Contiguous, 16-byte aligned, all of one
// dtype (0 = f32, D in {16, 64, 112, 128}; 1 = bf16 with D = 16) for the
// scalar kernels, bf16 with D in {64, 112, 128} for the tensor-core ones
// (`flash_attention_backward_tc`); causal and window as the forward's.
// Allocates nothing, returns the first CUDA error.
int flash_attention_backward(const void* q, const void* k, const void* v,
                             const void* o, const void* lse,
                             const void* dout, void* dq, void* dk, void* dv,
                             void* stats, int B, int H, int KH, int S,
                             int SP, int D, float scale, int causal,
                             int window, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || KH <= 0 || S <= 0 || H % KH || SP < S || SP % 128)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(by_type_and_dim<Backward>(
      dtype, D, q, k, v, o, static_cast<const float*>(lse), dout, dq, dk, dv,
      static_cast<float*>(stats), B, H, KH, S, SP, scale, causal, window, s));
}

// The geometry of a launch (`plan_of`'s args), as the launchers above use
// it: out as launch_plan.h `write_plan`'s.
int flash_plan(const int* args, int* out) {
  Plan p;
  const void* fn;
  const cudaError_t err = plan_of(args, &p, &fn);
  if (err == cudaSuccess) write_plan(p, out);
  return static_cast<int>(err);
}

// The attributes of that launch's kernel on the current device, and its
// blocks an SM at that geometry: out as `write_attributes`'.
int flash_attributes(const int* args, int* out) {
  Plan p;
  const void* fn;
  cudaError_t err = plan_of(args, &p, &fn);
  if (err == cudaSuccess) err = write_attributes(fn, p, out);
  return static_cast<int>(err);
}

int flash_attention_backward_tc(const void* q, const void* k, const void* v,
                                const void* o, const void* lse,
                                const void* dout, void* dq, void* dk,
                                void* dv, void* stats, int B, int H, int KH,
                                int S, int SP, int D, float scale, int causal,
                                int window, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* st = static_cast<float*>(stats);
  if (B <= 0 || H <= 0 || KH <= 0 || S <= 0 || H % KH || SP < S || SP % 128)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64:
      return static_cast<int>(tc::launch_backward<64>(
          q, k, v, o, l, dout, dq, dk, dv, st, B, H, KH, S, SP, scale,
          causal, window, s));
    case 112:
      return static_cast<int>(tc::launch_backward<112>(
          q, k, v, o, l, dout, dq, dk, dv, st, B, H, KH, S, SP, scale,
          causal, window, s));
    case 128:
      return static_cast<int>(tc::launch_backward<128>(
          q, k, v, o, l, dout, dq, dk, dv, st, B, H, KH, S, SP, scale,
          causal, window, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
