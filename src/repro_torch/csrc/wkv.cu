// The RWKV6 WKV recurrence for Hopper (sm_90a), bound with ctypes: two
// kernels, a chunked one on the tensor cores for prefill and the
// sequential one for decode and head dim 16; and its gradient, likewise a
// chunked tensor-core backward (4 below) for training at head dim 64 and a
// sequential one (3) for the rest.
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv/kernel.py
// `_wkv_kernel` (via `wkv_pallas`). For each batch row b and head h, over
// t = 0..S-1, with S_{-1} the initial state (zero if none is given):
//   out_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
//   S_t   = diag(exp lw_t) S_{t-1} + k_t v_t^T
// r, k, v, lw are f32 (B, H, S, D) with any strides whose last is 1, u is
// (H, D), the state (B, H, D, D) f32, indexed [key row i][value column j].
// Returns out (f32, B x H x S x D, strides of its own) and the final state.
// Both kernels compute the recurrence as the sequential oracle `wkv_ref`
// (src/repro/kernels/wkv/ref.py) states it, for every lw <= 0.
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
// Which kernel takes a call (kernels/wkv/kernel.py `kernel_for`, an
// explicit rule, never a fallback after a failure): head dim 64 with
// S >= 64 -> the chunked kernel; S < 64 (decode) and head dim 16 -> the
// sequential kernel. Both take their arguments packed in one `WkvArgs`.
//
// 1. The sequential kernel (`wkv_kernel`). What held it back at prefill:
// it runs the recurrence a token at a time on the CUDA cores, and every
// element of S reads r, k and exp(lw) from shared memory each step (three
// loads for two FMAs) and each step writes a partial sum; the FMA pipes
// wait on shared memory, 8.5x the operation bound at the forward's shape.
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
// 2. The chunked kernel (`wkv_chunk_kernel`, D = 64, any S >= 1) turns
// each chunk of C = 64 tokens into matrix products on the tensor cores, as
// the TPU kernel does for its MXU, but not with its algebra: that factors
// exp(cum_{t-1} - cum_i) into exp(cum_{t-1}) exp(-cum_i), and exp(-cum)
// overflows f32 under strong decay (NaN at lw = -1.5 and chunks of 64).
// The exponent rule here: no exponent is ever formed. Every decay is a
// product of w = exp(lw) <= 1 over a range of tokens that runs forward
// from a reference point, so every factor lies in [0, 1]; strong decay
// underflows to 0 where the truth is ~0, and never reaches inf or NaN.
// W[a, b) below is the product of w over tokens a..b-1 of the chunk.
// In a chunk with incoming state S0, for t and i in it:
//   out_t = (r_t * W[0, t)) S0 + sum_{i <= t} A[t, i] v_i
//   S_end = diag(W[0, 64)) S0 + sum_i (k_i * W(i, 64))^T v_i
//   A[t, i] = sum_d r_t[d] k_i[d] W(i, t)[d]   (i < t; W(i, t) = W[i+1, t))
//   A[t, t] = r_t . diag(u) k_t                (the bonus)
// The tokens fall into eight 8-blocks and four 16-blocks. Each factor:
// - r_t * W[0, t) (inter-chunk rows) and k_i * W(i, 64) (state update):
//   products over tokens of the chunk, <= 1;
// - A between 16-blocks a < m: ref = the start of m, A = (r_t * W[ref, t))
//   (k_i * W(i, ref))^T: t >= ref > i, both ranges forward, both <= 1;
// - A between the two 8-blocks of one 16-block: ref = the second's start,
//   the same factorisation;
// - A inside an 8-block: W(i, t) element by element, a running product of
//   w from i on (no MUFU, no cancellation).
// Every product is a product of f32 values in [0, 1] and of w's own
// rounding: no prefix sum of lw is differenced, so weak decay keeps f32's
// relative precision too. rL = r * W[start of t's 8-block, t) and kL = k *
// W(i, end of i's 8-block] are formed once a chunk; every other factor is
// a product of whole 8-blocks' W (tables F, RS, KS, KF), applied as an
// operand is loaded.
// Products on the tensor cores: A between blocks, A V, (r W) S0 and
// (k W)^T V, by mma.sync m16n8k8 in TF32 with a 3xTF32 split: each operand
// x = hi + lo (hi = x rounded to TF32, lo = x - hi, which the tensor cores
// truncate to TF32) and hi.hi accumulated apart from hi.lo and lo.hi,
// summed in f32 at the end. Plain TF32 keeps ~3 digits, the split ~f32's:
// the CPU tests hold wkv_chunked_ref, the same arithmetic with the same
// operand rounding, to the 1e-5 tolerance. The state is never an
// accumulator of the products: each chunk's (k W)^T V starts from zero and
// S = W S + that in f32, so the tensor cores' accumulation rounds each
// chunk's share, not the state carried over 32 chunks.
// Grid and memory. A block takes NJ = 32 value columns of one head (the
// decay acts on rows, so columns are independent): 2 blocks a head, 128
// at the forward's shape, one an SM with 161 KB of shared memory. What
// the split costs: both blocks of a head make the same 8-block pass, the
// same tables and the same A (a third of a block's products) and read the
// same r, k, lw from L2; a cluster sharing them would halve that. Each
// chunk's r, k, lw and the block's columns of v arrive by TMA, one box an
// operand from a 4-D tensor map (D, S, H, B) over the model's strides,
// issued by one thread and counted on an mbarrier: r, k, v into one of two
// buffers, lw into one, the next chunk's issued once the tables are made,
// so it lands while this chunk's products run. The boxes of r, k, lw are
// 68 columns wide over a 64-wide tensor, so the 4 columns outside read as
// zeros and the rows land padded (row stride 68: conflict-free fragment
// loads); rows past S read as zeros too (r = k = v = 0 and w = 1 mask the
// ragged last chunk). v and the state's slice, the B operands every warp
// reads, are kept split in shared memory in b-fragment order, a lane's
// fragment one 16-byte load (put_split).
// Eight warps, per chunk: (1) the 8-block pass, one 8-block a warp, two
// columns a lane: rL, kL, F and A inside the 8-block, its pairs summed over
// the warp by a reduce-scatter of shuffles in a fixed order; (2) the
// tables and v's split; (3) A between blocks, two 16 x 8 tiles a warp, and
// then warps 0-3 out's tiles from S0 (16 rows of 16-block w, all 32
// columns) while warps 4-7 update the state rows they hold in registers
// (16 rows each, all 32 columns): a split A fragment serves four column
// tiles; (4) out's tiles from A: warp w < 4 column tiles 0, 1 of 16-block
// w, warp w + 4 (the same sub-partition) tiles 2, 3 of 16-block 3 - w, so
// each sub-partition has 10 of the 40 k-steps; warps 4-7 write the new
// state's split. No atomics: results repeat bit for bit. Each block reads
// its state columns at the start and writes them at the end, so state_in
// may be state_out.
// Where the time goes (kernels/wkv/cycles.py, clock64() per phase, at the
// forward's shape on an NVIDIA H100 80GB HBM3 at 700 W): ~7,600 cycles a
// chunk, 0.142 ms a launch. The 8-block pass takes ~1,480 (plus the wait
// for the slowest warp's step 4), the tables ~660, A between blocks
// ~1,350-1,550, out from S0 and the state ~1,850-2,030, out from A
// ~680-1,810. mma.sync in TF32 alone runs at ~3.45 ns a product on a
// sub-partition (~315 TFLOP/s, ~64% of the TF32 peak), so the chunk's 1,392
// products need ~2,400 of the cycles at 1.98 GHz; shared memory moves
// ~4,700 wavefronts a chunk (operands reread by several warps, factors
// loaded beside them), and the rest is the pass, the barriers and ~8
// instructions a product for loading, scaling and splitting operands.
// Tried and not kept: prep warps a chunk ahead of state warps (the SM's
// shared memory and issue slots, not the order of the phases, set the
// time); a cluster of a head's two blocks sharing the pass and A (it needs
// two or three cluster barriers a chunk, and cycles.py times one at ~760
// cycles against ~30 for __syncthreads).
//
// Accurate expf (not __expf), as torch.exp, in both. Built without
// --fmad=false: the fused multiply-adds change out by rounding only, about
// 1e-7 of max |out|, far below the tolerance the kernels are held to
// against the plain version (1e-5 of max |out| and of max |state|; see
// kernels/wkv/kernel.py). Times at the forward's and decode's shapes on an
// NVIDIA H100 80GB HBM3 are in PERF.md (chip_smoke.py).
#include <cuda.h>  // CUtensorMap and its enums; libcuda is found at run time
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "launch_plan.h"

// The arguments of one launch in one buffer, which the wrapper packs with
// Python's struct format "=8Q4i6q" (kernels/wkv/kernel.py `_pack`): ctypes
// converts one pointer argument in a fraction of the time it takes for
// fifteen, and decode launches the sequential kernel 24 times a step.
struct WkvArgs {
  const float* r;
  const float* k;
  const float* v;
  const float* lw;
  const float* u;
  const float* state_in;  // null: zeros
  float* state_out;
  float* out;
  int B, H, S, D;
  int64_t in_sb, in_sh, in_ss;     // strides of r, k, v, lw (b, h, s)
  int64_t out_sb, out_sh, out_ss;  // strides of out (b, h, s)
};
static_assert(sizeof(WkvArgs) == 128 && offsetof(WkvArgs, B) == 64 &&
                  offsetof(WkvArgs, in_sb) == 80 &&
                  offsetof(WkvArgs, out_sb) == 104,
              "WkvArgs must match the wrapper's struct format =8Q4i6q");

// The backward's arguments, packed by the wrapper with "=12Q4i3q"
// (kernels/wkv/kernel.py `_pack_backward`): r, k, v, lw as the forward
// takes them, u (H, D), dout (B, H, S, D) contiguous; dr, dk, dlw (B, H, S,
// D) contiguous. For the sequential backward (3): dv (D / R, B, H, S, D), a
// partial sum per block of R rows; du (B, H, D), a partial sum per batch
// row; the scratch for the saved states, B * H * ceil(S / T) * D * D
// floats. For the chunked one (4): dv (B, H, S, D); du (B, H, ceil(S / 64),
// D), a partial sum per chunk; the scratch 2 * B * H * ceil(S / 64) * D * D
// floats.
struct WkvBackArgs {
  const float* r;
  const float* k;
  const float* v;
  const float* lw;
  const float* u;
  const float* dout;
  float* dr;
  float* dk;
  float* dv;
  float* dlw;
  float* du;
  float* states;
  int B, H, S, D;
  int64_t in_sb, in_sh, in_ss;  // strides of r, k, v, lw (b, h, s)
};
static_assert(sizeof(WkvBackArgs) == 136 && offsetof(WkvBackArgs, B) == 96 &&
                  offsetof(WkvBackArgs, in_sb) == 112,
              "WkvBackArgs must match the wrapper's struct format =12Q4i3q");

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

namespace chunk {

constexpr int D = 64;        // head dim
constexpr int C = 64;        // tokens a chunk
constexpr int NQ = C / 8;    // 8-blocks a chunk
constexpr int NJ = 32;       // value columns a block
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int LDR = D + 4;   // row stride (floats) of r, k, lw, A: the
                             // fragments' rows g, columns c -> 4g + c banks
constexpr int LDQ = NJ + 2;  // row stride (16-byte units) of the split v
                             // and S: rows c, columns g -> units 2c + g
constexpr int NKF = 12;      // KF entries: 16-block m = 1..3, 8-block q < 2m
// a chunk's boxes: r, k, lw of LDR columns (the last 4 outside the tensor,
// so zeros: the rows land padded) and v of NJ columns, C rows each
constexpr uint32_t CHUNK_BYTES = 4 * C * (3 * LDR + NJ);
static_assert(THREADS == 4 * D, "the tables take four roles of D threads");

struct Smem {
  float r[2][C][LDR];  // r, then rL = r * W[start of t's 8-block, t)
  float k[2][C][LDR];  // k, then kL = k * W(t, end of t's 8-block]
  float v[2][C][NJ];   // the block's columns of v
  float lw[C][LDR];
  float A[C][LDR];     // intra-chunk A, zero above the diagonal
  uint4 vs[C / 8][4][LDQ];  // v split, as b fragments (see put_split)
  uint4 S[D / 8][4][LDQ];   // the block's columns of S0 split, alike
  float X[4][8][32];   // out's tiles 2, 3 from S0 of 16-block m, for warp
                       // 7 - m
  float F[NQ][D];      // W over 8-block q
  float RS[NQ][D];     // W over the 8-blocks before q
  float KS[NQ][D];     // W over the 8-blocks after q
  float KF[NKF][D];    // [m (m - 1) + q]: W over 8-blocks q+1 .. 2m-1
  float Ftot[D];       // W over the chunk
  unsigned long long bar[2];  // chunk data landed, by chunk parity
};
constexpr size_t SMEM = sizeof(Smem) + 128;  // slack to align to 128
static_assert(SMEM <= 227 * 1024, "shared memory");
static_assert(sizeof(float) * C * LDR % 128 == 0 &&
                  sizeof(float) * C * NJ % 128 == 0,
              "every TMA destination 128-byte aligned");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// one box of a 4-D tensor map (D, S, H, B) into shared memory, counted on
// mbarrier `bar`; elements outside the tensor read as zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(h), "r"(b)
      : "memory");
}

// An operand fragment as hi + lo for the 3xTF32 products: hi = x rounded
// to TF32, to nearest with ties away from zero (half a TF32 ulp added to
// the bits, the 13 low bits cleared: three instructions, where sm_90
// expands cvt.rna.tf32.f32 into five with NaN checks; the operands are
// finite), lo = x - hi exactly, handed over in f32: the tensor cores read
// a TF32 operand's top 19 bits, so lo is truncated to TF32 there
// (wkv_chunked_ref's round_tf32 / truncate_tf32 do the same on the CPU).
__device__ __forceinline__ uint2 split(float x) {
  const uint32_t hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  return make_uint2(hi, __float_as_uint(x - __uint_as_float(hi)));
}

template <int N>
struct Split {
  uint32_t hi[N], lo[N];
  __device__ __forceinline__ explicit Split(const float (&x)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const uint2 s = split(x[i]);
      hi[i] = s.x;
      lo[i] = s.y;
    }
  }
  // a b fragment stored split by put_split: rows c and c + 4 of a column
  __device__ __forceinline__ explicit Split(uint4 b)
      : hi{b.x, b.y}, lo{b.z, b.w} {}
};

// A B operand (rows k, columns n) kept split in b-fragment order: rows k
// and k + 4 of a k-step share one 16-byte unit [k / 8][k % 4][n] as
// (hi_k, hi_k+4, lo_k, lo_k+4), so a lane's fragment is one load, already
// in the register pairs mma takes
__device__ __forceinline__ void put_split(uint4 (*b)[4][LDQ], int row,
                                          int col, float x) {
  uint32_t* unit = reinterpret_cast<uint32_t*>(&b[row / 8][row % 4][col]);
  const uint2 s = split(x);
  unit[(row / 4) % 2] = s.x;
  unit[2 + (row / 4) % 2] = s.y;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A 16x8 tile += a (16x8) b (8x8) in 3xTF32: hi.hi into `big`, hi.lo and
// lo.hi into accumulators of their own (three short chains of dependent
// products, not one long one), summed small ones first at the end
struct Acc {
  float big[4] = {0.f, 0.f, 0.f, 0.f};
  float s1[4] = {0.f, 0.f, 0.f, 0.f};
  float s2[4] = {0.f, 0.f, 0.f, 0.f};
  __device__ __forceinline__ void add(const Split<4>& a, const Split<2>& b) {
    mma(s1, a.lo, b.hi);
    mma(s2, a.hi, b.lo);
    mma(big, a.hi, b.hi);
  }
  __device__ __forceinline__ float operator[](int i) const {
    return big[i] + (s1[i] + s2[i]);
  }
};

// Cycles a phase, for kernels/wkv/cycles.py: built with -DWKV_PHASE_CYCLES,
// each warp adds up the clock64() cycles between the marks of a chunk and
// writes them to phase_cycles[block][warp][mark]; compiled out otherwise.
#ifdef WKV_PHASE_CYCLES
constexpr int PHASES = 7, MAX_BLOCKS = 4096;
__device__ long long phase_cycles[MAX_BLOCKS * WARPS * PHASES];
#define PHASE_START                         \
  long long phase_sum[PHASES] = {};         \
  long long phase_last = clock64()
#define PHASE_MARK(k)                            \
  do {                                           \
    const long long now_ = clock64();            \
    phase_sum[k] += now_ - phase_last;           \
    phase_last = now_;                           \
  } while (0)
#define PHASE_END                                                     \
  do {                                                                \
    const int blk = blockIdx.y * gridDim.x + blockIdx.x;              \
    if (lane == 0 && blk < MAX_BLOCKS)                                \
      for (int k = 0; k < PHASES; ++k)                                \
        phase_cycles[(blk * WARPS + warp) * PHASES + k] = phase_sum[k]; \
  } while (0)
#else
#define PHASE_START
#define PHASE_MARK(k)
#define PHASE_END
#endif

// mma.m16n8k8 fragments, lane = 4 g + c: a = rows (g, g+8) x columns
// (c, c+4); b = rows (c, c+4) x column g; the accumulator holds rows
// (g, g+8) x columns (2c, 2c+1).

__global__ void __launch_bounds__(THREADS, 1)
wkv_chunk_kernel(const __grid_constant__ CUtensorMap rmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap lmap,
                 const __grid_constant__ CUtensorMap vmap, const WkvArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // aligned to 128 by an offset into the shared array (a pointer rounded
  // as an integer would lose its address space: generic loads, not LDS)
  Smem& sm = *reinterpret_cast<Smem*>(
      smem_raw + ((128u - (smem_addr(smem_raw) & 127u)) & 127u));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int j0 = blockIdx.x * NJ;
  const int S = a.S;
  float* ob = a.out + (int64_t)b * a.out_sb + (int64_t)h * a.out_sh + j0;
  const int64_t sbase = (int64_t)bh * D * D + j0;

  // chunk ci's tiles by TMA, issued by thread 0 and counted on bar[ci & 1];
  // rows past S read as zeros (r = k = v = 0, w = exp(0) = 1)
  auto load_chunk = [&](int ci) {
    const int p = ci & 1;
    const uint32_t bar = smem_addr(&sm.bar[p]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"(CHUNK_BYTES) : "memory");
    tma_load(sm.r[p], &rmap, bar, 0, ci * C, h, b);
    tma_load(sm.k[p], &kmap, bar, 0, ci * C, h, b);
    tma_load(sm.lw, &lmap, bar, 0, ci * C, h, b);
    tma_load(sm.v[p], &vmap, bar, j0, ci * C, h, b);
  };

  if (tid == 0) {
#pragma unroll
    for (int p = 0; p < 2; ++p)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(&sm.bar[p]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // A above the diagonal stays 0. The state: warps 4-7 hold it, in the
  // layout of the state update's accumulators: rows 16 mS + (g, g+8),
  // columns 8 n + (2c, 2c+1) for the 4 column tiles n
  for (int idx = tid; idx < C * LDR; idx += THREADS) (&sm.A[0][0])[idx] = 0.f;
  const bool owner = warp >= 4;
  const int mS = warp % 4;
  float st[NJ / 8][4];
#pragma unroll
  for (int n = 0; n < NJ / 8; ++n) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = 16 * mS + g + 8 * (q / 2);
      const int col = 8 * n + 2 * c + q % 2;
      st[n][q] = owner && a.state_in
                     ? a.state_in[sbase + (int64_t)row * D + col]
                     : 0.f;
      if (owner) put_split(sm.S, row, col, st[n][q]);
    }
  }
  const float u0 = a.u[(int64_t)h * D + lane];
  const float u1 = a.u[(int64_t)h * D + lane + 32];
  __syncthreads();
  if (tid == 0) load_chunk(0);

  // warps 0-3 hold out's tiles: rows 16 mO + (g, g+8), the 4 column tiles
  const int mO = warp % 4;
  const int nchunks = (S + C - 1) / C;
  PHASE_START;
  for (int ci = 0; ci < nchunks; ++ci) {
    const int p = ci & 1;
    float(*const rs)[LDR] = sm.r[p];
    float(*const ks)[LDR] = sm.k[p];
    mbar_wait(smem_addr(&sm.bar[p]), (ci >> 1) & 1);
    __syncthreads();
    PHASE_MARK(0);

    // -- 1. the 8-blocks, one a warp (rows 8 warp ..), columns lane and
    // lane + 32: rL, kL, F and A inside the 8-block. Slot t (t + 1) / 2 + i
    // of x holds A[t][i], i <= t, summed over this lane's two columns.
    {
      const int t0 = 8 * warp;
      float x[40];
#pragma unroll
      for (int i = 0; i < 40; ++i) x[i] = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = lane + 32 * half;
        const float ud = half ? u1 : u0;
        float rr[8], kk[8], w[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          rr[t] = rs[t0 + t][d];
          kk[t] = ks[t0 + t][d];
          w[t] = expf(sm.lw[t0 + t][d]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          x[i * (i + 1) / 2 + i] += rr[i] * ud * kk[i];  // the bonus
          float xk = kk[i];  // k_i W(i, t)
#pragma unroll
          for (int t = i + 1; t < 8; ++t) {
            x[t * (t + 1) / 2 + i] += rr[t] * xk;
            xk *= w[t];
          }
        }
        float pre = 1.f, suf = 1.f;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          rs[t0 + t][d] = rr[t] * pre;  // rL
          pre *= w[t];
        }
#pragma unroll
        for (int t = 7; t >= 0; --t) {
          ks[t0 + t][d] = kk[t] * suf;  // kL
          suf *= w[t];
        }
        sm.F[warp][d] = pre;
      }
      // reduce-scatter over the warp: halve the slots a lane keeps at
      // xor 16, 8 and 4 (40 -> 5), then sum the 5 over xor 2 and 1
#pragma unroll
      for (int i = 0; i < 20; ++i) {
        const bool up = lane & 16;
        const float keep = up ? x[i + 20] : x[i];
        x[i] = keep + __shfl_xor_sync(0xffffffffu, up ? x[i] : x[i + 20], 16);
      }
#pragma unroll
      for (int i = 0; i < 10; ++i) {
        const bool up = lane & 8;
        const float keep = up ? x[i + 10] : x[i];
        x[i] = keep + __shfl_xor_sync(0xffffffffu, up ? x[i] : x[i + 10], 8);
      }
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const bool up = lane & 4;
        const float keep = up ? x[i + 5] : x[i];
        x[i] = keep + __shfl_xor_sync(0xffffffffu, up ? x[i] : x[i + 5], 4);
      }
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        x[i] += __shfl_xor_sync(0xffffffffu, x[i], 2);
        x[i] += __shfl_xor_sync(0xffffffffu, x[i], 1);
      }
      // the four lanes of a group hold the same five sums: lane e of the
      // group writes slot e, lane 0 also slot 4
      const int base = (lane & 16 ? 20 : 0) + (lane & 8 ? 10 : 0) +
                       (lane & 4 ? 5 : 0);
#pragma unroll
      for (int e = 0; e < 5; ++e) {
        const int slot = base + e;
        if ((lane & 3) == e % 4 && slot < 36) {
          const int t = (slot >= 1) + (slot >= 3) + (slot >= 6) +
                        (slot >= 10) + (slot >= 15) + (slot >= 21) +
                        (slot >= 28);
          sm.A[t0 + t][t0 + slot - t * (t + 1) / 2] = x[e];
        }
      }
    }
    __syncthreads();
    PHASE_MARK(1);

    // -- 2. the tables of whole 8-blocks' W, a column and one of four
    // tables a thread; v split into (hi, lo), eight values a thread
    {
      const int d = tid % D, role = tid / D;
      float f[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) f[q] = sm.F[q][d];
      if (role == 0) {
        float pre = 1.f;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          sm.RS[q][d] = pre;
          pre *= f[q];
        }
        sm.Ftot[d] = pre;
      } else if (role == 1) {
        float suf = 1.f;
#pragma unroll
        for (int q = NQ - 1; q >= 0; --q) {
          sm.KS[q][d] = suf;
          suf *= f[q];
        }
      } else {
        // KF: role 2 takes 16-block m = 1 and q < 3 of m = 3, role 3 the
        // rest
#pragma unroll
        for (int m = 1; m < C / 16; ++m) {
#pragma unroll
          for (int q = 0; q < 2 * m; ++q) {
            const int owner = m == 1 ? 2 : m == 2 ? 3 : (q < 3 ? 2 : 3);
            if (role != owner) continue;
            float fac = 1.f;
#pragma unroll
            for (int q2 = q + 1; q2 < 2 * m; ++q2) fac *= f[q2];
            sm.KF[m * (m - 1) + q][d] = fac;
          }
        }
      }
      // v split: a thread fills whole units (rows 8 ks + c and + 4)
#pragma unroll
      for (int e = 0; e < C * NJ / (2 * THREADS); ++e) {
        const int idx = tid + THREADS * e, j = idx % NJ, unit = idx / NJ;
        const int row = 8 * (unit / 4) + unit % 4;
        const uint2 lo4 = split(sm.v[p][row][j]);
        const uint2 hi4 = split(sm.v[p][row + 4][j]);
        sm.vs[unit / 4][unit % 4][j] = make_uint4(lo4.x, hi4.x, lo4.y, hi4.y);
      }
    }
    // the next chunk loads while this one's products run: lw has been read,
    // and the other r, k, v buffers since the last chunk's first barrier;
    // the threads' accesses to them are ordered before the TMA's writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0 && ci + 1 < nchunks) load_chunk(ci + 1);
    PHASE_MARK(2);

    // -- 3. the products that do not need A, balanced over the warps.
    // (a) A between blocks, 16 tiles of 8 k-steps (d), two a warp.
    // Warps 0-5: rows of 16-block m against the 8-blocks q0, q0 + 1 of an
    // earlier 16-block, ref = the start of m: rows (r W[ref, t)) = rL, times
    // F[2m] in m's second 8-block; columns kL * KF[m][q].
    // Warps 6, 7: in 16-blocks m = 2 (warp - 6) + e, the second 8-block's
    // rows against the first's columns, ref = the second's start: rL and
    // kL as they are (the mma's rows 8-15 are zero).
    if (warp < 6) {
      const int m = warp < 1 ? 1 : warp < 3 ? 2 : 3;
      const int q0 = 2 * warp - m * (m - 1);  // KF index 2 warp
      Acc acc[2];
#pragma unroll
      for (int kstep = 0; kstep < D / 8; ++kstep) {
        const int d0 = 8 * kstep + c, d1 = d0 + 4;
        const float af[4] = {rs[16 * m + g][d0],
                             rs[16 * m + 8 + g][d0] * sm.F[2 * m][d0],
                             rs[16 * m + g][d1],
                             rs[16 * m + 8 + g][d1] * sm.F[2 * m][d1]};
        const Split<4> as(af);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = q0 + e, kf = m * (m - 1) + q;
          const float bf[2] = {ks[8 * q + g][d0] * sm.KF[kf][d0],
                               ks[8 * q + g][d1] * sm.KF[kf][d1]};
          acc[e].add(as, Split<2>(bf));
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * (q0 + e) + 2 * c;
        sm.A[16 * m + g][col] = acc[e][0];
        sm.A[16 * m + g][col + 1] = acc[e][1];
        sm.A[16 * m + 8 + g][col] = acc[e][2];
        sm.A[16 * m + 8 + g][col + 1] = acc[e][3];
      }
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 2 * (warp - 6) + e;
        Acc acc;
#pragma unroll
        for (int kstep = 0; kstep < D / 8; ++kstep) {
          const int d0 = 8 * kstep + c, d1 = d0 + 4;
          const float af[4] = {rs[16 * m + 8 + g][d0], 0.f,
                               rs[16 * m + 8 + g][d1], 0.f};
          const float bf[2] = {ks[16 * m + g][d0], ks[16 * m + g][d1]};
          acc.add(Split<4>(af), Split<2>(bf));
        }
        sm.A[16 * m + 8 + g][16 * m + 2 * c] = acc[0];
        sm.A[16 * m + 8 + g][16 * m + 2 * c + 1] = acc[1];
      }
    }

    PHASE_MARK(3);

    // (b) warps 0-3, out's tiles from S0: (rL * RS) S0 over d.
    // (c) warps 4-7, the state: S = Ftot S + (kL * KS)^T V, the product
    // from zero. Each split a fragment serves the 4 column tiles.
    float out[NJ / 8][4];
    {
      Acc acc[NJ / 8];
      if (!owner) {
#pragma unroll
        for (int kstep = 0; kstep < D / 8; ++kstep) {
          const int d0 = 8 * kstep + c, d1 = d0 + 4;
          const float af[4] = {
              rs[16 * mO + g][d0] * sm.RS[2 * mO][d0],
              rs[16 * mO + 8 + g][d0] * sm.RS[2 * mO + 1][d0],
              rs[16 * mO + g][d1] * sm.RS[2 * mO][d1],
              rs[16 * mO + 8 + g][d1] * sm.RS[2 * mO + 1][d1]};
          const Split<4> as(af);
#pragma unroll
          for (int n = 0; n < NJ / 8; ++n)
            acc[n].add(as, Split<2>(sm.S[kstep][c][8 * n + g]));
        }
#pragma unroll
        for (int n = 0; n < NJ / 8; ++n) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            out[n][q] = acc[n][q];
            if (n >= 2) sm.X[mO][4 * (n - 2) + q][lane] = out[n][q];
          }
        }
      } else {
        const int i0 = 16 * mS + g, i1 = i0 + 8;
#pragma unroll
        for (int kstep = 0; kstep < C / 8; ++kstep) {
          const int t0 = 8 * kstep + c, t1 = t0 + 4;
          const float f0 = sm.KS[kstep][i0], f1 = sm.KS[kstep][i1];
          const float af[4] = {ks[t0][i0] * f0, ks[t0][i1] * f1,
                               ks[t1][i0] * f0, ks[t1][i1] * f1};
          const Split<4> as(af);
#pragma unroll
          for (int n = 0; n < NJ / 8; ++n)
            acc[n].add(as, Split<2>(sm.vs[kstep][c][8 * n + g]));
        }
        const float f0 = sm.Ftot[i0], f1 = sm.Ftot[i1];
#pragma unroll
        for (int n = 0; n < NJ / 8; ++n) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            st[n][q] = fmaf(q < 2 ? f0 : f1, st[n][q], acc[n][q]);
        }
      }
    }
    PHASE_MARK(4);
    // A is whole, and every read of S0 is done
    __syncthreads();
    PHASE_MARK(5);

    // -- 4. out's tiles from A, A V over i up to the tiles' last row, added
    // to those from S0 and stored: warp w < 4 takes column tiles 0, 1 of
    // 16-block w, warp w + 4 (on the same sub-partition) tiles 2, 3 of
    // 16-block 3 - w, so that each sub-partition has 10 of the 40 k-steps.
    // Warps 4-7 also split the new state into S.
    {
      const int m = owner ? 7 - warp : warp, n0 = owner ? 2 : 0;
      Acc acc[2];
      for (int k2 = 0; k2 < m + 1; ++k2) {  // two k-steps an iteration
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i0 = 16 * k2 + 8 * e + c, i1 = i0 + 4;
          const float af[4] = {sm.A[16 * m + g][i0], sm.A[16 * m + 8 + g][i0],
                               sm.A[16 * m + g][i1],
                               sm.A[16 * m + 8 + g][i1]};
          const Split<4> as(af);
#pragma unroll
          for (int n = 0; n < 2; ++n)
            acc[n].add(as, Split<2>(sm.vs[2 * k2 + e][c][8 * (n0 + n) + g]));
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int hrow = 0; hrow < 2; ++hrow) {
          const int t = ci * C + 16 * m + g + 8 * hrow;
          float part[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            part[e] = owner ? sm.X[m][4 * n + 2 * hrow + e][lane]
                            : out[n][2 * hrow + e];
          if (t < S)
            *reinterpret_cast<float2*>(ob + (int64_t)t * a.out_ss +
                                       8 * (n0 + n) + 2 * c) =
                make_float2(part[0] + acc[n][2 * hrow],
                            part[1] + acc[n][2 * hrow + 1]);
        }
      }
      if (owner) {
#pragma unroll
        for (int n = 0; n < NJ / 8; ++n) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            put_split(sm.S, 16 * mS + g + 8 * (q / 2), 8 * n + 2 * c + q % 2,
                      st[n][q]);
        }
      }
    }
    PHASE_MARK(6);
  }
  PHASE_END;

  if (owner) {
#pragma unroll
    for (int n = 0; n < NJ / 8; ++n) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = 16 * mS + g + 8 * (q / 2);
        const int col = 8 * n + 2 * c + q % 2;
        a.state_out[sbase + (int64_t)row * D + col] = st[n][q];
      }
    }
  }
}

}  // namespace chunk

// 3. The backward (`back::wkv_backward_kernel`, D = 16 or 64, any S >= 1,
// no initial state): dr, dk, dv, dlw and du of out for a cotangent dout,
// with no gradient arriving on the final state. With w_t = exp(lw_t) and
// G_t = dL/dS_t, carried backward from G_{S-1} = 0:
//   G_{t-1}  = diag(w_t) G_t + r_t dout_t^T
//   dr_t[i]  = sum_j S_{t-1}[i,j] dout_t[j] + u_i k_t[i] (v_t . dout_t)
//   dk_t[i]  = sum_j G_t[i,j] v_t[j]        + u_i r_t[i] (v_t . dout_t)
//   dv_t[j]  = sum_i k_t[i] G_t[i,j]        + (r_t . diag(u) k_t) dout_t[j]
//   dlw_t[i] = w_t[i] sum_j S_{t-1}[i,j] G_t[i,j]
//   du[i]    = sum_t r_t[i] k_t[i] (v_t . dout_t)      (per (b, h) here)
// S_{t-1} and G_t run in opposite directions, and S_{t-1} is never
// reconstructed from S_t (w_t reaches ~2e-9 under strong decay). Rows of S
// are independent in the forward (row i decays by w_t[i] alone), so a block
// owns R rows of a head and all D columns and recomputes its rows' states
// itself: pass 1 runs the recurrence forward and writes the state entering
// each segment of T tokens to a scratch buffer (B*H*ceil(S/T)*D*D floats,
// each thread its own elements, read back by the same thread); pass 2 takes
// the segments last to first, recomputes the segment's S_{t-1} from its
// saved state into shared memory, then runs the reverse recurrence over it.
// A thread owns NR rows x D/LPR columns (LPR = min(D, 32) lanes a row), so
// the sums over j (dr, dk, dlw) close within the warp by xor shuffles in a
// fixed order; dv's sum over i closes over the block's warps in shared
// memory, and over the D/R blocks of a head in the wrapper (dv is written
// as a partial sum per block of rows); du is written per (b, h) and summed
// over b in the wrapper. No atomics: two runs give the same bits.
namespace back {

constexpr int T = 16;  // tokens a segment

template <int D, int NR, int WARPS>
struct Layout {
  static constexpr int LPR = D < 32 ? D : 32;  // lanes a row
  static constexpr int M = D / LPR;            // columns a thread
  static constexpr int GPW = 32 / LPR;         // lane groups a warp
  static constexpr int RPW = GPW * NR;         // rows a warp
  static constexpr int R = WARPS * RPW;        // rows a block
  static constexpr int RG = D / R;             // blocks a head
  static constexpr int E = NR * M;             // elements a thread
  static constexpr int THREADS = 32 * WARPS;
  // shared memory, in floats: the history S_{t-1} [T][E][THREADS]; r, k, w
  // [T][R]; v, dout [T][D]; v . dout and r . diag(u) k [T]; the row sums
  // of dr, dk, dlw [T][R]; dv's partial sums by warp [T][WARPS][D]
  static constexpr int HIST = T * E * THREADS;
  static constexpr int FLOATS =
      HIST + 3 * T * R + 2 * T * D + 2 * T + 3 * T * R + T * WARPS * D;
  static constexpr size_t SMEM = sizeof(float) * FLOATS;
  static_assert(D % LPR == 0 && 32 % LPR == 0 && D % R == 0, "shape");
};

template <int D, int NR, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
wkv_backward_kernel(const WkvBackArgs a) {
  using L = Layout<D, NR, WARPS>;
  constexpr int LPR = L::LPR, M = L::M, R = L::R, E = L::E;
  constexpr int THREADS = L::THREADS;
  extern __shared__ float smem[];
  float* hist = smem;
  float* r_s = hist + L::HIST;
  float* k_s = r_s + T * R;
  float* w_s = k_s + T * R;
  float* v_s = w_s + T * R;
  float* do_s = v_s + T * D;
  float* vd_s = do_s + T * D;
  float* c_s = vd_s + T;
  float* dr_s = c_s + T;
  float* dk_s = dr_s + T * R;
  float* dw_s = dk_s + T * R;
  float* dv_s = dw_s + T * R;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int lc = lane % LPR;  // column of the thread's first element
  const int rg = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int i0 = rg * R;                                // the block's rows
  const int row0 = warp * L::RPW + (lane / LPR) * NR;  // the thread's, local
  const int S = a.S;
  const int nseg = (S + T - 1) / T;
  const int64_t in_base = (int64_t)b * a.in_sb + (int64_t)h * a.in_sh;
  const float* rb = a.r + in_base;
  const float* kb = a.k + in_base;
  const float* vb = a.v + in_base;
  const float* lb = a.lw + in_base;
  const int64_t out_base = (int64_t)bh * S * D;  // (B, H, S, D) contiguous
  const float* dob = a.dout + out_base;
  float* saved = a.states + ((int64_t)bh * L::RG + rg) * nseg * (E * THREADS);

  // a segment's operands into shared memory: k, w (and r) of the block's
  // rows, v (and dout) of every column; with `all`, also v . dout and
  // r . diag(u) k over all D rows, one warp a token, summed in a fixed order
  auto stage = [&](int t0, int n, bool all) {
    for (int idx = tid; idx < n * R; idx += THREADS) {
      const int tt = idx / R, rr = idx % R;
      const int64_t off = (int64_t)(t0 + tt) * a.in_ss + i0 + rr;
      k_s[tt * R + rr] = kb[off];
      w_s[tt * R + rr] = expf(lb[off]);
      if (all) r_s[tt * R + rr] = rb[off];
    }
    for (int idx = tid; idx < n * D; idx += THREADS) {
      const int tt = idx / D, j = idx % D;
      v_s[tt * D + j] = vb[(int64_t)(t0 + tt) * a.in_ss + j];
      if (all) do_s[tt * D + j] = dob[(int64_t)(t0 + tt) * D + j];
    }
    if (!all) return;
    for (int tt = warp; tt < n; tt += WARPS) {
      const int64_t off = (int64_t)(t0 + tt) * a.in_ss;
      float vd = 0.f, c = 0.f;
      for (int j = lane; j < D; j += 32) {
        vd = fmaf(vb[off + j], dob[(int64_t)(t0 + tt) * D + j], vd);
        c = fmaf(rb[off + j] * a.u[(int64_t)h * D + j], kb[off + j], c);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        vd += __shfl_xor_sync(0xffffffffu, vd, o);
        c += __shfl_xor_sync(0xffffffffu, c, o);
      }
      if (lane == 0) {
        vd_s[tt] = vd;
        c_s[tt] = c;
      }
    }
  };

  // pass 1: the states entering each segment, the recurrence run forward
  float st[E];
#pragma unroll
  for (int e = 0; e < E; ++e) st[e] = 0.f;
  for (int seg = 0; seg < nseg; ++seg) {
    const int t0 = seg * T, n = min(T, S - t0);
#pragma unroll
    for (int e = 0; e < E; ++e)
      saved[(int64_t)(seg * E + e) * THREADS + tid] = st[e];
    if (seg == nseg - 1) break;  // the last segment's steps are not needed
    stage(t0, n, false);
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
#pragma unroll
      for (int q = 0; q < NR; ++q) {
        const float w = w_s[tt * R + row0 + q], kk = k_s[tt * R + row0 + q];
#pragma unroll
        for (int m = 0; m < M; ++m) {
          float& s = st[q * M + m];
          s = fmaf(w, s, kk * v_s[tt * D + lc + LPR * m]);
        }
      }
    }
    __syncthreads();
  }

  // pass 2: the segments last to first
  float g[E];
#pragma unroll
  for (int e = 0; e < E; ++e) g[e] = 0.f;
  float du = 0.f;  // thread tid < R: row i0 + tid
  for (int seg = nseg - 1; seg >= 0; --seg) {
    const int t0 = seg * T, n = min(T, S - t0);
    stage(t0, n, true);
#pragma unroll
    for (int e = 0; e < E; ++e)
      st[e] = saved[(int64_t)(seg * E + e) * THREADS + tid];
    __syncthreads();
    // S_{t-1} of the segment's tokens, each thread its own elements
    for (int tt = 0; tt < n; ++tt) {
#pragma unroll
      for (int q = 0; q < NR; ++q) {
        const float w = w_s[tt * R + row0 + q], kk = k_s[tt * R + row0 + q];
#pragma unroll
        for (int m = 0; m < M; ++m) {
          float& s = st[q * M + m];
          hist[(tt * E + q * M + m) * THREADS + tid] = s;
          s = fmaf(w, s, kk * v_s[tt * D + lc + LPR * m]);
        }
      }
    }
    // the reverse recurrence; g holds G_t on entry to step t
    for (int tt = n - 1; tt >= 0; --tt) {
      float vj[M], dj[M], dv[M];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        vj[m] = v_s[tt * D + lc + LPR * m];
        dj[m] = do_s[tt * D + lc + LPR * m];
        dv[m] = 0.f;
      }
      float pr[NR], pk[NR], pw[NR];
#pragma unroll
      for (int q = 0; q < NR; ++q) {
        const int lr = row0 + q;
        const float rr = r_s[tt * R + lr], kk = k_s[tt * R + lr],
                    w = w_s[tt * R + lr];
        pr[q] = pk[q] = pw[q] = 0.f;
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const int e = q * M + m;
          const float sp = hist[(tt * E + e) * THREADS + tid];
          pr[q] = fmaf(sp, dj[m], pr[q]);
          pk[q] = fmaf(g[e], vj[m], pk[q]);
          pw[q] = fmaf(sp, g[e], pw[q]);
          dv[m] = fmaf(kk, g[e], dv[m]);
          g[e] = fmaf(w, g[e], rr * dj[m]);
        }
      }
      // the sums over j: the LPR lanes of a row, in a fixed order
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int q = 0; q < NR; ++q) {
          pr[q] += __shfl_xor_sync(0xffffffffu, pr[q], o);
          pk[q] += __shfl_xor_sync(0xffffffffu, pk[q], o);
          pw[q] += __shfl_xor_sync(0xffffffffu, pw[q], o);
        }
      }
      if (lc == 0) {
#pragma unroll
        for (int q = 0; q < NR; ++q) {
          dr_s[tt * R + row0 + q] = pr[q];
          dk_s[tt * R + row0 + q] = pk[q];
          dw_s[tt * R + row0 + q] = pw[q];
        }
      }
      // dv over the warp's rows: its lane groups, then by warp below
#pragma unroll
      for (int o = 16; o >= LPR; o >>= 1) {
#pragma unroll
        for (int m = 0; m < M; ++m)
          dv[m] += __shfl_xor_sync(0xffffffffu, dv[m], o);
      }
      if (lane < LPR) {
#pragma unroll
        for (int m = 0; m < M; ++m)
          dv_s[(tt * WARPS + warp) * D + lc + LPR * m] = dv[m];
      }
    }
    __syncthreads();
    // the segment's gradients, bonus terms added
    for (int idx = tid; idx < n * R; idx += THREADS) {
      const int tt = idx / R, rr = idx % R;
      const int i = i0 + rr;
      const float uu = a.u[(int64_t)h * D + i], vd = vd_s[tt];
      const int64_t off = out_base + (int64_t)(t0 + tt) * D + i;
      a.dr[off] = fmaf(uu * k_s[tt * R + rr], vd, dr_s[tt * R + rr]);
      a.dk[off] = fmaf(uu * r_s[tt * R + rr], vd, dk_s[tt * R + rr]);
      a.dlw[off] = w_s[tt * R + rr] * dw_s[tt * R + rr];
    }
    float* dvb = a.dv + (int64_t)rg * a.B * a.H * S * D + out_base;
    for (int idx = tid; idx < n * D; idx += THREADS) {
      const int tt = idx / D, j = idx % D;
      float s = rg == 0 ? c_s[tt] * do_s[tt * D + j] : 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += dv_s[(tt * WARPS + w) * D + j];
      dvb[(int64_t)(t0 + tt) * D + j] = s;
    }
    if (tid < R) {
      for (int tt = n - 1; tt >= 0; --tt)
        du = fmaf(r_s[tt * R + tid] * k_s[tt * R + tid], vd_s[tt], du);
    }
    __syncthreads();  // before the next segment's staging
  }
  if (tid < R) a.du[(int64_t)bh * D + i0 + tid] = du;
}

// a block a group of R rows of a head's state
template <int D, int NR, int WARPS>
Plan plan(int B, int H) {
  using L = Layout<D, NR, WARPS>;
  return Plan{dim3(L::RG, B * H), dim3(L::THREADS), (unsigned)L::SMEM, 0};
}

template <int D, int NR, int WARPS>
cudaError_t launch(const WkvBackArgs& a, cudaStream_t stream) {
  const Plan p = plan<D, NR, WARPS>(a.B, a.H);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv_backward_kernel<D, NR, WARPS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  wkv_backward_kernel<D, NR, WARPS><<<p.grid, p.block, p.smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace back

// 4. The chunked backward (`cback::wkv_carry_kernel`, then
// `cback::wkv_chunk_backward_kernel`; D = 64, S >= 64 by kernel_for's rule,
// any S >= 1 works; no initial state, no gradient on the final state). The
// same function as 3, in chunks of C = 64 tokens on the tensor cores, with
// the forward chunked kernel's algebra and its exponent rule: every decay
// is a product of w = exp(lw) <= 1 over a forward range of the chunk's
// tokens, W[a, b) over a..b-1 and W(a, b) over a+1..b-1; no exp(-cum) is
// formed, so strong decay underflows to 0 and never overflows.
// Two D x D matrices cross chunks, and only they: the state S0 entering
// chunk c and G = dL/dS at its last token. The carry kernel forms both, one
// block per (b h, direction), each walking the chunks in order (S0' =
// diag(W[0,64)) S0 + (k W(., 64))^T V forward from 0; G' = diag(W[0,64)) G
// + (r W[0, .))^T dOut backward from 0) and writing the matrix entering
// each chunk to scratch (2 x B*H*ceil(S/64)*D*D floats): the two
// directions run side by side, 2 blocks a head, one an SM. Its time is the
// loads': chunks c+1 and c+2's r or k, lw and v or dout arrive by cp.async
// while chunk c's product runs.
// Then one block per (chunk, b h), 2,048 at the training shape, forms the
// chunk's gradients from S0, G and its r, k, v, lw, dout, all in shared
// memory (row stride 68: conflict-free fragments either way round): with
// B[t, i] = dout_t . v_i and the forward's A (bonus on its diagonal),
//   dv   = A^T dOut + (k W(., 64)) G
//   dr_t = W[0, t) (S0 dout_t) + sum_{i<t} B[t, i] k_i W(i, t) + u k_t vd_t
//   dk_t = W(t, 64) (G v_t) + sum_{tau>t} B[tau, t] r_tau W(t, tau)
//          + u r_t vd_t
// Pairs of tokens in different 16-blocks factor through a reference token
// as A's do in the forward: for dr through the start of t's 16-block (k
// scaled by W(i, ref), the result by W[ref, t)), for dk through the end of
// t's 16-block (r scaled by W[ref, tau), the result by W(t, ref)); pairs
// inside a 16-block take running products of w, element by element. dlw
// needs no product of its own: with a_t = r_t (dr_t less its bonus) and
// b_t = k_t (dk_t less its bonus), dlw_t = w_t rowsum(S_{t-1} G_t) is
//   dlw_t = rowsum(S_end G) + sum_{tau>t} a_tau - sum_{i>=t} b_i
// over the chunk's tokens: what cancels stays within one chunk, where the
// terms have their own reference, not over the whole sequence. du is a
// partial sum per (b h, chunk), added over b and the chunks in the
// wrapper. Products in 3xTF32 as the forward's (mma.sync m16n8k8, hi.hi
// apart from hi.lo and lo.hi); the plain version of this arithmetic is
// kernels/wkv/ref.py `wkv_chunked_backward_ref`. No atomics: every sum has
// one owner and a fixed order, so two runs give the same bits.
// Bound: the gradient's 14 D^2 + 13 D operations a token of a head at the
// f32 rate, 0.114 ms at (2, 32, 2048, 64) (bytes 0.090). What the design
// does about it: the sequential kernel's serial chain over 2,048 tokens
// becomes 32 chunks of matrix products, 2,048 blocks in parallel, the
// products on the tensor cores; only the carry is serial, a product a
// chunk. Each parallel block needs 203 KB of shared memory, so one block
// an SM, whose loads wait on nothing else.
namespace cback {

using chunk::Acc;
using chunk::C;
using chunk::D;
using chunk::LDR;
using chunk::NKF;
using chunk::NQ;
using chunk::smem_addr;
using chunk::Split;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

__device__ __forceinline__ void cp16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_one() {  // all but the last group
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// acc[n] += a (16 rows x [k0, k1)) b ([k0, k1) x 8 NT columns), 3xTF32:
// fa(row, k) and fb(k, col) read the operands (the fragments' layouts as in
// `chunk`); k1 - k0 a multiple of 8
template <int NT, class FA, class FB>
__device__ __forceinline__ void tile(Acc (&acc)[NT], int k0, int k1,
                                     const FA& fa, const FB& fb) {
  const int lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
#pragma unroll 2
  for (int kk = k0; kk < k1; kk += 8) {
    const int c0 = kk + c, c1 = c0 + 4;
    const float af[4] = {fa(g, c0), fa(g + 8, c0), fa(g, c1), fa(g + 8, c1)};
    const Split<4> as(af);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float bf[2] = {fb(c0, 8 * n + g), fb(c1, 8 * n + g)};
      acc[n].add(as, Split<2>(bf));
    }
  }
}

// --- the carry ---------------------------------------------------------
constexpr int NBUF = 3;  // chunks in flight: this one and the next two
struct CarrySmem {
  float x[NBUF][C][LDR];   // k (S) or r (G), then scaled by its decays
  float lw[NBUF][C][LDR];
  float y[NBUF][C][LDR];   // v (S) or dout (G)
  float segp[4][D];        // W over each 16 tokens
  float ftot[D];           // W over the chunk
};
constexpr size_t CARRY_SMEM = sizeof(CarrySmem) + 128;
static_assert(CARRY_SMEM <= 227 * 1024, "shared memory");

__global__ void __launch_bounds__(THREADS, 1)
wkv_carry_kernel(const WkvBackArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  CarrySmem& sm = *reinterpret_cast<CarrySmem*>(
      smem_raw + ((128u - (smem_addr(smem_raw) & 127u)) & 127u));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const bool grad = blockIdx.y == 1;  // G backward; else S0 forward
  const int S = a.S, nc = (S + C - 1) / C;
  const int64_t in_base = (int64_t)b * a.in_sb + (int64_t)h * a.in_sh;
  const float* xb = (grad ? a.r : a.k) + in_base;
  const float* lb = a.lw + in_base;
  // v in the inputs' strides, dout contiguous (B, H, S, D)
  const float* yb = grad ? a.dout + (int64_t)bh * S * D : a.v + in_base;
  const int64_t y_ss = grad ? D : a.in_ss;
  float* out = a.states + (grad ? (int64_t)a.B * a.H * nc * D * D : 0) +
               (int64_t)bh * nc * D * D;

  auto issue = [&](int ci) {
    const int p = ci % NBUF, t0 = (grad ? nc - 1 - ci : ci) * C;
    for (int idx = tid; idx < C * D / 4; idx += THREADS) {
      const int row = idx / (D / 4), col = 4 * (idx % (D / 4));
      const bool live = t0 + row < S;
      const int64_t off = live ? (int64_t)(t0 + row) * a.in_ss + col : 0;
      cp16(&sm.x[p][row][col], xb + off, live);
      cp16(&sm.lw[p][row][col], lb + off, live);
      cp16(&sm.y[p][row][col],
           yb + (live ? (int64_t)(t0 + row) * y_ss + col : 0), live);
    }
    cp_commit();
  };

  // the carried matrix: rows 16 mS + (g, g+8), columns 32 nh + 8 n +
  // (2c, 2c+1)
  const int mS = warp % 4, nh = warp / 4;
  float st[4][4] = {};
  issue(0);
  if (nc > 1) issue(1);
  for (int ci = 0; ci < nc; ++ci) {
    const int p = ci % NBUF, cidx = grad ? nc - 1 - ci : ci;
    if (ci + 1 < nc)
      cp_wait_one();  // chunk ci's group, not ci + 1's
    else
      cp_wait_all();
    __syncthreads();
    if (ci + 2 < nc) issue(ci + 2);  // into chunk ci - 1's buffer
    // the matrix entering chunk cidx (S0), or at its last token (G)
    float* o = out + (int64_t)cidx * D * D;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = 16 * mS + g + 8 * hr, col = 32 * nh + 8 * n + 2 * c;
        *reinterpret_cast<float2*>(o + (int64_t)row * D + col) =
            make_float2(st[n][2 * hr], st[n][2 * hr + 1]);
      }
    }
    if (ci + 1 == nc) break;
    // decays: thread (sg, d) takes 16 tokens of column d; W(t, 64) for S,
    // W[0, t) for G, running products from the 16-blocks' products
    {
      const int sg = tid / D, d = tid % D;
      float w[16], prod = 1.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        w[i] = expf(sm.lw[p][16 * sg + i][d]);
        prod *= w[i];
      }
      sm.segp[sg][d] = prod;
      __syncthreads();
      float x = 1.f;
      if (grad) {
        for (int q = 0; q < sg; ++q) x *= sm.segp[q][d];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          sm.x[p][16 * sg + i][d] *= x;
          x *= w[i];
        }
      } else {
        for (int q = 3; q > sg; --q) x *= sm.segp[q][d];
#pragma unroll
        for (int i = 15; i >= 0; --i) {
          sm.x[p][16 * sg + i][d] *= x;
          x *= w[i];
        }
      }
      if (sg == 0)
        sm.ftot[d] = sm.segp[0][d] * sm.segp[1][d] * sm.segp[2][d] *
                     sm.segp[3][d];
    }
    __syncthreads();
    Acc acc[4];
    tile<4>(
        acc, 0, C, [&](int row, int k) { return sm.x[p][k][16 * mS + row]; },
        [&](int k, int col) { return sm.y[p][k][32 * nh + col]; });
    const float f0 = sm.ftot[16 * mS + g], f1 = sm.ftot[16 * mS + g + 8];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        st[n][q] = fmaf(q < 2 ? f0 : f1, st[n][q], acc[n][q]);
    }
  }
}

// --- the chunk's gradients -----------------------------------------------
struct BackSmem {
  float r[C][LDR], k[C][LDR], v[C][LDR], dout[C][LDR];
  float w[C][LDR];   // lw, then w = exp(lw)
  float P[C][LDR];   // W[start of t's 8-block, t); then dk's products
  float Q[C][LDR];   // W(t, end of t's 8-block]
  float S0[D][LDR];  // the state entering the chunk [key row][value
                     // column]; then dr's products
  float G[D][LDR];   // dL/dS at the chunk's last token
  float A[C][LDR];   // the forward's A, bonus on the diagonal, 0 above
  float B[C][LDR];   // dout_t . v_i for i's 16-block <= t's
  float F[NQ][D];    // W over 8-block q
  float RS[NQ][D];   // W over the 8-blocks before q
  float KS[NQ][D];   // W over the 8-blocks after q
  float KF[NKF][D];  // [m (m-1) + q], q < 2m: W over 8-blocks q+1 .. 2m-1
  float RF[NKF][D];  // rf(a, q), q >= 2a+2: W over 8-blocks 2a+2 .. q-1
  float u[D], vd[C], edge[D];
  float scan[4][2][D];  // each 16 tokens' sums of a and b
  float dus[4][D];      // each 16 tokens' share of du
};
constexpr size_t BACK_SMEM = sizeof(BackSmem) + 128;
static_assert(BACK_SMEM <= 227 * 1024, "shared memory");

// Cycles a phase of the chunk backward, as `chunk`'s PHASE_ marks: built
// with -DWKV_PHASE_CYCLES, each warp's clock64() cycles between marks go to
// back_cycles[block][warp][mark] for the first BACK_BLOCKS blocks.
#ifdef WKV_PHASE_CYCLES
constexpr int BACK_PHASES = 10, BACK_BLOCKS = 512;
__device__ long long back_cycles[BACK_BLOCKS * WARPS * BACK_PHASES];
#define BACK_START                        \
  long long back_sum[BACK_PHASES] = {};   \
  long long back_last = clock64()
#define BACK_MARK(k)                           \
  do {                                         \
    const long long now_ = clock64();          \
    back_sum[k] += now_ - back_last;           \
    back_last = now_;                          \
  } while (0)
#define BACK_END                                                          \
  do {                                                                    \
    const int blk = blockIdx.y * gridDim.x + blockIdx.x;                  \
    if (lane == 0 && blk < BACK_BLOCKS)                                   \
      for (int k = 0; k < BACK_PHASES; ++k)                               \
        back_cycles[(blk * WARPS + warp) * BACK_PHASES + k] = back_sum[k]; \
  } while (0)
#else
#define BACK_START
#define BACK_MARK(k)
#define BACK_END
#endif

__device__ __forceinline__ int rf(int a, int q) {
  return (a == 0 ? 0 : a == 1 ? 6 : 10) + q - 2 * a - 2;
}

__global__ void __launch_bounds__(THREADS, 1)
wkv_chunk_backward_kernel(const WkvBackArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BackSmem& sm = *reinterpret_cast<BackSmem*>(
      smem_raw + ((128u - (smem_addr(smem_raw) & 127u)) & 127u));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int ci = blockIdx.x, bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int S = a.S, nc = (S + C - 1) / C, t0 = ci * C;
  const int64_t in_base = (int64_t)b * a.in_sb + (int64_t)h * a.in_sh;
  const int64_t out_base = (int64_t)bh * S * D;  // (B, H, S, D) contiguous
  const float* states = a.states + ((int64_t)bh * nc + ci) * D * D;
  const float* grads = states + (int64_t)a.B * a.H * nc * D * D;

  BACK_START;
  // -- 0. the chunk's operands (rows past S read as zeros: r = k = v =
  // dout = 0, lw = 0), S0 and G
  // in two groups: r, k, lw, which step 1 (a) reads, then the rest, which
  // lands while (a) runs
  for (int idx = tid; idx < C * D / 4; idx += THREADS) {
    const int row = idx / (D / 4), col = 4 * (idx % (D / 4));
    const bool live = t0 + row < S;
    const int64_t off = live ? (int64_t)(t0 + row) * a.in_ss + col : 0;
    cp16(&sm.r[row][col], a.r + in_base + off, live);
    cp16(&sm.k[row][col], a.k + in_base + off, live);
    cp16(&sm.w[row][col], a.lw + in_base + off, live);
  }
  cp_commit();
  for (int idx = tid; idx < C * D / 4; idx += THREADS) {
    const int row = idx / (D / 4), col = 4 * (idx % (D / 4));
    const bool live = t0 + row < S;
    const int64_t off = live ? (int64_t)(t0 + row) * a.in_ss + col : 0;
    cp16(&sm.v[row][col], a.v + in_base + off, live);
    cp16(&sm.dout[row][col],
         a.dout + out_base + (live ? (int64_t)(t0 + row) * D + col : 0),
         live);
    cp16(&sm.S0[row][col], states + row * D + col, true);
    cp16(&sm.G[row][col], grads + row * D + col, true);
  }
  cp_commit();
  for (int idx = tid; idx < C * LDR; idx += THREADS) (&sm.A[0][0])[idx] = 0.f;
  if (tid < D) sm.u[tid] = a.u[(int64_t)h * D + tid];
  cp_wait_one();
  __syncthreads();
  BACK_MARK(0);
  // S_end's rows for (c) below, read now so that they land during (a), (b)
  float se[2 * (D / WARPS)];
  if (ci + 1 < nc) {
#pragma unroll
    for (int i = 0; i < D / WARPS; ++i) {
      const float* row = states + D * D + (int64_t)(warp * (D / WARPS) + i) * D;
      se[2 * i] = row[lane];
      se[2 * i + 1] = row[lane + 32];
    }
  }

  // -- 1. (a) the 8-blocks, one a warp, columns lane and lane + 32: w, P,
  // Q, F and A inside the 8-block (as the forward's chunk kernel, step 1)
  {
    const int q0 = 8 * warp;
    float x[40];
#pragma unroll
    for (int i = 0; i < 40; ++i) x[i] = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int d = lane + 32 * half;
      const float ud = sm.u[d];
      float rr[8], kk[8], w[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        rr[t] = sm.r[q0 + t][d];
        kk[t] = sm.k[q0 + t][d];
        w[t] = expf(sm.w[q0 + t][d]);
        sm.w[q0 + t][d] = w[t];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        x[i * (i + 1) / 2 + i] += rr[i] * ud * kk[i];  // the bonus
        float xk = kk[i];
#pragma unroll
        for (int t = i + 1; t < 8; ++t) {
          x[t * (t + 1) / 2 + i] += rr[t] * xk;
          xk *= w[t];
        }
      }
      float pre = 1.f, suf = 1.f;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        sm.P[q0 + t][d] = pre;
        pre *= w[t];
      }
#pragma unroll
      for (int t = 7; t >= 0; --t) {
        sm.Q[q0 + t][d] = suf;
        suf *= w[t];
      }
      sm.F[warp][d] = pre;
    }
#pragma unroll
    for (int i = 0; i < 20; ++i) {
      const bool up = lane & 16;
      const float keep = up ? x[i + 20] : x[i];
      x[i] = keep + __shfl_xor_sync(0xffffffffu, up ? x[i] : x[i + 20], 16);
    }
#pragma unroll
    for (int i = 0; i < 10; ++i) {
      const bool up = lane & 8;
      const float keep = up ? x[i + 10] : x[i];
      x[i] = keep + __shfl_xor_sync(0xffffffffu, up ? x[i] : x[i + 10], 8);
    }
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const bool up = lane & 4;
      const float keep = up ? x[i + 5] : x[i];
      x[i] = keep + __shfl_xor_sync(0xffffffffu, up ? x[i] : x[i + 5], 4);
    }
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      x[i] += __shfl_xor_sync(0xffffffffu, x[i], 2);
      x[i] += __shfl_xor_sync(0xffffffffu, x[i], 1);
    }
    const int base = (lane & 16 ? 20 : 0) + (lane & 8 ? 10 : 0) +
                     (lane & 4 ? 5 : 0);
#pragma unroll
    for (int e = 0; e < 5; ++e) {
      const int slot = base + e;
      if ((lane & 3) == e % 4 && slot < 36) {
        const int t = (slot >= 1) + (slot >= 3) + (slot >= 6) +
                      (slot >= 10) + (slot >= 15) + (slot >= 21) +
                      (slot >= 28);
        sm.A[q0 + t][q0 + slot - t * (t + 1) / 2] = x[e];
      }
    }
  }
  cp_wait_all();
  __syncthreads();
  BACK_MARK(1);
  // (b) B = dOut V^T over the 16-block pairs (m, n) with n <= m
  for (int job = warp; job < 10; job += WARPS) {
    const int m = job < 1 ? 0 : job < 3 ? 1 : job < 6 ? 2 : 3;
    const int n = job - m * (m + 1) / 2;
    Acc acc[2];
    tile<2>(
        acc, 0, D, [&](int row, int k) { return sm.dout[16 * m + row][k]; },
        [&](int k, int col) { return sm.v[16 * n + col][k]; });
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 16 * n + 8 * e + 2 * c;
      sm.B[16 * m + g][col] = acc[e][0];
      sm.B[16 * m + g][col + 1] = acc[e][1];
      sm.B[16 * m + 8 + g][col] = acc[e][2];
      sm.B[16 * m + 8 + g][col + 1] = acc[e][3];
    }
  }
  BACK_MARK(2);
  // (c) rowsum(S_end * G), S_end the state leaving the chunk (the next
  // chunk's S0); G is 0 at the last chunk
#pragma unroll
  for (int i = 0; i < D / WARPS; ++i) {
    const int d = warp * (D / WARPS) + i;
    float e = 0.f;
    if (ci + 1 < nc) {
      e = se[2 * i] * sm.G[d][lane] + se[2 * i + 1] * sm.G[d][lane + 32];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) e += __shfl_xor_sync(0xffffffffu, e, o);
    }
    if (lane == 0) sm.edge[d] = e;
  }
  __syncthreads();
  BACK_MARK(3);

  // -- 2. the tables of whole 8-blocks' W, a column and a role a thread;
  // v_t . dout_t from B's diagonal
  {
    const int d = tid % D, role = tid / D;
    float f[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) f[q] = sm.F[q][d];
    if (role == 0) {
      float pre = 1.f;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        sm.RS[q][d] = pre;
        pre *= f[q];
      }
      sm.vd[d] = sm.B[d][d];
    } else if (role == 1) {
      float suf = 1.f;
#pragma unroll
      for (int q = NQ - 1; q >= 0; --q) {
        sm.KS[q][d] = suf;
        suf *= f[q];
      }
    } else if (role == 2) {
#pragma unroll
      for (int m = 1; m < C / 16; ++m) {
#pragma unroll
        for (int q = 0; q < 2 * m; ++q) {
          float fac = 1.f;
#pragma unroll
          for (int q2 = q + 1; q2 < 2 * m; ++q2) fac *= f[q2];
          sm.KF[m * (m - 1) + q][d] = fac;
        }
      }
    } else {
#pragma unroll
      for (int m = 0; m < C / 16 - 1; ++m) {
#pragma unroll
        for (int q = 2 * m + 2; q < NQ; ++q) {
          float fac = 1.f;
#pragma unroll
          for (int q2 = 2 * m + 2; q2 < q; ++q2) fac *= f[q2];
          sm.RF[rf(m, q)][d] = fac;
        }
      }
    }
  }
  __syncthreads();
  BACK_MARK(4);

  // -- 3. A between blocks (the forward's step 3a, rows rL = r P and
  // columns kL = k Q formed as they are read)
  if (warp < 6) {
    const int m = warp < 1 ? 1 : warp < 3 ? 2 : 3;
    const int q0 = 2 * warp - m * (m - 1);
    Acc acc[2];
    tile<2>(
        acc, 0, D,
        [&](int row, int k) {
          const int t = 16 * m + row;
          const float x = sm.r[t][k] * sm.P[t][k];
          return row < 8 ? x : x * sm.F[2 * m][k];
        },
        [&](int k, int col) {
          const int i = 8 * q0 + col;
          return sm.k[i][k] * sm.Q[i][k] * sm.KF[m * (m - 1) + q0 + col / 8][k];
        });
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * (q0 + e) + 2 * c;
      sm.A[16 * m + g][col] = acc[e][0];
      sm.A[16 * m + g][col + 1] = acc[e][1];
      sm.A[16 * m + 8 + g][col] = acc[e][2];
      sm.A[16 * m + 8 + g][col + 1] = acc[e][3];
    }
  } else {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = 2 * (warp - 6) + e;
      Acc acc[1];
      tile<1>(
          acc, 0, D,
          [&](int row, int k) {
            const int t = 16 * m + 8 + row;
            return row < 8 ? sm.r[t][k] * sm.P[t][k] : 0.f;
          },
          [&](int k, int col) {
            const int i = 16 * m + col;
            return sm.k[i][k] * sm.Q[i][k];
          });
      sm.A[16 * m + 8 + g][16 * m + 2 * c] = acc[0][0];
      sm.A[16 * m + 8 + g][16 * m + 2 * c + 1] = acc[0][1];
    }
  }
  __syncthreads();
  BACK_MARK(5);

  // -- 4. dr and dk of 16-block m, columns d0 .. d0 + 31, a warp: across
  // chunks, across 16-blocks, inside the 16-block, the bonus; a and b kept
  const int m = warp % 4, d0 = 32 * (warp / 4);
  {
    float xr[4][4], xk[4][4];
    {
      Acc acc[4];
      tile<4>(
          acc, 0, D, [&](int row, int k) { return sm.dout[16 * m + row][k]; },
          [&](int k, int col) { return sm.S0[d0 + col][k]; });
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int t = 16 * m + g + 8 * (q / 2);
          const int d = d0 + 8 * n + 2 * c + q % 2;
          xr[n][q] = acc[n][q] * (sm.P[t][d] * sm.RS[t / 8][d]);
        }
      }
    }
    if (m > 0) {
      Acc acc[4];
      tile<4>(
          acc, 0, 16 * m, [&](int row, int k) { return sm.B[16 * m + row][k]; },
          [&](int k, int col) {
            const int d = d0 + col;
            return sm.k[k][d] * sm.Q[k][d] * sm.KF[m * (m - 1) + k / 8][d];
          });
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int t = 16 * m + g + 8 * (q / 2);
          const int d = d0 + 8 * n + 2 * c + q % 2;
          const float f = q < 2 ? sm.P[t][d] : sm.P[t][d] * sm.F[2 * m][d];
          xr[n][q] += acc[n][q] * f;
        }
      }
    }
    {
      Acc acc[4];
      tile<4>(
          acc, 0, D, [&](int row, int k) { return sm.v[16 * m + row][k]; },
          [&](int k, int col) { return sm.G[d0 + col][k]; });
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int t = 16 * m + g + 8 * (q / 2);
          const int d = d0 + 8 * n + 2 * c + q % 2;
          xk[n][q] = acc[n][q] * (sm.Q[t][d] * sm.KS[t / 8][d]);
        }
      }
    }
    if (m < 3) {
      Acc acc[4];
      tile<4>(
          acc, 16 * (m + 1), C,
          [&](int row, int k) { return sm.B[k][16 * m + row]; },
          [&](int k, int col) {
            const int d = d0 + col;
            return sm.r[k][d] * sm.P[k][d] * sm.RF[rf(m, k / 8)][d];
          });
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int t = 16 * m + g + 8 * (q / 2);
          const int d = d0 + 8 * n + 2 * c + q % 2;
          const float f = q < 2 ? sm.Q[t][d] * sm.F[2 * m + 1][d] : sm.Q[t][d];
          xk[n][q] += acc[n][q] * f;
        }
      }
    }
    BACK_MARK(6);
    // the products' parts of dr and dk, less the pairs inside 16-blocks
    // and the bonus, into S0 and P (neither is read after this phase)
    __syncthreads();
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = 16 * m + g + 8 * (q / 2);
        const int d = d0 + 8 * n + 2 * c + q % 2;
        sm.S0[t][d] = xr[n][q];
        sm.P[t][d] = xk[n][q];
      }
    }
  }
  __syncthreads();
  BACK_MARK(7);

  // -- 5. thread (m, d), column d of 16-block m: the pairs inside the
  // 16-block on running products of w, the bonus, dr and dk out; a_t =
  // r_t (dr_t less its bonus) and b_t = k_t (dk_t less it); then
  // dlw_t = rowsum(S_end G) + sum_{tau>t} a_tau - sum_{i>=t} b_i, the later
  // 16-blocks' sums added in order; du's share of the chunk
  {
    const int sm16 = tid / D, d = tid % D, base = 16 * sm16;
    float rr[16], kk[16], ww[16], av[16], bv[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      rr[i] = sm.r[base + i][d];
      kk[i] = sm.k[base + i][d];
      ww[i] = sm.w[base + i][d];
    }
    const float ud = sm.u[d];
    float* dr = a.dr + out_base;
    float* dk = a.dk + out_base;
    float sa = 0.f, sb = 0.f, su = 0.f;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      float zr = 0.f, zk = 0.f, x = 1.f;
#pragma unroll
      for (int i = t - 1; i >= 0; --i) {
        zr = fmaf(sm.B[base + t][base + i] * kk[i], x, zr);
        x *= ww[i];
      }
      x = 1.f;
#pragma unroll
      for (int i = t + 1; i < 16; ++i) {
        zk = fmaf(sm.B[base + i][base + t] * rr[i], x, zk);
        x *= ww[i];
      }
      const float drp = sm.S0[base + t][d] + zr;
      const float dkp = sm.P[base + t][d] + zk;
      const float vd = sm.vd[base + t], uv = ud * vd;
      av[t] = rr[t] * drp;
      bv[t] = kk[t] * dkp;
      sa += av[t];
      sb += bv[t];
      su = fmaf(rr[t] * kk[t], vd, su);
      if (t0 + base + t < S) {
        dr[(int64_t)(t0 + base + t) * D + d] = fmaf(uv, kk[t], drp);
        dk[(int64_t)(t0 + base + t) * D + d] = fmaf(uv, rr[t], dkp);
      }
    }
    sm.scan[sm16][0][d] = sa;
    sm.scan[sm16][1][d] = sb;
    sm.dus[sm16][d] = su;
    __syncthreads();
    sa = 0.f;
    sb = 0.f;
    for (int q = 3; q > sm16; --q) {
      sa += sm.scan[q][0][d];
      sb += sm.scan[q][1][d];
    }
    const float e = sm.edge[d];
    float* dlw = a.dlw + out_base;
#pragma unroll
    for (int i = 15; i >= 0; --i) {
      sb += bv[i];
      if (t0 + base + i < S)
        dlw[(int64_t)(t0 + base + i) * D + d] = e + sa - sb;
      sa += av[i];
    }
    if (sm16 == 0)
      a.du[((int64_t)bh * nc + ci) * D + d] =
          sm.dus[0][d] + sm.dus[1][d] + sm.dus[2][d] + sm.dus[3][d];
  }
  BACK_MARK(8);

  // -- 6. dv of 16-block m, columns j0 .. j0 + 31, a warp (A, dout, k, Q,
  // KS and G are as phase 3 left them)
  {
    const int j0 = d0;
    Acc acc[4];
    tile<4>(
        acc, 16 * m, C, [&](int row, int k) { return sm.A[k][16 * m + row]; },
        [&](int k, int col) { return sm.dout[k][j0 + col]; });
    tile<4>(
        acc, 0, D,
        [&](int row, int k) {
          const int t = 16 * m + row;
          return sm.k[t][k] * sm.Q[t][k] * sm.KS[t / 8][k];
        },
        [&](int k, int col) { return sm.G[k][j0 + col]; });
    float* dv = a.dv + out_base;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int t = 16 * m + g + 8 * hr;
        if (t0 + t < S)
          *reinterpret_cast<float2*>(dv + (int64_t)(t0 + t) * D + j0 + 8 * n +
                                     2 * c) =
              make_float2(acc[n][2 * hr], acc[n][2 * hr + 1]);
      }
    }
  }
  BACK_MARK(9);
  BACK_END;
}

// the carry: a block a (b h, direction)
Plan carry_plan(int B, int H) {
  return Plan{dim3(B * H, 2), dim3(THREADS), (unsigned)CARRY_SMEM, 0};
}

// the chunks' gradients: a block a (chunk, b h)
Plan chunk_plan(int B, int H, int S) {
  return Plan{dim3((S + C - 1) / C, B * H), dim3(THREADS),
              (unsigned)BACK_SMEM, 0};
}

}  // namespace cback

// the chunked forward: a block NJ value columns of a head
Plan chunk_forward_plan(int B, int H) {
  return Plan{dim3(chunk::D / chunk::NJ, B * H), dim3(chunk::THREADS),
              (unsigned)chunk::SMEM, 0};
}

// the sequential forward: a block COLS value columns of a head
template <int D, int SPLIT, int COLS, int T>
Plan forward_plan(int B, int H) {
  return Plan{dim3(D / COLS, B * H), dim3(COLS * SPLIT), 0, 0};
}

template <int D, int SPLIT, int COLS, int T>
cudaError_t launch(const WkvArgs& a, cudaStream_t stream) {
  const Plan p = forward_plan<D, SPLIT, COLS, T>(a.B, a.H);
  wkv_kernel<D, SPLIT, COLS, T><<<p.grid, p.block, p.smem, stream>>>(
      a.r, a.k, a.v, a.lw, a.u, a.state_in, a.state_out, a.out, a.H, a.S,
      a.in_sb, a.in_sh, a.in_ss, a.out_sb, a.out_sh, a.out_ss);
  return cudaGetLastError();
}

bool valid(const WkvArgs& a) {
  return a.B > 0 && a.H > 0 && a.S > 0 && (int64_t)a.B * a.H <= 65535;
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

// an f32 (B, H, S, D) operand with the strides of `a`'s inputs as a 4-D map
// (D, S, H, B); boxes of `cols` x C tokens x 1 x 1, no swizzle, zeros
// outside the tensor
bool tensor_map(EncodeTiled encode, CUtensorMap* map, const float* ptr,
                const WkvArgs& a, int cols) {
  const cuuint64_t dims[4] = {(cuuint64_t)a.D, (cuuint64_t)a.S,
                              (cuuint64_t)a.H, (cuuint64_t)a.B};
  const cuuint64_t strides[3] = {(cuuint64_t)a.in_ss * 4,
                                 (cuuint64_t)a.in_sh * 4,
                                 (cuuint64_t)a.in_sb * 4};
  const cuuint32_t box[4] = {(cuuint32_t)cols, chunk::C, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                const_cast<float*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The plan and the kernel of a launch at args = {which, B, H, S, D}: which
// 0 the sequential forward, 1 the chunked forward, 2 the sequential
// backward, 3 the chunked backward's carry, 4 its chunks' kernel; the
// instances `wkv_forward` and `wkv_backward` below launch at each D
cudaError_t plan_of(const int* a, Plan* p, const void** fn) {
  const int B = a[1], H = a[2], S = a[3], D = a[4];
  if (B <= 0 || H <= 0 || S <= 0 || (int64_t)B * H > 65535)
    return cudaErrorInvalidValue;
  switch (a[0]) {
    case 0:
      if (D == 16) {
        *p = forward_plan<16, 4, 16, 64>(B, H);
        *fn = (const void*)wkv_kernel<16, 4, 16, 64>;
      } else if (D == 64) {
        *p = forward_plan<64, 8, 16, 32>(B, H);
        *fn = (const void*)wkv_kernel<64, 8, 16, 32>;
      } else {
        return cudaErrorInvalidValue;
      }
      return cudaSuccess;
    case 2:
      if (D == 16) {
        *p = back::plan<16, 2, 4>(B, H);
        *fn = (const void*)back::wkv_backward_kernel<16, 2, 4>;
      } else if (D == 64) {
        *p = back::plan<64, 4, 8>(B, H);
        *fn = (const void*)back::wkv_backward_kernel<64, 4, 8>;
      } else {
        return cudaErrorInvalidValue;
      }
      return cudaSuccess;
  }
  if (D != chunk::D) return cudaErrorInvalidValue;
  switch (a[0]) {
    case 1:
      *p = chunk_forward_plan(B, H);
      *fn = (const void*)chunk::wkv_chunk_kernel;
      return cudaSuccess;
    case 3:
      *p = cback::carry_plan(B, H);
      *fn = (const void*)cback::wkv_carry_kernel;
      return cudaSuccess;
    case 4:
      *p = cback::chunk_plan(B, H, S);
      *fn = (const void*)cback::wkv_chunk_backward_kernel;
      return cudaSuccess;
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* wkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// r, k, v, lw: f32 (B, H, S, D) with element strides in_s* (b, h, s) and 1
// along D, all four alike; out: f32 with strides out_s* (b, h, s) and 1
// along D; u: (H, D) contiguous; state_in (may be null: zeros) and
// state_out: (B, H, D, D) contiguous, and may be the same buffer. Every
// pointer 16-byte aligned and the in_s* and out_s* multiples of 4 (the
// wrapper checks). Each launches on `stream`, allocates nothing and returns
// cudaGetLastError().

// The sequential kernel, D = 16 or 64, any S >= 1.
int wkv_forward(const WkvArgs* a, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid(*a)) return static_cast<int>(cudaErrorInvalidValue);
  switch (a->D) {
    case 16:
      return static_cast<int>(launch<16, 4, 16, 64>(*a, s));
    case 64:
      return static_cast<int>(launch<64, 8, 16, 32>(*a, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The chunked tensor-core kernel, D = 64, any S >= 1.
int wkv_forward_tc(const WkvArgs* a, void* stream) {
  if (!valid(*a) || a->D != chunk::D)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        chunk::wkv_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)chunk::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap rm, km, lm, vm;
  if (!tensor_map(encode, &rm, a->r, *a, chunk::LDR) ||
      !tensor_map(encode, &km, a->k, *a, chunk::LDR) ||
      !tensor_map(encode, &lm, a->lw, *a, chunk::LDR) ||
      !tensor_map(encode, &vm, a->v, *a, chunk::NJ))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = chunk_forward_plan(a->B, a->H);
  chunk::wkv_chunk_kernel<<<p.grid, p.block, p.smem,
                            static_cast<cudaStream_t>(stream)>>>(rm, km, lm,
                                                                 vm, *a);
  return static_cast<int>(cudaGetLastError());
}

// The backward (no initial state, no gradient on the final state), D = 16
// or 64, any S >= 1; see `back` above for what it writes.
// D = 64: blocks of 32 rows, 2 a head, 8 elements a thread; D = 16: one
// block a head, 2 elements a thread.
int wkv_backward(const WkvBackArgs* a, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!(a->B > 0 && a->H > 0 && a->S > 0 && (int64_t)a->B * a->H <= 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (a->D) {
    case 16:
      return static_cast<int>(back::launch<16, 2, 4>(*a, s));
    case 64:
      return static_cast<int>(back::launch<64, 4, 8>(*a, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The chunked backward, D = 64, any S >= 1 (kernel_for gives it S >= 64):
// the carry, then the chunks' gradients. `states` holds 2 x B*H*ceil(S/64)
// D x D floats of scratch (the S0s, then the Gs); du is B*H*ceil(S/64) x D,
// a partial sum per (b h, chunk); dout is contiguous.
int wkv_backward_tc(const WkvBackArgs* a, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!(a->B > 0 && a->H > 0 && a->S > 0 && (int64_t)a->B * a->H <= 65535) ||
      a->D != chunk::D)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        cback::wkv_carry_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)cback::CARRY_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(cback::wkv_chunk_backward_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)cback::BACK_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const Plan pc = cback::carry_plan(a->B, a->H),
             pb = cback::chunk_plan(a->B, a->H, a->S);
  cback::wkv_carry_kernel<<<pc.grid, pc.block, pc.smem, s>>>(*a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cback::wkv_chunk_backward_kernel<<<pb.grid, pb.block, pb.smem, s>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

// The geometry of a launch (`plan_of`'s args), as the launchers above use
// it: out as launch_plan.h `write_plan`'s.
int wkv_plan(const int* args, int* out) {
  Plan p;
  const void* fn;
  const cudaError_t err = plan_of(args, &p, &fn);
  if (err == cudaSuccess) write_plan(p, out);
  return static_cast<int>(err);
}

// The attributes of that launch's kernel on the current device, and its
// blocks an SM at that geometry: out as `write_attributes`'.
int wkv_attributes(const int* args, int* out) {
  Plan p;
  const void* fn;
  cudaError_t err = plan_of(args, &p, &fn);
  if (err == cudaSuccess) err = write_attributes(fn, p, out);
  return static_cast<int>(err);
}

// The backward's layout at head dim D: out[0] the blocks of rows a head
// (dv's partial sums), out[1] the tokens a segment (the saved states).
int wkv_backward_layout(int D, int* out) {
  switch (D) {
    case 16:
      out[0] = back::Layout<16, 2, 4>::RG;
      break;
    case 64:
      out[0] = back::Layout<64, 4, 8>::RG;
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  out[1] = back::T;
  return 0;
}

#ifdef WKV_PHASE_CYCLES
// the per-phase cycles of the last launch: n values, [block][warp][mark]
int wkv_phase_cycles(long long* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, chunk::phase_cycles, sizeof(long long) * n));
}
// the chunk backward's, alike
int wkv_back_phase_cycles(long long* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, cback::back_cycles, sizeof(long long) * n));
}
#endif

}  // extern "C"
