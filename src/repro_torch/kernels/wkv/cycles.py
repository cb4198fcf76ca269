"""Where B4's chunked tensor-core kernels spend their cycles, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.wkv.cycles [--json PATH]

Builds ``csrc/wkv.cu`` with ``-DWKV_PHASE_CYCLES`` (each warp adds up the
``clock64()`` cycles between the phase marks of every chunk; compiled out
of the kernel the port runs), launches ``wkv_forward_tc`` at the forward's
shape of rwkv6-1.6b, (B, H, S, D) = (2, 32, 2048, 64) in the model's
layout, and prints the mean cycles a chunk of each phase, by warp, beside
the launch's time by CUDA events. A mark closes its phase for the warp that
reads it, so a phase's count for a warp includes its wait at the barrier
that ends the phase. It also times ``mma.sync`` in TF32 (m16n8k8) and BF16
(m16n8k16) alone: eight independent products a warp, 1, 2 and 4 warps a
sub-partition, which bounds what the kernel's 3xTF32 products can reach;
and a barrier over a cluster of two blocks against ``__syncthreads``, the
price of sharing a head's work between its two blocks. Then the chunked
backward at the same shape (``wkv_backward_tc``): the mean cycles a block
of each phase of ``wkv_chunk_backward_kernel``, by warp, over the first
``BACK_BLOCKS`` blocks, beside the call's time and each of its kernels'
device time under torch.profiler (the carry, the chunks' kernel, du's sum).
Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from repro_torch.kernels._build import (BASE_FLAGS, BUILD_DIR, KernelLibrary,
                                        nvcc)
from repro_torch.kernels.wkv import kernel as b4

SHAPE = (2, 32, 2048, 64)
PHASES = ("wait for the chunk", "8-block pass", "tables, v split, loads",
          "A between blocks", "out from S0 | state", "barrier",
          "out from A | state split")
WARPS, CHUNK = 8, 64
BACK_PHASES = ("wait for r, k, lw", "8-block pass", "the rest landed, B",
               "rowsum(S_end G)", "tables", "A between blocks",
               "dr, dk products", "products to shared memory",
               "pairs inside 16-blocks, dlw, du", "dv")
BACK_BLOCKS = 512  # blocks whose cycles the kernel keeps (wkv.cu)
BENCH_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdio.h>
#include <stdint.h>
template <int TF32>
__global__ void products(float* out, int iters) {
  float acc[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2,
                         threadIdx.x + 3};
  const uint32_t b[2] = {threadIdx.x * 3, threadIdx.x * 5};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (TF32)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                     : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]),
                       "+f"(acc[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
                       "r"(b[1]));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                     : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]),
                       "+f"(acc[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
                       "r"(b[1]));
    }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j)
    for (int q = 0; q < 4; ++q) s += acc[j][q];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int TF32>
void run(int sms, int warps, float* out) {
  const int iters = 4096;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  products<TF32><<<sms, 32 * warps>>>(out, 16);
  cudaEventRecord(e0);
  products<TF32><<<sms, 32 * warps>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const double k = TF32 ? 8 : 16, n = (double)sms * warps * iters * 8;
  printf("{\"op\": \"%s\", \"warps_per_subpartition\": %d, "
         "\"ns_per_product_per_subpartition\": %.4f, \"tflops\": %.2f}\n",
         TF32 ? "mma.sync m16n8k8 tf32" : "mma.sync m16n8k16 bf16",
         warps / 4, 1e6 * ms / (n / sms / 4), 2 * 16 * 8 * k * n / ms / 1e9);
}
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(256, 1)
cluster_barriers(long long* out, int iters) {
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  }
  if (threadIdx.x == 0) out[blockIdx.x] = clock64() - t0;
}
__global__ void __launch_bounds__(256, 1)
block_barriers(long long* out, int iters) {
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) __syncthreads();
  if (threadIdx.x == 0) out[blockIdx.x] = clock64() - t0;
}
template <typename K>
void barriers(const char* what, K kernel, int blocks) {
  const int iters = 10000;
  long long *d, h[1024];
  cudaMalloc(&d, sizeof(h));
  kernel<<<blocks, 256>>>(d, 16);
  kernel<<<blocks, 256>>>(d, iters);
  cudaMemcpy(h, d, sizeof(long long) * blocks, cudaMemcpyDeviceToHost);
  double sum = 0;
  for (int i = 0; i < blocks; ++i) sum += h[i];
  printf("{\"op\": \"%s\", \"cycles\": %.1f}\n", what,
         sum / blocks / iters);
}
int main() {
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  cudaMalloc(&out, sizeof(float) * sms * 512);
  for (int w : {4, 8, 16}) {
    run<1>(sms, w, out);
    run<0>(sms, w, out);
  }
  barriers("barrier of a 2-block cluster", cluster_barriers, 128);
  barriers("__syncthreads of 256 threads", block_barriers, 128);
  return 0;
}
"""


def _declare(lib: ctypes.CDLL) -> None:
    b4._declare(lib)
    for name in ("wkv_phase_cycles", "wkv_back_phase_cycles"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        fn.restype = ctypes.c_int


LIBRARY = KernelLibrary("wkv", "wkv.cu", flags=("-DWKV_PHASE_CYCLES",),
                        declare=_declare)


def phase_cycles(seed: int = 0, reps: int = 20) -> dict:
    """Mean cycles a chunk of each phase, by warp, and the launch's ms."""
    b, h, s, d = SHAPE
    rng = np.random.default_rng(seed)

    def draw(lw=False):
        x = (rng.uniform(-1.61, -0.64, (b, s, h, d)) if lw
             else rng.standard_normal((b, s, h, d)) * 0.5)
        return torch.from_numpy(x.astype(np.float32)).cuda().transpose(1, 2)

    r, k, v, lw = draw(), draw(), draw(), draw(lw=True)
    u = torch.from_numpy((rng.standard_normal((h, d)) * 0.5).astype(
        np.float32)).cuda()
    out = torch.empty_like(r)
    final = torch.empty((b, h, d, d), device="cuda")
    args = b4._pack(r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
                    u.data_ptr(), 0, final.data_ptr(), out.data_ptr(), b, h,
                    s, d, *r.stride()[:3], *out.stride()[:3])
    launch = LIBRARY.launcher("wkv_forward_tc")
    dev = r.get_device()
    for _ in range(3):
        launch(dev, args)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        launch(dev, args)
    end.record()
    torch.cuda.synchronize()
    blocks = (d // 32) * b * h
    cycles = np.zeros(blocks * WARPS * len(PHASES), dtype=np.int64)
    LIBRARY.check(LIBRARY.load().wkv_phase_cycles(cycles.ctypes.data,
                                                  cycles.size),
                  "wkv_phase_cycles")
    per_chunk = cycles.reshape(blocks, WARPS, len(PHASES)).mean(axis=0) / (
        s // CHUNK)
    return {"shape": list(SHAPE), "ms": start.elapsed_time(end) / reps,
            "cycles_per_chunk": {name: per_chunk[:, i].round(1).tolist()
                                 for i, name in enumerate(PHASES)},
            "total_by_warp": per_chunk.sum(axis=1).round(1).tolist()}


def backward_phase_cycles(seed: int = 0, reps: int = 20) -> dict:
    """Mean cycles a block of each phase of the chunk backward, by warp,
    and the backward's ms (the carry kernel and the chunks' kernel), built
    with the counters."""
    b, h, s, d = SHAPE
    rng = np.random.default_rng(seed)

    def draw(lw=False):
        x = (rng.uniform(-1.61, -0.64, (b, s, h, d)) if lw
             else rng.standard_normal((b, s, h, d)) * 0.5)
        return torch.from_numpy(x.astype(np.float32)).cuda().transpose(1, 2)

    r, k, v, lw = draw(), draw(), draw(), draw(lw=True)
    u = torch.from_numpy((rng.standard_normal((h, d)) * 0.5).astype(
        np.float32)).cuda()
    dout = torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(
        np.float32)).cuda()
    launchers = b4._LAUNCH_BACKWARD
    saved = launchers["tensor_core"]
    launchers["tensor_core"] = LIBRARY.launcher("wkv_backward_tc")
    try:
        def run():
            b4.wkv_backward_cuda(r, k, v, lw, u, dout, kernel="tensor_core")

        for _ in range(3):
            run()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            run()
        end.record()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
    finally:
        launchers["tensor_core"] = saved
    cycles = np.zeros(BACK_BLOCKS * WARPS * len(BACK_PHASES), dtype=np.int64)
    LIBRARY.check(LIBRARY.load().wkv_back_phase_cycles(cycles.ctypes.data,
                                                       cycles.size),
                  "wkv_back_phase_cycles")
    per_block = cycles.reshape(BACK_BLOCKS, WARPS, len(BACK_PHASES)).mean(
        axis=0)
    kernel_us = {e.key[:60]: (getattr(e, "self_device_time_total", 0.0)
                              or getattr(e, "self_cuda_time_total", 0.0))
                 / reps for e in prof.key_averages()}
    return {"shape": list(SHAPE), "ms": start.elapsed_time(end) / reps,
            "device_us_by_kernel": {k: v for k, v in kernel_us.items() if v},
            "cycles_per_block": {name: per_block[:, i].round(1).tolist()
                                 for i, name in enumerate(BACK_PHASES)},
            "total_by_warp": per_block.sum(axis=1).round(1).tolist()}


def microbenchmarks() -> list[dict]:
    """``mma.sync`` alone, TF32 and BF16, at 1, 2, 4 warps a
    sub-partition; then a cluster barrier and a block barrier."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, exe = BUILD_DIR / "wkv_bench.cu", BUILD_DIR / "wkv_bench"
    src.write_text(BENCH_SOURCE)
    subprocess.run([nvcc(), *BASE_FLAGS[:4], "-o", str(exe), str(src)],
                   check=True)
    res = subprocess.run([str(exe)], check=True, capture_output=True,
                         text=True)
    return [json.loads(line) for line in res.stdout.splitlines()]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--json", help="also write the results here")
    args = parser.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    result = {"card": card, "phases": phase_cycles(),
              "microbenchmarks": microbenchmarks(),
              "backward_phases": backward_phase_cycles()}
    print(json.dumps(result, indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
