#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Builds the port's three kernels with nvcc for sm_90a, one nvcc each, all
started together: B1, the Himeno Jacobi sweep (``csrc/himeno.cu``), B2,
RMSNorm (``csrc/rmsnorm.cu``) and B3, the flash-attention forward
(``csrc/flash_attention.cu``). Holds every kernel against its plain PyTorch
version on the card at its main path's shapes and at ragged ones, timing
it beside its bound, its plain version and, where one exists, the PyTorch
library call that computes the same function. Then:

* slice 2, the dense LM at llama3.2-3b's full width: a float32 check of
  B3 inside a 4-layer model against the plain attention, and of forward
  against teacher-forced decode; then the dense main path at full width
  and depth in bf16 — ``launch.serve.serve``, a ragged run through
  ``ServingEngine`` (with a profiled window of decode steps) and one
  forward of 2x2048 tokens, each metered on the GPU's power counter;
* slice 1, the paper's GA offload loop at the paper's L grid
  (512x256x256): ``himeno_run``, Fig. 5 through
  ``MeteredBackend.auto(HimenoMeasuredBackend(HimenoApp(L)))`` for the
  all-CPU placement and the paper's pattern, and ``search_himeno`` over
  that backend.

The kernels' launch counts are set to 0 just before each main path and
read just after. Every phase prints one JSON line; then the kernels' line;
the line before the last is the card's name and power limit as
``nvidia-smi`` gives them, the last line is ``{"ok": true, "device":
{...}}``. Any failed check, or a run over ``BUDGET_S``, exits non-zero
without that line. Without CUDA, or without the repo beside it, the script
fails before it prints a result.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet): device memory rate and f32
# outside the tensor cores. The bound of a kernel is the larger of its bytes
# over the first and its operations over the second.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12  # dense, on the tensor cores
P_ATOL = 1e-5      # p_new and ss against the plain version, at most
SS_RTOL = 1e-3     # ... and at most this share of the largest |ss| compared
GOSA_RTOL = 1e-4   # gosa against the plain version, and across placements
OMEGA = 0.8        # the sweep's relaxation factor
REPLACES = "src/repro/kernels/himeno/kernel.py:21"
SOURCE = "src/repro_torch/csrc/himeno.cu"
ARGS = ("p", "a", "b", "c", "bnd", "wrk1")
REPS = 20          # kernel launches a timing averages over
SOLVER_ITERS = 10  # sweeps of the himeno_run phase
FIG5_ITERS = 62    # sweeps of each Fig. 5 run at L, as in the paper
# Sweeps of each GA measurement at L. An all-CPU sweep costs about 2 s of
# NumPy, and the GA makes up to 24 measurements (population 6, 4
# generations), most of them with host units: at the paper's 62 sweeps the
# GA alone would take far longer than the smoke's limit of 1200 s.
GA_ITERS = 2
SMOKE_LIMIT_S = 1200
BUDGET_S = 900.0   # a run over this is reported as timed out and fails

# Slice 2: the dense LM path (llama3.2-3b) through kernels B2 and B3.
ARCH = "llama3.2-3b"
F32_ATOL = 2e-5    # f32 kernels against their plain versions
FLASH_BF16_ATOL = 3e-2  # bf16 attention (the JAX package's kernel tests)
# Forward against teacher-forced decode, as a share of max |logits|. The
# reference's own check (tests/test_arch_smoke.py) holds its reduced configs
# to 5e-3. Decode reads K/V from a bf16 cache where forward keeps them in
# f32, and at this check's size the reference itself exceeds 5e-3: on the
# same weights and tokens, llama3.2-3b in f32 at full width, 4 layers,
# 2 x 512 tokens, the JAX package gives 6.003e-3 and the port 6.010e-3 on
# a CPU (tests/test_torch_decode_gap.py, run as a script). So the limit
# here is 1e-2, and B3 is held inside the same model to MODEL_B3_RTOL
# against the plain attention, which has no cache.
DECODE_RTOL = 1e-2
MODEL_B3_RTOL = 1e-4
CHECK_LAYERS = 4   # depth of the f32 full-width model check
CHECK_SEQ = 512
RAGGED = dict(slots=8, max_len=1024, requests=16, prompt=(64, 512),
              max_new_tokens=64, seed=0)
PREFILL = (2, 2048)  # batch x tokens of the main path's forward
RMS_SHAPES = (((8, 1, 3072), "bfloat16"), ((2, 2048, 3072), "bfloat16"),
              ((37, 5632), "float32"))
# (B, H, K, S, D, dtype, causal, window); the main path's shape also in
# f32, where F32_ATOL can catch a dropped or misplaced key tile that
# FLASH_BF16_ATOL, near the size of a typical |o| at S=2048, cannot
FLASH_SHAPES = ((2, 24, 8, 2048, 128, "bfloat16", True, 0),
                (2, 24, 8, 2048, 128, "float32", True, 0),
                (1, 8, 2, 1000, 64, "float32", True, 256),
                (1, 4, 4, 333, 16, "float32", False, 0))


def kernel_modules():
    """The wrapper modules of every kernel of the port."""
    from repro_torch.kernels.flash_attention import kernel as b3
    from repro_torch.kernels.himeno import kernel as b1
    from repro_torch.kernels.rmsnorm import kernel as b2
    return (b1, b2, b3)


def reset_all_launches() -> None:
    for mod in kernel_modules():
        mod.reset_launches()


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi(query: str) -> list[str]:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return []
    out = subprocess.run([exe, f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def random_state(grid, seed, device):
    """Nontrivial coefficients from a numpy seed, as the reference's
    nontrivial-coefficient kernel test draws them."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    arrs = dict(
        p=rng.uniform(size=grid), a=rng.uniform(size=(4,) + grid),
        b=rng.uniform(size=(3,) + grid) * 0.1, c=rng.uniform(size=(3,) + grid),
        bnd=(rng.uniform(size=grid) > 0.5), wrk1=rng.uniform(size=grid) * 0.01)
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
            for k, v in arrs.items()}


def atol(change, base=None) -> float:
    """Absolute tolerance for a result that the plain version computes as
    ``base + change`` (ss alone has no base): P_ATOL, tightened to SS_RTOL
    of the largest |change| plus 4 ulp of the largest |base|, the rounding of
    the sum. Under ``himeno_init`` every interior ss is 1/(3*255^2), about
    5e-6, so a kernel that wrote no ss, or wrote it at the wrong points,
    would pass a bare 1e-5."""
    import torch

    tol = SS_RTOL * float(change.abs().max())
    if base is not None:
        tol += 4 * torch.finfo(torch.float32).eps * float(base.abs().max())
    return min(P_ATOL, tol)


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events, after
    one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(grid, entry: str) -> float:
    """Least time for one launch: 13 f32 arrays read once, one written once
    (p_new, or the interior ss), and 34 FLOP an interior point for the sweep
    (32 for the stencil, which skips the update)."""
    from repro_torch.kernels.himeno.ref import FLOPS_PER_POINT

    i, j, k = grid
    pts, interior = i * j * k, (i - 2) * (j - 2) * (k - 2)
    out = pts if entry == "himeno_sweep" else interior
    flops = (FLOPS_PER_POINT if entry == "himeno_sweep"
             else FLOPS_PER_POINT - 2) * interior
    nbytes = 4 * (13 * pts + out)
    return 1e3 * max(nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS)



def rms_bound_ms(shape, dtype_bytes: int) -> tuple[float, str]:
    """x read once, y written once, scale (f32) read once; 4 f32 operations
    an element (square, sum, and two products)."""
    n = 1
    for side in shape:
        n *= side
    nbytes = 2 * n * dtype_bytes + 4 * shape[-1]
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, 4 * n / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_pairs(s: int, causal: bool, window: int) -> int:
    """(q, k) pairs the mask lets through in one head."""
    if not causal:
        return s * s
    if not window:
        return s * (s + 1) // 2
    return sum(min(q + 1, window) for q in range(s))


def flash_bound_ms(b, h, kh, s, d, dtype_bytes, causal, window
                   ) -> tuple[float, str]:
    """QK^T and PV over the unmasked pairs (4*D operations a pair) at the
    peak for the inputs' type; q, k, v (K heads) read once, o written once.
    """
    flops = 4 * d * attention_pairs(s, causal, window) * b * h
    peak = PEAK_BF16_FLOPS if dtype_bytes == 2 else PEAK_F32_FLOPS
    nbytes = dtype_bytes * b * s * d * (2 * h + 2 * kh)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bf16_ulp(y):
    """One bf16 ulp at |y| (8 significant bits)."""
    import torch

    mag = y.abs().float().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def timed_pair(kernel_fn, plain_fn, reps: int) -> dict:
    """plain, kernel, kernel, plain: the better of two means each."""
    pl1 = time_ms(plain_fn, max(2, reps // 4))
    k1 = time_ms(kernel_fn, reps)
    k2 = time_ms(kernel_fn, reps)
    pl2 = time_ms(plain_fn, max(2, reps // 4))
    return {"ms": min(k1, k2), "ms_runs": [k1, k2], "plain_ms": min(pl1, pl2),
            "plain_ms_runs": [pl1, pl2]}


def metered(fn):
    """Run ``fn`` under the port's EnergyMeter over the machine's counters;
    returns (result, seconds, GPU Watt·s, trace samples)."""
    import torch
    from repro_torch.telemetry import (CounterSampler, EnergyMeter,
                                       trapezoid_ws)

    meter = EnergyMeter(CounterSampler(), hz=20.0)
    with meter:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    trace = meter.reading.trace
    return out, seconds, trapezoid_ws(trace, domains=("gpu",)), len(trace)

class Smoke:
    def __init__(self):
        self.failures: list[str] = []
        self.card = ""
        self.kernels: dict[str, dict] = {}

    def check(self, ok: bool, what: str) -> None:
        if not ok:
            self.failures.append(what)
            print(f"CHECK FAILED: {what}", file=sys.stderr, flush=True)

    # -- phase 0 + 1 -----------------------------------------------------
    def card_and_build(self):
        import torch
        from repro_torch.kernels._build import build_all

        lines = smi("name,power.limit")
        self.card = lines[0] if lines else "not read"
        emit({"phase": "card", "card": self.card,
              "nvidia_smi_gpus": len(lines),
              "torch_device": torch.cuda.get_device_name(0),
              "torch_device_count": torch.cuda.device_count(),
              "torch": torch.__version__, "cuda": torch.version.cuda})
        # every kernel of the port, one nvcc each, all started together
        libraries = [mod.LIBRARY for mod in kernel_modules()]
        t0 = time.perf_counter()
        seconds = build_all(libraries)
        for lib in libraries:
            lib.load()
        total = time.perf_counter() - t0
        # registers, shared and local memory of each kernel, from the binary
        cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        for lib in libraries:
            path = lib.path()
            usage = subprocess.run([cuobjdump, "--dump-resource-usage",
                                    str(path)], capture_output=True,
                                   text=True, timeout=60)
            emit({"phase": "build", "kernel": lib.prefix,
                  "seconds": seconds[lib.prefix], "library": path.name,
                  "resource_usage": [ln.strip() for ln in
                                     usage.stdout.splitlines()
                                     if "REG:" in ln]})
        emit({"phase": "build_all", "seconds": total,
              "libraries": len(libraries)})

    # -- phase 2: kernels against their plain versions -------------------
    def compare(self, label, st, *, timed=False):
        import torch
        from repro_torch.kernels.himeno import (
            himeno_stencil, himeno_sweep, jacobi_ref, stencil_parts_ref)

        args = [st[k] for k in ARGS]
        grid = tuple(st["p"].shape)
        p_k, g_k = himeno_sweep(*args, omega=OMEGA)
        g_k2 = himeno_sweep(*args, omega=OMEGA)[1]
        p_r, g_r = jacobi_ref(*args, omega=OMEGA)
        ss_k, parts_k = himeno_stencil(*args)
        ss_r, parts_r = stencil_parts_ref(*args)
        torch.cuda.synchronize()
        tol = {"himeno_sweep": atol(OMEGA * ss_r, st["p"]),
               "himeno_stencil": atol(ss_r)}
        rel = lambda x, y: abs(float(x) - float(y)) / max(abs(float(y)),
                                                           1e-30)
        res = {
            "himeno_sweep": {"max_abs_err": float((p_k - p_r).abs().max()),
                             "gosa_rel_err": rel(g_k, g_r)},
            "himeno_stencil": {"max_abs_err": float((ss_k - ss_r).abs().max()),
                               "gosa_rel_err": rel(parts_k.sum(),
                                                   parts_r.sum())},
        }
        self.check(torch.equal(g_k, g_k2), f"{label}: gosa not repeatable")
        for name, r in res.items():
            self.check(r["max_abs_err"] <= tol[name],
                       f"{label} {name}: max_abs_err {r['max_abs_err']} > "
                       f"{tol[name]}")
            self.check(r["gosa_rel_err"] <= GOSA_RTOL,
                       f"{label} {name}: gosa_rel_err {r['gosa_rel_err']}")
        if timed:
            reps = REPS
            kern = {"himeno_sweep": lambda: himeno_sweep(*args),
                    "himeno_stencil": lambda: himeno_stencil(*args)}
            plain = {"himeno_sweep": lambda: jacobi_ref(*args),
                     "himeno_stencil": lambda: stencil_parts_ref(*args)}
            for name in res:
                # plain, kernel, kernel, plain: compare within one call
                pl1 = time_ms(plain[name], max(2, reps // 4))
                k1 = time_ms(kern[name], reps)
                k2 = time_ms(kern[name], reps)
                pl2 = time_ms(plain[name], max(2, reps // 4))
                res[name].update(ms=min(k1, k2), ms_runs=[k1, k2],
                                 plain_ms=min(pl1, pl2),
                                 plain_ms_runs=[pl1, pl2],
                                 bound_ms=bound_ms(grid, name))
        emit({"phase": "kernel", "grid": list(grid), "inputs": label,
              "tolerance": {"p_atol": tol["himeno_sweep"],
                            "ss_atol": tol["himeno_stencil"],
                            "gosa_rtol": GOSA_RTOL},
              "card": self.card, **res})
        return res

    def kernel_phase(self):
        import torch
        from repro_torch.configs.himeno import GRIDS
        from repro_torch.kernels.himeno import himeno_init

        errs = {"himeno_sweep": 0.0, "himeno_stencil": 0.0}
        # two ragged grids and the main path's L grid with numpy-seeded
        # coefficients (b, bnd and wrk1 all vary), then L as the main path
        # initialises it, which is also where the kernels are timed
        for grid, seed in (((7, 9, 17), 0), ((61, 83, 150), 1),
                           (GRIDS["L"], 2)):
            st = random_state(grid, seed, "cuda")
            res = self.compare(f"numpy seed {seed}", st)
            del st
            for name in errs:
                errs[name] = max(errs[name], res[name]["max_abs_err"])
        torch.cuda.empty_cache()
        st = himeno_init(GRIDS["L"], device="cuda")
        res = self.compare("himeno_init", st, timed=True)
        del st
        torch.cuda.empty_cache()
        for name, r in res.items():
            self.kernels[name] = {
                "name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES, "launches": 0,
                "max_abs_err": max(errs[name], r["max_abs_err"]),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": "bytes",
                "library_ms": None, "shape": list(GRIDS["L"]),
                "card": self.card}

    # -- phase 3: the main path ------------------------------------------
    def main_path(self):
        import torch
        from repro_torch.apps.himeno_app import (
            LOOP_UNITS, UNIT_NAMES, HimenoApp)
        from repro_torch.configs.himeno import GRIDS
        from repro_torch.core.ga import GAConfig
        from repro_torch.core.offload_search import search_himeno
        from repro_torch.core.verifier import HimenoMeasuredBackend
        from repro_torch.kernels.himeno import (
            himeno_init, himeno_run, himeno_stencil, kernel)
        from repro_torch.telemetry import MeteredBackend

        L = GRIDS["L"]
        all_cpu = tuple(0 for _ in UNIT_NAMES)
        paper = tuple(int(u in LOOP_UNITS) for u in UNIT_NAMES)

        reset_all_launches()
        # 1. the solver entry
        t0 = time.perf_counter()
        st = himeno_init(L, device="cuda")
        p_run, g_run = himeno_run(st, SOLVER_ITERS)
        torch.cuda.synchronize()
        solver_s = time.perf_counter() - t0

        # 2. Fig. 5 through the metered measured backend
        t0 = time.perf_counter()
        app = HimenoApp(grid=L, iters=FIG5_ITERS)
        fig5 = MeteredBackend.auto(HimenoMeasuredBackend(app,
                                                         budget_s=BUDGET_S))
        warm_s = time.perf_counter() - t0
        domains = fig5.sampler.domains() if fig5.sampler else ()
        runs = {}
        for label, bits in (("all_cpu", all_cpu), ("loop_units", paper)):
            before = himeno_stencil.launches
            m = fig5.measure_bits(bits)
            launched = himeno_stencil.launches - before
            runs[label] = m
            met = m.detail["metered"]
            emit({"phase": "fig5", "placement": label, "grid": list(L),
                  "iters": FIG5_ITERS, "time_s": m.time_s,
                  "t_device_s": m.detail["t_device"],
                  "modeled_ws": met["modeled_ws"],
                  "metered_ws": met["metered_ws"], "avg_watts": m.avg_watts,
                  "trace_source": met["trace_source"],
                  "trace_samples": met["trace_samples"],
                  "domains": list(domains), "timed_out": m.timed_out,
                  "gosa": m.detail.get("gosa"),
                  "final_residual": m.detail.get("final_residual"),
                  "stencil_launches": launched, "card": self.card})
            self.check(not m.timed_out, f"fig5 {label} truncated")
            # the card's placement goes through B1 once a sweep, and the
            # all-CPU placement never launches it
            self.check(launched == (FIG5_ITERS if label == "loop_units"
                                    else 0),
                       f"fig5 {label}: {launched} stencil launches")
        cpu, gpu = runs["all_cpu"], runs["loop_units"]
        if not (cpu.timed_out or gpu.timed_out):
            for key in ("gosa", "final_residual"):
                x, y = gpu.detail[key], cpu.detail[key]
                self.check(abs(x - y) <= GOSA_RTOL * abs(y),
                           f"fig5 {key}: {x} on the card vs {y} on the host")
        emit({"phase": "fig5_summary", "warmup_s": warm_s,
              "metered_ratio": (gpu.energy_ws / cpu.energy_ws
                                if cpu.energy_ws else None),
              "time_ratio": gpu.time_s / cpu.time_s,
              "smi_gpus_summed": len(smi("name")), "card": self.card})

        # 3. the GA over the metered measured backend, at L
        t0 = time.perf_counter()
        ga_backend = MeteredBackend.auto(HimenoMeasuredBackend(
            HimenoApp(grid=L, iters=GA_ITERS), budget_s=BUDGET_S))
        res = search_himeno(ga_backend, GAConfig(population=6, generations=4,
                                                 seed=0))
        ga_s = time.perf_counter() - t0
        # the all-CPU genome seeds the GA's first generation
        base = next(r.measurement for r in res.history[0]
                    if r.genome == all_cpu)
        best = res.best.measurement
        emit({"phase": "ga", "grid": list(L), "iters": GA_ITERS,
              "cut": f"{GA_ITERS} sweeps a measurement (Fig. 5 and the "
                     f"paper: {FIG5_ITERS}), so that up to 24 measurements, "
                     "all-CPU ones at about 2 s of NumPy a sweep, fit the "
                     f"smoke's limit of {SMOKE_LIMIT_S} s",
              "best_genome": list(res.best.genome),
              "best_units_on_card": [u for u, b in zip(UNIT_NAMES,
                                                       res.best.genome) if b],
              "best_time_s": best.time_s, "best_metered_ws": best.energy_ws,
              "all_cpu_time_s": base.time_s,
              "all_cpu_metered_ws": base.energy_ws,
              "evaluations": res.evaluations, "cache_hits": res.cache_hits,
              "seconds": ga_s, "card": self.card})
        self.check(res.evaluations > 0, "GA measured nothing")

        launches = {f.__name__: f.launches for f in kernel.WRAPPERS}
        for name, n in launches.items():
            self.kernels[name]["launches"] = n
            self.check(n > 0, f"{name} never launched on the main path")

        # the solver's result against the plain version, after the window
        p_ref, g_ref = himeno_run(st, SOLVER_ITERS, impl="ref")
        err = float((p_run - p_ref).abs().max())
        grel = abs(float(g_run) - float(g_ref)) / abs(float(g_ref))
        p_tol = atol(p_ref - st["p"], st["p"])
        self.check(err <= p_tol and grel <= GOSA_RTOL,
                   f"himeno_run: p err {err}, gosa rel err {grel}")
        self.check(bool(torch.isfinite(p_run).all()), "himeno_run not finite")
        emit({"phase": "solver", "grid": list(L), "iters": SOLVER_ITERS,
              "seconds": solver_s, "gosa": float(g_run),
              "max_abs_err": err, "p_atol": p_tol, "gosa_rel_err": grel,
              "card": self.card})


    # -- phase 4: B2 and B3 against their plain versions -----------------
    def dense_kernel_phase(self):
        import numpy as np
        import torch
        import torch.nn.functional as F
        from repro_torch.kernels.flash_attention import (
            attention_ref, flash_attention_cuda)
        from repro_torch.kernels.rmsnorm import rms_norm_cuda, rms_norm_ref

        dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
        rng = np.random.default_rng(0)
        rows = {}
        for shape, dt in RMS_SHAPES:
            x = torch.from_numpy((rng.standard_normal(shape) * 2).astype(
                np.float32)).to("cuda", dtypes[dt])
            scale = torch.from_numpy(rng.uniform(
                0.5, 1.5, shape[-1]).astype(np.float32)).cuda()
            y, ref = rms_norm_cuda(x, scale), rms_norm_ref(x, scale)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs()
            if dt == "float32":
                tol, ok = F32_ATOL, float(err.max()) <= F32_ATOL
            else:
                tol, ok = "one bf16 ulp of |y|", bool((err <= bf16_ulp(
                    ref)).all())
            label = f"rms_norm {list(shape)} {dt}"
            self.check(ok, f"{label}: max_abs_err {float(err.max())}")
            self.check(torch.equal(y, rms_norm_cuda(x, scale)),
                       f"{label}: not repeatable")
            row = {"shape": list(shape), "dtype": dt,
                   "max_abs_err": float(err.max()), "tolerance": tol}
            row.update(timed_pair(lambda: rms_norm_cuda(x, scale),
                                  lambda: rms_norm_ref(x, scale), REPS))
            weight = scale.to(x.dtype)  # the library call takes one dtype
            row["library_ms"] = time_ms(
                lambda: F.rms_norm(x, (shape[-1],), weight, 1e-5), REPS)
            row["bound_ms"], row["bound_by"] = rms_bound_ms(
                shape, x.element_size())
            emit({"phase": "kernel", "kernel": "rms_norm", **row,
                  "card": self.card})
            rows[("rms_norm", shape)] = row
        for b, h, kh, s, d, dt, causal, window in FLASH_SHAPES:
            def draw(heads):
                return torch.from_numpy(rng.standard_normal(
                    (b, heads, s, d)).astype(np.float32)).to("cuda",
                                                             dtypes[dt])
            q, k, v = draw(h), draw(kh), draw(kh)
            o = flash_attention_cuda(q, k, v, causal=causal, window=window)
            ref = attention_ref(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            err = float((o.float() - ref.float()).abs().max())
            tol = F32_ATOL if dt == "float32" else FLASH_BF16_ATOL
            label = f"flash_attention {[b, h, kh, s, d]} {dt}"
            self.check(err <= tol, f"{label}: max_abs_err {err} > {tol}")
            self.check(torch.equal(o, flash_attention_cuda(
                q, k, v, causal=causal, window=window)),
                f"{label}: not repeatable")
            del o, ref
            row = {"shape": [b, h, s, d], "kv_heads": kh, "dtype": dt,
                   "causal": causal, "window": window, "max_abs_err": err,
                   "tolerance": tol}
            row.update(timed_pair(
                lambda: flash_attention_cuda(q, k, v, causal=causal,
                                             window=window),
                lambda: attention_ref(q, k, v, causal=causal, window=window),
                REPS))
            # one library call computes this function only without a window
            row["library_ms"] = None if window else time_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True), REPS)
            row["bound_ms"], row["bound_by"] = flash_bound_ms(
                b, h, kh, s, d, q.element_size(), causal, window)
            emit({"phase": "kernel", "kernel": "flash_attention", **row,
                  "card": self.card})
            rows[("flash_attention", (s, dt))] = row
            del q, k, v
            torch.cuda.empty_cache()

        # the kernels line: the main path's shapes (prefill; decode beside)
        def entry(name, source, replaces, main, decode=None):
            errs = [r["max_abs_err"] for (n, _), r in rows.items()
                    if n == name]
            out = {"name": name, "route": "cuda", "source": source,
                   "replaces": replaces, "launches": 0,
                   "max_abs_err": max(errs), "ms": main["ms"],
                   "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                   "bound_by": main["bound_by"],
                   "library_ms": main["library_ms"], "shape": main["shape"],
                   "dtype": main["dtype"], "card": self.card}
            if decode is not None:
                out.update({f"decode_{k}": decode[k] for k in (
                    "shape", "ms", "plain_ms", "bound_ms", "library_ms")})
            return out

        self.kernels["rms_norm"] = entry(
            "rms_norm", "src/repro_torch/csrc/rmsnorm.cu",
            "src/repro/kernels/rmsnorm/kernel.py:17",
            rows[("rms_norm", (2, 2048, 3072))],
            rows[("rms_norm", (8, 1, 3072))])
        self.kernels["flash_attention"] = entry(
            "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:23",
            rows[("flash_attention", (2048, "bfloat16"))])

    # -- phase 5: the dense model at full width, f32 ---------------------
    def dense_model_check(self):
        import dataclasses

        import numpy as np
        import torch
        from repro_torch import models as M
        from repro_torch.configs import get_config
        from repro_torch.kernels.flash_attention import attention_ref
        from repro_torch.models import attention as attn_mod

        cfg = dataclasses.replace(get_config(ARCH), dtype="float32",
                                  num_layers=CHECK_LAYERS)
        t0 = time.perf_counter()
        generator = torch.Generator(device="cuda")
        generator.manual_seed(0)
        model = M.init_params(cfg, generator)
        tokens = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, CHECK_SEQ), dtype=np.int32)).cuda()
        full, _ = M.forward(cfg, model, {"tokens": tokens})
        # the same forward with the plain attention in place of B3
        kernel_attention = attn_mod.flash_attention
        attn_mod.flash_attention = (
            lambda q, k, v, **kw: attention_ref(q, k, v, **kw))
        try:
            plain, _ = M.forward(cfg, model, {"tokens": tokens})
        finally:
            attn_mod.flash_attention = kernel_attention
        b3_rel = float((full - plain).abs().max() / plain.abs().max())
        del plain
        st = M.init_decode_state(cfg, 2, CHECK_SEQ, device="cuda")
        worst = torch.zeros((), device="cuda")
        for t in range(CHECK_SEQ):
            logits, st = M.decode_step(cfg, model, st, tokens[:, t])
            worst = torch.maximum(worst, (logits - full[:, t]).abs().max())
        rel = float(worst) / float(full.abs().max())
        finite = bool(torch.isfinite(full).all())
        self.check(finite, "model check: forward logits not finite")
        self.check(b3_rel <= MODEL_B3_RTOL,
                   f"model check: B3 vs plain attention {b3_rel}")
        self.check(rel < DECODE_RTOL,
                   f"model check: forward vs decode {rel} >= {DECODE_RTOL}")
        emit({"phase": "model_check", "arch": ARCH, "dtype": "float32",
              "layers": CHECK_LAYERS, "d_model": cfg.d_model,
              "batch": 2, "tokens": CHECK_SEQ,
              "b3_vs_plain_over_max_logits": b3_rel,
              "b3_limit": MODEL_B3_RTOL,
              "decode_vs_forward_over_max_logits": rel,
              "decode_limit": DECODE_RTOL,
              "seconds": time.perf_counter() - t0, "card": self.card})
        del model, full, st
        torch.cuda.empty_cache()

    def profile_decode(self, cfg, model, steps: int = 10):
        """Where a decode step's time goes: ``steps`` steps at the ragged
        run's batch, half way through its cache, under torch.profiler.
        Device time is the sum of the kernels' own times; its share of
        the host's wall clock is the device's busy share."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        from repro_torch import models as M

        st = M.init_decode_state(cfg, RAGGED["slots"], RAGGED["max_len"],
                                 device="cuda")
        st["pos"].fill_(RAGGED["max_len"] // 2)
        tokens = torch.zeros(RAGGED["slots"], dtype=torch.int32,
                             device="cuda")
        for _ in range(2):
            M.decode_step(cfg, model, st, tokens)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                M.decode_step(cfg, model, st, tokens)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()

        def device_us(e):
            return (getattr(e, "self_device_time_total", 0.0)
                    or getattr(e, "self_cuda_time_total", 0.0))

        total = sum(device_us(e) for e in events)
        top_device = sorted(events, key=device_us, reverse=True)[:8]
        top_host = sorted(events, key=lambda e: e.self_cpu_time_total,
                          reverse=True)[:10]
        emit({"phase": "decode_profile", "arch": ARCH,
              "slots": RAGGED["slots"], "cache_len": RAGGED["max_len"],
              "steps": steps, "profiled_ms_per_step": 1e3 * wall / steps,
              "device_ms_per_step": (total / 1e3 / steps if total
                                     else "not measured"),
              "device_busy_share": (total / 1e6 / wall if total
                                    else "not measured"),
              "top_device_us_per_step": [
                  [e.key[:60], device_us(e) / steps, e.count // steps]
                  for e in top_device if device_us(e)],
              "top_host_us_per_step": [
                  [e.key[:60], e.self_cpu_time_total / steps,
                   e.count // steps] for e in top_host],
              "card": self.card})
        del st

    # -- phase 6: the dense main path, full width and depth, bf16 --------
    def dense_main_path(self):
        import numpy as np
        import torch
        from repro_torch import models as M
        from repro_torch.configs import get_config
        from repro_torch.kernels.flash_attention.kernel import (
            flash_attention_cuda)
        from repro_torch.kernels.rmsnorm.kernel import rms_norm_cuda
        from repro_torch.launch.serve import serve
        from repro_torch.runtime import Request, ServingEngine

        cfg = get_config(ARCH)
        per_step = 2 * cfg.num_layers + 1  # ln1, ln2 a layer, final norm

        reset_all_launches()
        # 1. the serve entry point
        before = rms_norm_cuda.launches
        out, secs, ws, samples = metered(lambda: serve(
            ARCH, use_reduced=False, num_requests=8, slots=4,
            max_new_tokens=32))
        norms = rms_norm_cuda.launches - before
        emit({"phase": "serve", "arch": ARCH, "full": True,
              "requests": 8, "slots": 4, "max_new_tokens": 32,
              "seconds": secs, "wall_s": out["wall_s"],
              "completed": out["completed"], "steps": out["steps"],
              "occupancy": out["occupancy"],
              "decode_tokens": out["decode_tokens"],
              "total_tokens": out["total_tokens"],
              "tokens_per_s": out["total_tokens"] / out["wall_s"],
              "decode_tokens_per_s": out["tokens_per_s"],
              "metered_gpu_ws": ws, "trace_samples": samples,
              "j_per_token": ws / out["total_tokens"],
              "rms_norm_launches": norms, "energy_note": out["energy_note"],
              "card": self.card})
        self.check(out["completed"] == 8, "serve: not every request done")
        self.check(norms == per_step * out["steps"],
                   f"serve: {norms} rms_norm launches over {out['steps']} "
                   f"steps, want {per_step} a step")

        # 2. a ragged run through the engine
        generator = torch.Generator(device="cuda")
        generator.manual_seed(0)
        model = M.init_params(cfg, generator)
        rng = np.random.default_rng(RAGGED["seed"])
        lo, hi = RAGGED["prompt"]
        reqs = [Request(rid=i, prompt=rng.integers(
                    0, cfg.vocab_size, int(n)).tolist(),
                    max_new_tokens=RAGGED["max_new_tokens"])
                for i, n in enumerate(rng.integers(lo, hi + 1,
                                                   RAGGED["requests"]))]
        engine = ServingEngine(cfg, model, slots=RAGGED["slots"],
                               max_len=RAGGED["max_len"])
        finite = torch.ones((), dtype=torch.bool, device="cuda")
        step = engine._step

        def checked_step(model, state, tokens):
            logits, state = step(model, state, tokens)
            finite.logical_and_(torch.isfinite(logits).all())
            return logits, state

        engine._step = checked_step
        for r in reqs:
            engine.submit(r)
        before = rms_norm_cuda.launches
        done, secs, ws, samples = metered(engine.run)
        norms = rms_norm_cuda.launches - before
        st = engine.stats
        emit({"phase": "ragged", "arch": ARCH, **RAGGED,
              "seconds": secs, "completed": len(done), "steps": st.steps,
              "occupancy": st.occupancy,
              "prefill_tokens": st.prefill_tokens,
              "decode_tokens": st.decode_tokens,
              "tokens_per_s": st.total_tokens / secs,
              "decode_tokens_per_s": st.decode_tokens / secs,
              "ms_per_step": 1e3 * secs / st.steps,
              "metered_gpu_ws": ws, "trace_samples": samples,
              "j_per_token": ws / st.total_tokens,
              "rms_norm_launches": norms, "card": self.card})
        self.check(len(done) == RAGGED["requests"] and all(
            len(r.output) == RAGGED["max_new_tokens"] for r in done),
            "ragged: not every request generated its tokens")
        self.check(bool(finite), "ragged: decode logits not finite")
        self.check(norms == per_step * st.steps,
                   f"ragged: {norms} rms_norm launches over {st.steps} "
                   f"steps, want {per_step} a step")

        # 3. one forward (prefill) of 2 x 2048 tokens
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, PREFILL,
                                               dtype=np.int32)).cuda()
        n2, n3 = rms_norm_cuda.launches, flash_attention_cuda.launches
        (logits, _), secs, ws, samples = metered(
            lambda: M.forward(cfg, model, {"tokens": tokens}))
        n2 = rms_norm_cuda.launches - n2
        n3 = flash_attention_cuda.launches - n3
        ntok = PREFILL[0] * PREFILL[1]
        emit({"phase": "forward", "arch": ARCH, "batch": PREFILL[0],
              "tokens": PREFILL[1], "seconds": secs,
              "tokens_per_s": ntok / secs, "metered_gpu_ws": ws,
              "trace_samples": samples, "j_per_token": ws / ntok,
              "rms_norm_launches": n2, "flash_attention_launches": n3,
              "card": self.card})
        self.check(tuple(logits.shape) == PREFILL + (cfg.padded_vocab(),)
                   and bool(torch.isfinite(logits).all()),
                   "forward: logits not finite or of the wrong shape")
        self.check(n2 == per_step, f"forward: {n2} rms_norm launches")
        self.check(n3 == cfg.num_layers,
                   f"forward: {n3} flash_attention launches")

        # the main path's launches: serve, the ragged run and the forward
        for name, fn in (("rms_norm", rms_norm_cuda),
                         ("flash_attention", flash_attention_cuda)):
            self.kernels[name]["launches"] = fn.launches
            self.check(fn.launches > 0, f"{name} never launched on the "
                                        "dense main path")
        del logits
        # where a decode step's time goes; after the counts are read, since
        # its steps run on a made-up state and are not the main path
        self.profile_decode(cfg, model)
        del model, engine
        torch.cuda.empty_cache()

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    t_start = time.perf_counter()
    smoke = Smoke()
    for phase in (smoke.card_and_build, smoke.kernel_phase,
                  smoke.dense_kernel_phase, smoke.dense_model_check,
                  smoke.dense_main_path, smoke.main_path):
        try:
            phase()
        except Exception:
            traceback.print_exc()
            smoke.failures.append(f"{phase.__name__} raised")
            break
    seconds = time.perf_counter() - t_start
    smoke.check(seconds <= BUDGET_S, f"the run took {seconds} s, over its "
                                     f"budget of {BUDGET_S} s")
    emit({"phase": "done", "seconds": seconds, "failures": smoke.failures})
    if smoke.failures:
        return 1
    emit({"kernels": list(smoke.kernels.values())})
    print(smoke.card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
