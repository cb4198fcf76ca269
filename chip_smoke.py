#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Builds kernel B1 (the Himeno Jacobi sweep, ``src/repro_torch/csrc/
himeno.cu``) with nvcc for sm_90a, holds both of its entries against their
plain PyTorch versions on the card, then drives the port's main path — the
paper's GA offload loop — at the paper's L grid (512x256x256):

1. ``himeno_run`` (the solver entry, kernel ``himeno_sweep``);
2. Fig. 5: ``MeteredBackend.auto(HimenoMeasuredBackend(HimenoApp(L)))`` for
   the all-CPU placement and the paper's pattern (``LOOP_UNITS`` on the
   card), with power read from the machine's counters;
3. ``search_himeno`` over that metered measured backend.

The kernels' launch counts are set to 0 just before the main path and read
just after. Every phase prints one JSON line; the line before the last is
the card's name and power limit as ``nvidia-smi`` gives them, the last line
is ``{"ok": true, "device": {...}}``. Any failed check exits non-zero
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
        from repro_torch.kernels.himeno import kernel

        lines = smi("name,power.limit")
        self.card = lines[0] if lines else "not read"
        emit({"phase": "card", "card": self.card,
              "nvidia_smi_gpus": len(lines),
              "torch_device": torch.cuda.get_device_name(0),
              "torch_device_count": torch.cuda.device_count(),
              "torch": torch.__version__, "cuda": torch.version.cuda})
        t0 = time.perf_counter()
        path = kernel.build()
        kernel.load_library()
        seconds = time.perf_counter() - t0
        # registers, shared and local memory of each kernel, from the binary
        cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        usage = subprocess.run([cuobjdump, "--dump-resource-usage", str(path)],
                               capture_output=True, text=True, timeout=60)
        emit({"phase": "build", "seconds": seconds, "library": path.name,
              "resource_usage": [ln.strip() for ln in usage.stdout.splitlines()
                                 if "REG:" in ln]})

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

        kernel.reset_launches()
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    t_start = time.perf_counter()
    smoke = Smoke()
    for phase in (smoke.card_and_build, smoke.kernel_phase, smoke.main_path):
        try:
            phase()
        except Exception:
            traceback.print_exc()
            smoke.failures.append(f"{phase.__name__} raised")
            break
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "failures": smoke.failures})
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
