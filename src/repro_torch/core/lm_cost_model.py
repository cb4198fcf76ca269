"""Analytic (napkin-math) cost model for LM cells on the production mesh.

This is the paper's *cheap verification environment* for the GPU-path GA:
fast closed-form time/energy per genome, derived from the same workload model
as the arithmetic-intensity analysis. The expensive XLA-compile verifier
(FPGA-path analogue) cross-checks the narrowed winners.

All byte/FLOP quantities are TOTALS across the slice; the roofline divides by
chip count.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field, replace
from typing import NamedTuple, Optional, Sequence

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.arithmetic_intensity import lm_unit_costs
from repro_torch.core.fitness import Measurement
from repro_torch.core.power import (
    HardwareSpec, RooflineTerms, TPU_V5E, TpuPowerModel,
)

BF16 = 2.0
F32 = 4.0


class CellInvariants(NamedTuple):
    """Decision-independent per-cell totals, shared across a whole GA batch
    (the expensive part of the analytic model is the unit-cost walk; a
    generation of genomes reuses one walk via the lru_cache below)."""

    fwd_flops: float      # forward FLOPs, all units
    attn_flops: float     # forward FLOPs of attention units only
    unit_bytes: float     # HBM bytes, all units (params + activations)
    kv_cache_bytes: float


@functools.lru_cache(maxsize=4096)
def cell_invariants(cfg: ArchConfig, shape: ShapeSpec) -> CellInvariants:
    units = lm_unit_costs(cfg, shape)
    return CellInvariants(
        fwd_flops=sum(u.total_flops for u in units),
        attn_flops=sum(u.total_flops for u in units if "attention" in u.name),
        unit_bytes=sum(u.total_bytes for u in units),
        kv_cache_bytes=(_kv_cache_bytes(cfg, shape)
                        if shape.kind == "decode" else 0.0),
    )


@dataclass(frozen=True)
class Decisions:
    """Genome-controlled execution decisions for an LM cell."""

    remat: str = "full"            # none | dots | full
    attn_impl: str = "flash"       # flash (block-skipping) | xla (masked full)
    overlap: bool = True           # overlap compute with collectives
    accum: int = 0                 # 0 => config default
    fsdp_params: bool = True       # ZeRO-3 param sharding over data axis
    matmul_precision: str = "bf16"  # bf16 | f32_accum
    expert_parallel: str = "tp"    # tp (expert-TP) — see DESIGN.md §5
    seq_shard_decode: bool = True  # shard KV seq over model axis at decode
    clock: float = 1.0             # DVFS core-clock fraction (1.0 = nominal)
    # clock < 1 stretches compute time by 1/f but scales MXU dynamic power by
    # ~f^3 (P ∝ f·V², V ∝ f), so MXU *energy* falls by ~f² while idle energy
    # grows with the longer step — the time-vs-energy tradeoff the paper's
    # power-reduction objective actually navigates. HBM/ICI clocks are
    # independent domains and stay nominal.


@dataclass
class CellCost:
    terms: RooflineTerms
    step_time: float
    energy: float
    breakdown: dict
    fits: bool
    bytes_per_device: float


def _mesh_sizes(mesh_shape: dict[str, int]) -> tuple[int, int, int]:
    pod = mesh_shape.get("pod", 1)
    data = mesh_shape.get("data", 1)
    model = mesh_shape.get("model", 1)
    return pod, data, model


def analyze_cell(
    cfg: ArchConfig,
    shape: ShapeSpec,
    mesh_shape: dict[str, int],
    dec: Decisions = Decisions(),
    hw: HardwareSpec = TPU_V5E,
    power: TpuPowerModel = TpuPowerModel(),
) -> CellCost:
    pod, data, model = _mesh_sizes(mesh_shape)
    chips = pod * data * model
    dp = pod * data
    inv = cell_invariants(cfg, shape)
    tokens = shape.tokens()
    train = shape.kind == "train"
    accum = dec.accum or cfg.accum

    # ---------------- FLOPs ----------------
    fwd = inv.fwd_flops
    if dec.attn_impl == "xla" and not cfg.sliding_window and shape.kind != "decode":
        # masked full attention computes the upper triangle too (2x sdpa)
        fwd = fwd + inv.attn_flops  # sdpa is ~the whole attention unit at long ctx
    flops = fwd * (3.0 if train else 1.0)
    if train:
        refwd = {"none": 0.0, "dots": 0.35, "full": 1.0}[dec.remat]
        flops += fwd * refwd
        flops += 10.0 * cfg.param_count()  # optimizer elementwise
    if dec.matmul_precision == "f32_accum":
        flops *= 1.0  # same MACs; throughput penalty applied below
    eff_peak = hw.peak_flops * (0.5 if dec.matmul_precision == "f32_accum" else 1.0)
    eff_peak *= dec.clock  # DVFS: compute throughput scales with core clock

    # Head-replication waste (heads not dividing the model axis) is tracked
    # only by the HLO probe; the analytic model deliberately excludes it.

    # ---------------- HBM bytes ----------------
    p_bytes = cfg.param_count() * BF16
    act_bytes = inv.unit_bytes - p_bytes  # activation streams
    act_bytes = max(act_bytes, 0.0)
    hbm = p_bytes + act_bytes
    if train:
        # grads (rw), optimizer m,v (rw), params written, + backward acts
        opt_bytes = cfg.param_count() * (F32 * 4 + BF16)
        hbm = p_bytes * accum + act_bytes * 2.5 + opt_bytes
        if dec.remat == "full":
            hbm += act_bytes  # recompute re-reads
    kv_cache_bytes = inv.kv_cache_bytes
    if shape.kind == "decode":
        hbm += kv_cache_bytes  # read whole cache once per step (+ small write)

    # ---------------- collective bytes (wire, total) ----------------
    coll = 0.0
    layer_act = tokens * cfg.d_model * BF16  # boundary activation
    if shape.kind != "decode":
        if model > 1:
            # TP all-reduces: attn-out + mlp-out per layer, fwd (+bwd)
            n_ar = 2 * cfg.num_layers * (2 if train else 1)
            coll += n_ar * 2.0 * layer_act * (model - 1) / model
        if train and dp > 1:
            g_bytes = cfg.param_count() * BF16
            coll += 2.0 * g_bytes * (dp - 1)  # ring grad all-reduce
            if dec.fsdp_params:
                coll += 2.0 * p_bytes * (dp - 1)  # AG fwd + AG bwd
    else:
        if dec.seq_shard_decode and model > 1:
            # softmax-stat all-reduces over the seq-sharded cache: tiny
            n_attn = (cfg.num_layers if cfg.family not in ("ssm",) else 0)
            stat = shape.global_batch * max(cfg.num_heads, 1) * 8 * F32
            coll += n_attn * 2 * stat * (model - 1)
        if model > 1:
            v_stat = shape.global_batch * cfg.d_model * BF16
            coll += 2 * v_stat * (model - 1)  # logits combine

    # ---------------- memory fit ----------------
    state_bytes = cfg.param_count() * BF16
    if train:
        acc_b = {"float32": F32, "bfloat16": BF16}[cfg.accum_dtype]
        state_bytes = cfg.param_count() * (BF16 + F32 * 2 + (acc_b if accum > 1 else BF16))
    per_dev = state_bytes / chips
    if shape.kind == "decode":
        per_dev += kv_cache_bytes / chips
        per_dev += shape.global_batch * cfg.d_model * BF16  # small act
    else:
        mb_tokens = tokens / max(dp, 1) / max(accum if train else 1, 1)
        layers_live = cfg.num_layers if dec.remat != "none" else cfg.num_layers * 6
        per_dev += mb_tokens * cfg.d_model * BF16 * layers_live / max(model, 1)
    fits = per_dev < hw.hbm_bytes * 0.92

    terms = RooflineTerms(flops=flops, hbm_bytes=hbm, collective_bytes=coll,
                          chips=chips,
                          hw=HardwareSpec(hw.name, eff_peak, hw.hbm_bw,
                                          hw.ici_bw, hw.hbm_bytes, hw.vmem_bytes))
    if dec.clock != 1.0:
        # dynamic MXU power ∝ f·V² with V ∝ f; active time already stretched
        # by 1/f through eff_peak, so MXU energy nets out to ~f².
        power = replace(power, p_mxu=power.p_mxu * dec.clock ** 3)
    t = terms.step_time(overlap=dec.overlap)
    e = terms.energy(power, overlap=dec.overlap)
    return CellCost(
        terms=terms, step_time=t, energy=e, fits=fits,
        bytes_per_device=per_dev,
        breakdown={
            "flops": flops, "hbm_bytes": hbm, "collective_bytes": coll,
            "t_compute": terms.t_compute, "t_memory": terms.t_memory,
            "t_collective": terms.t_collective, "dominant": terms.dominant(),
            "chips": chips, "per_device_bytes": per_dev,
        })


def _kv_cache_bytes(cfg: ArchConfig, shape: ShapeSpec) -> float:
    b = shape.global_batch
    if cfg.family == "ssm":
        return (cfg.num_layers * b
                * cfg.rwkv_heads * cfg.rwkv_head_size ** 2 * F32)
    length = min(shape.seq_len, cfg.sliding_window or shape.seq_len)
    hd = cfg.resolved_head_dim
    if cfg.family == "hybrid":
        ng = cfg.num_layers // (cfg.attn_every or cfg.num_layers)
        ssm = cfg.num_layers * b * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * F32
        return ssm + ng * b * length * cfg.num_kv_heads * hd * 2 * BF16
    n_layers = cfg.num_layers * (2 if cfg.is_encdec else 1)
    return n_layers * b * length * cfg.num_kv_heads * hd * 2 * BF16


def measure_cell(cfg: ArchConfig, shape: ShapeSpec, mesh_shape: dict[str, int],
                 dec: Decisions = Decisions(),
                 power: TpuPowerModel = TpuPowerModel()) -> Measurement:
    """Analytic verifier backend — Measurement for the GA's fitness."""
    cost = analyze_cell(cfg, shape, mesh_shape, dec, power=power)
    if not cost.fits:
        return Measurement(time_s=cost.step_time, energy_ws=cost.energy,
                           feasible=False, detail=cost.breakdown)
    return Measurement(time_s=cost.step_time, energy_ws=cost.energy,
                       avg_watts=cost.energy / max(cost.step_time, 1e-12)
                       / cost.terms.chips,
                       detail=cost.breakdown)


# ---------------------------------------------------------------------------
# Batched-evaluation hooks (EvalEngine substrate; see core/evaluator.py)
# ---------------------------------------------------------------------------


def canonical_decisions(cfg: ArchConfig, dec: Decisions) -> Decisions:
    """Resolve config-dependent defaults so two genomes (or a genome and the
    paper-faithful baseline ``Decisions()``) that execute identically hash to
    the same cache entry. Today only ``accum=0 -> cfg.accum`` resolves."""
    return replace(dec, accum=dec.accum or cfg.accum)


def cell_cache_key(cfg: ArchConfig, shape: ShapeSpec,
                   mesh_shape: dict[str, int], dec: Decisions,
                   power: TpuPowerModel = TpuPowerModel()):
    """Semantic cross-cell cache key: exactly the inputs that determine
    ``measure_cell``'s output, with decisions canonicalized. Two fleet cells
    sharing (arch, shape, mesh, power) — e.g. multi-start GA restarts —
    share every measurement through this key."""
    return ("lm_cell", cfg, shape, tuple(sorted(mesh_shape.items())),
            canonical_decisions(cfg, dec), power)


def measure_cell_batch(cfg: ArchConfig, shape: ShapeSpec,
                       mesh_shape: dict[str, int],
                       decs: Sequence[Decisions],
                       power: TpuPowerModel = TpuPowerModel()
                       ) -> list[Measurement]:
    """Bulk-measure hook for ``VectorizedExecutor``: one dispatch per GA
    generation. Today this is the same per-decision arithmetic as
    ``measure_cell`` (the shared unit-cost walk is lru-cached either way),
    so batched and serial evaluation are bit-identical and roughly
    equally fast — the value of the hook is the *batch boundary* itself,
    the extension point where a numpy-vectorized model or a remote
    bulk-measurement API plugs in without touching the GA or engine."""
    return [measure_cell(cfg, shape, mesh_shape, d, power=power)
            for d in decs]
