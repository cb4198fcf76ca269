"""Static arithmetic-intensity analysis — the ROSE-framework analogue (§3.2).

Produces per-offload-unit FLOPs / HBM bytes / trip counts / VMEM ("resource")
estimates from the workload model alone — no compilation. Used by:
  * the FPGA-path candidate narrowing (high-AI, high-trip-count units first),
  * the resource pre-check (VMEM/HBM fit before paying a compile),
  * the analytic verifier backend and MODEL_FLOPS for §Roofline.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.configs.base import ArchConfig, ShapeSpec


@dataclass(frozen=True)
class UnitCost:
    name: str
    flops: float            # per single execution of the unit
    hbm_bytes: float        # per single execution (reads + writes)
    trip_count: int         # executions per step (gcov/gprof analogue)
    vmem_bytes: float = 0.0  # working set a kernel must hold (FF/LUT analogue)
    parallel: bool = True   # a compiler could offload this (paper Step 2)

    @property
    def intensity(self) -> float:
        return self.flops / max(self.hbm_bytes, 1.0)

    @property
    def total_flops(self) -> float:
        return self.flops * self.trip_count

    @property
    def total_bytes(self) -> float:
        return self.hbm_bytes * self.trip_count


# ---------------------------------------------------------------------------
# LM workload model
# ---------------------------------------------------------------------------


def _attn_unit(cfg: ArchConfig, tokens: float, ctx: float, bytes_per: float,
               decode: bool) -> UnitCost:
    hd = cfg.resolved_head_dim
    h, k = cfg.num_heads, cfg.num_kv_heads
    d = cfg.d_model
    proj = 2 * tokens * d * (h + 2 * k) * hd + 2 * tokens * h * hd * d
    sdpa = 2 * tokens * ctx * h * hd * 2  # scores + values
    w_bytes = cfg._attn_params() * bytes_per
    act_bytes = tokens * d * bytes_per * 4
    if decode:
        # each sequence streams its full cache once per step
        kv_bytes = ctx * k * hd * bytes_per * 2 * tokens
    else:
        # flash blocking: KV streams once per QUERY CHUNK, not per token
        q_chunks = max(tokens / max(cfg.attn_chunk, 1), 1.0)
        kv_bytes = q_chunks * ctx * k * hd * bytes_per * 2
    return UnitCost("attention", proj + sdpa, w_bytes + act_bytes + kv_bytes, 1)


def _mlp_unit(cfg: ArchConfig, tokens: float, bytes_per: float) -> UnitCost:
    n_mat = 3 if cfg.mlp_type == "swiglu" else 2
    flops = 2 * tokens * n_mat * cfg.d_model * cfg.d_ff
    w = cfg._mlp_params() * bytes_per
    act = tokens * (cfg.d_model * 2 + cfg.d_ff) * bytes_per
    return UnitCost("mlp", flops, w + act, 1)


def _moe_unit(cfg: ArchConfig, tokens: float, bytes_per: float) -> UnitCost:
    routed = tokens * cfg.experts_per_token * cfg.capacity_factor
    flops = 2 * routed * 3 * cfg.d_model * cfg.d_ff
    flops += 2 * tokens * cfg.d_model * cfg.num_experts  # router
    w = cfg._moe_params_total() * bytes_per  # all experts stream from HBM
    act = routed * (cfg.d_model * 2 + cfg.d_ff) * bytes_per
    return UnitCost("moe", flops, w + act, 1)


def _ssm_unit(cfg: ArchConfig, tokens: float, bytes_per: float) -> UnitCost:
    d, di, ns, nh, hd = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                         cfg.ssm_heads, cfg.ssm_head_dim)
    cs = cfg.ssm_chunk
    flops = 2 * tokens * d * (2 * di + 2 * ns + nh)  # in_proj
    flops += 2 * tokens * di * d  # out_proj
    flops += 2 * tokens * cs * (nh * hd + ns)  # intra-chunk SSD
    flops += 4 * tokens * ns * nh * hd  # state in/out
    w = cfg._mamba_params() * bytes_per
    act = tokens * (d * 2 + 2 * di) * bytes_per
    return UnitCost("ssm", flops, w + act, 1)


def _rwkv_unit(cfg: ArchConfig, tokens: float, bytes_per: float) -> UnitCost:
    d, f, cs = cfg.d_model, cfg.d_ff, cfg.ssm_chunk
    hd = cfg.rwkv_head_size
    flops = 2 * tokens * d * d * 5  # r,k,v,g,o projections
    flops += 2 * tokens * d * cfg.rwkv_decay_rank * 2  # decay lora
    flops += 2 * tokens * cs * d * 2  # intra-chunk WKV (A build + A@v)
    flops += 4 * tokens * d * hd  # state in/out
    flops += 2 * tokens * (2 * d * f + d * d)  # channel mix
    w = cfg._rwkv_params() * bytes_per
    act = tokens * d * 6 * bytes_per
    return UnitCost("rwkv", flops, w + act, 1)


def _lm_head_unit(cfg: ArchConfig, tokens: float, bytes_per: float) -> UnitCost:
    v = cfg.padded_vocab()
    flops = 2 * tokens * cfg.d_model * v
    return UnitCost("lm_head", flops,
                    (v * cfg.d_model + tokens * v) * bytes_per, 1)


def lm_unit_costs(cfg: ArchConfig, shape: ShapeSpec) -> list[UnitCost]:
    """Per-unit forward-pass costs for one step of a cell (global, all chips)."""
    bytes_per = 2.0  # bf16
    decode = shape.kind == "decode"
    tokens = shape.tokens()
    if decode:
        ctx = min(shape.seq_len, cfg.sliding_window or shape.seq_len)
    else:
        ctx = min(shape.seq_len, cfg.sliding_window or shape.seq_len) / (
            1 if cfg.sliding_window else 2)  # causal halves average context

    units: list[UnitCost] = []
    emb = UnitCost("embed", 0.0, tokens * cfg.d_model * bytes_per, 1,
                   parallel=False)
    units.append(emb)

    if cfg.family == "ssm":
        u = _rwkv_unit(cfg, tokens, bytes_per)
        units.append(UnitCost(u.name, u.flops, u.hbm_bytes, cfg.num_layers))
    elif cfg.family == "hybrid":
        u = _ssm_unit(cfg, tokens, bytes_per)
        units.append(UnitCost(u.name, u.flops, u.hbm_bytes, cfg.num_layers))
        ng, _ = divmod(cfg.num_layers, cfg.attn_every or cfg.num_layers)
        a = _attn_unit(cfg, tokens, ctx, bytes_per, decode)
        units.append(UnitCost("attention", a.flops, a.hbm_bytes, max(ng, 1)))
    else:
        a = _attn_unit(cfg, tokens, ctx, bytes_per, decode)
        units.append(UnitCost(a.name, a.flops, a.hbm_bytes, cfg.num_layers))
        if cfg.num_experts:
            m = _moe_unit(cfg, tokens, bytes_per)
        else:
            m = _mlp_unit(cfg, tokens, bytes_per)
        units.append(UnitCost(m.name, m.flops, m.hbm_bytes, cfg.num_layers))
        if cfg.is_encdec:
            enc = _attn_unit(cfg, tokens, shape.seq_len, bytes_per, False)
            units.append(UnitCost("enc_attention", enc.flops, enc.hbm_bytes,
                                  cfg.encoder_layers))
            em = _mlp_unit(cfg, tokens, bytes_per)
            units.append(UnitCost("enc_mlp", em.flops, em.hbm_bytes,
                                  cfg.encoder_layers))
            x = _attn_unit(cfg, tokens, shape.seq_len, bytes_per, decode)
            units.append(UnitCost("cross_attention", x.flops, x.hbm_bytes,
                                  cfg.num_layers))

    norm = UnitCost("norms", 8 * tokens * cfg.d_model,
                    tokens * cfg.d_model * bytes_per * 2,
                    2 * cfg.num_layers)
    units.append(norm)
    units.append(_lm_head_unit(cfg, tokens, bytes_per))
    return units


def forward_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    return sum(u.total_flops for u in lm_unit_costs(cfg, shape))


def step_flops(cfg: ArchConfig, shape: ShapeSpec, remat: str = "none") -> float:
    """Forward / train-step FLOPs (train = fwd + 2×bwd [+ remat refwd])."""
    fwd = forward_flops(cfg, shape)
    if shape.kind != "train":
        return fwd
    mult = {"none": 3.0, "dots": 3.35, "full": 4.0}[remat]
    return fwd * mult + 10 * cfg.param_count()  # + optimizer elementwise


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """The §Roofline MODEL_FLOPS convention: 6·N·D train, 2·N·D inference,
    with N = active parameters (MoE) excluding embedding tables."""
    n_active = cfg.param_count(active=True) - cfg.padded_vocab() * cfg.d_model
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * shape.tokens()


# ---------------------------------------------------------------------------
# Himeno workload model (per sweep over an (I,J,K) grid)
# ---------------------------------------------------------------------------


def himeno_unit_costs(grid: tuple[int, int, int], iters: int = 1
                      ) -> list[UnitCost]:
    i, j, k = grid
    pts = float(i * j * k)
    interior = float((i - 2) * (j - 2) * (k - 2))
    b4 = 4.0  # f32
    init = lambda name, arrs: UnitCost(name, pts, arrs * pts * b4, 1)
    units = [
        init("init_p", 1),
        init("init_a012", 3),
        init("init_a3", 1),
        init("init_b", 3),
        init("init_c", 3),
        init("init_bnd", 1),
        init("init_wrk1", 1),
        init("init_wrk2", 1),
        # hot loop: 34 FLOPs/point, reads p(19-pt reuse≈1 stream)+11 coef arrays
        UnitCost("jacobi_stencil", 34 * interior, 13 * pts * b4, iters,
                 vmem_bytes=15 * j * k * b4),
        UnitCost("gosa_reduction", 2 * interior, interior * b4, iters,
                 vmem_bytes=j * k * b4),
        UnitCost("wrk2_write", 2 * interior, 2 * interior * b4, iters,
                 vmem_bytes=2 * j * k * b4),
        UnitCost("p_update", 0.0, 2 * interior * b4, iters,
                 vmem_bytes=2 * j * k * b4),
        UnitCost("final_residual", 2 * interior, interior * b4, 1),
    ]
    return units
