"""Mamba2 (SSD) block: the chunked state-space scan, as PyTorch ops.

Counterpart of the JAX package's ``models/ssm.py``. The reference computes
the scan in jnp, with no Pallas kernel, so the port keeps it as PyTorch
ops: prefill in the state-space-duality chunked form (quadratic,
attention-like math within a chunk, the (heads, head_dim, state)
recurrence carried across chunks), decode as one O(1) state update.

The reference runs its chunks in a ``lax.scan`` (``mode="exec"``) or
unrolled (``"probe"``); both modes are the same computation here. The
intra-chunk terms of all chunks are formed at once in (batch, chunk, head,
i, j) order, so that each product is one batched matmul, and only the
carried state runs a loop over the chunks. The segment decay
exp(cum_i - cum_j) is formed for j <= i only: the logits above the
diagonal are set to -inf before the ``exp`` (the reference drops them with
``jnp.where``), so an overflow there never meets a multiply (inf * 0 would
be NaN).

Decode state (``init_ssm_state``), per layer: ``ssm`` (B, H, hd, N) f32 and
``conv`` (B, K-1, C), the last K-1 inputs of the depthwise conv.
``mamba_decode_step`` updates both in place. The reference starts ``conv``
in bf16 but returns it in the input's dtype from its first step on (its
``_causal_conv`` slices the concatenation in x's dtype), so in a float32
model it carries f32 after one step. The port holds ``conv`` in the model's
dtype from the start, which is the reference's dtype from its first step
on: the initial zeros are exact in either, and an in-place write into a
bf16 buffer would round values that the reference keeps in f32.

In a mesh step's model-parallel region a block may hold this rank's heads
of ``A_log``, ``D``, ``dt_bias``, ``norm_scale`` and ``out_proj``'s rows
(``A_log`` shorter than the config's heads). ``in_proj``'s output is z |
x | B | C | dt and the conv's channels x | B | C, so a plain chunk of
either is not a rank's heads: they come whole, and the rank takes its
heads' z, x and dt columns and all of B and C (``_head_columns``). Its
input ``enter``s, the scan runs over its heads, the gated norm's mean of
squares over all of ``d_inner`` is a sum all-reduced both ways
(``model_sum``), and ``out_proj``'s partial sums ``leave``. ``in_proj``,
``conv_w`` and ``conv_b`` then get a partial gradient on each rank. In a
mesh serve step ``mamba_decode_step`` splits the same way over this
rank's heads of ``ssm``; its ``conv`` state, whose channels are x | B | C,
comes whole for the step (a plain chunk of it is not a rank's heads).
Under a sequence split of the residual stream (``sharding.seq_parallel``,
Megatron-SP) the block's input is this rank's rows: ``enter``
all-gathers the sequence, the conv and the scan run over the whole of
it, and ``out_proj``'s partial sums ``leave`` by a reduce-scatter into
this rank's rows; a block that keeps no heads gathers its input the same
way and takes its own rows of its output.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.parallel.sharding import (
    PDef, enter, leave, model_index, model_sum,
)


def mamba_defs(cfg: ArchConfig) -> dict:
    d, di, ns, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * ns
    return {
        "in_proj": PDef((d, 2 * di + 2 * ns + nh), ("fsdp", "ssm_inner")),
        "conv_w": PDef((cfg.conv_kernel, conv_ch), (None, "ssm_inner")),
        "conv_b": PDef((conv_ch,), ("ssm_inner",), init="zeros"),
        "A_log": PDef((nh,), ("ssm_heads",), init="zeros"),
        "D": PDef((nh,), ("ssm_heads",), init="ones"),
        "dt_bias": PDef((nh,), ("ssm_heads",), init="zeros"),
        "norm_scale": PDef((di,), ("ssm_inner",), init="ones",
                           dtype=torch.float32),
        "out_proj": PDef((di, d), ("ssm_inner", "fsdp")),
    }


def _split_proj(zxbcdt: torch.Tensor, di: int, ns: int):
    z = zxbcdt[..., :di]
    xs = zxbcdt[..., di:2 * di]
    Bm = zxbcdt[..., 2 * di:2 * di + ns]
    Cm = zxbcdt[..., 2 * di + ns:2 * di + 2 * ns]
    dt = zxbcdt[..., 2 * di + 2 * ns:]
    return z, xs, Bm, Cm, dt


def _xbc(zxbcdt: torch.Tensor, di: int, ns: int) -> torch.Tensor:
    """The conv's input, the reference's concatenation of x, B and C: they
    lie side by side in the projection, so a view of it."""
    return zxbcdt[..., di:2 * di + 2 * ns]


def _split_xbc(xbc: torch.Tensor, di: int, ns: int):
    return xbc[..., :di], xbc[..., di:di + ns], xbc[..., di + ns:]


def _head_proj(cfg: ArchConfig, p, nh: int) -> torch.Tensor:
    """This model rank's ``nh`` heads' columns of the whole ``in_proj``:
    its z, x and dt columns and all of B and C, in z | x | B | C | dt
    order."""
    di, ns = cfg.d_inner, cfg.ssm_state
    w = nh * cfg.ssm_head_dim
    r = model_index()
    z, xs = slice(r * w, (r + 1) * w), slice(di + r * w, di + (r + 1) * w)
    bc = slice(2 * di, 2 * di + 2 * ns)
    dt = slice(2 * di + 2 * ns + r * nh, 2 * di + 2 * ns + (r + 1) * nh)
    proj = p["in_proj"]
    return torch.cat([proj[:, z], proj[:, xs], proj[:, bc], proj[:, dt]],
                     dim=1)


def _head_columns(cfg: ArchConfig, p, nh: int):
    """This model rank's ``nh`` heads' share of the whole ``in_proj``,
    ``conv_w`` and ``conv_b``: its z, x and dt columns and all of B and C,
    in the z | x | B | C | dt (x | B | C) order the block reads."""
    di, ns = cfg.d_inner, cfg.ssm_state
    w = nh * cfg.ssm_head_dim
    r = model_index()
    in_proj = _head_proj(cfg, p, nh)
    cx, cbc = slice(r * w, (r + 1) * w), slice(di, di + 2 * ns)
    # x's channels lead the conv's
    conv_w = torch.cat([p["conv_w"][:, cx], p["conv_w"][:, cbc]], dim=1)
    conv_b = torch.cat([p["conv_b"][cx], p["conv_b"][cbc]])
    return in_proj, conv_w, conv_b


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv. x: (B,S,C), w: (K,C), state: (B,K-1,C) or
    None. Returns (silu(y), new_state), in x's dtype, with the reference's
    order of sums (tap 0 first, the bias last); new_state is a view of the
    padded input."""
    k, s = w.shape[0], x.shape[1]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+K-1, C)
    y = xp[:, :s] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i]
    y = y + b
    new_state = xp[:, -(k - 1):] if k > 1 else torch.zeros_like(pad)
    return F.silu(y), new_state


def _gated_norm(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float, width: Optional[int] = None) -> torch.Tensor:
    """x * silu(z), RMS-normalised in f32 with a (d_inner,) scale, cast back
    to x's dtype. Inline jnp in the reference, so PyTorch ops here, not B2.
    With x narrower than ``width`` (this model rank's heads of d_inner) the
    mean of squares is over all of ``width``: the ranks' sums all-reduced."""
    x = x * F.silu(z.float()).to(x.dtype)
    xf = x.float()
    if width is None or x.shape[-1] == width:
        var = xf.square().mean(dim=-1, keepdim=True)
    else:
        var = model_sum(xf.square().sum(dim=-1, keepdim=True)) / width
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def mamba_apply(cfg: ArchConfig, p, x: torch.Tensor, *,
                mode: str = "exec") -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D). Chunked SSD scan in f32; ``mode`` is
    accepted for the reference's signature."""
    hd, ns = cfg.ssm_head_dim, cfg.ssm_state
    nh = p["A_log"].shape[0]  # this rank's heads
    di = nh * hd
    split = nh != cfg.ssm_heads
    x = enter(x, split)
    b, s, _ = x.shape
    cs = min(cfg.ssm_chunk, s)
    if s % cs:  # a chunk that does not divide S: one chunk of S
        cs = s
    nc = s // cs

    if split:
        in_proj, conv_w, conv_b = _head_columns(cfg, p, nh)
    else:
        in_proj, conv_w, conv_b = p["in_proj"], p["conv_w"], p["conv_b"]
    zxbcdt = x @ in_proj
    z, _, _, _, dt = _split_proj(zxbcdt, di, ns)
    xbc, _ = _causal_conv(_xbc(zxbcdt, di, ns), conv_w, conv_b)
    xs, Bm, Cm = _split_xbc(xbc, di, ns)

    dt = F.softplus(dt.float() + p["dt_bias"])  # (B,S,H)
    A = -torch.exp(p["A_log"].float())  # (H,)
    xh = xs.reshape(b, s, nh, hd)
    log_a = dt * A  # (B,S,H), negative: the log decay of each step

    # per chunk, heads before time: (B, nc, H, cs[, ...])
    xc = xh.float().reshape(b, nc, cs, nh, hd).transpose(2, 3)
    Bc = Bm.float().reshape(b, nc, cs, ns)
    Cc = Cm.float().reshape(b, nc, cs, ns)
    dtc = dt.reshape(b, nc, cs, nh).transpose(2, 3)
    cum = log_a.reshape(b, nc, cs, nh).transpose(2, 3).cumsum(dim=-1)

    # intra-chunk: y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
    seg = cum[..., :, None] - cum[..., None, :]  # (B,nc,H,i,j)
    upper = torch.ones((cs, cs), dtype=torch.bool,
                       device=x.device).triu(diagonal=1)
    seg.masked_fill_(upper, float("-inf")).exp_()
    cb = Cc @ Bc.transpose(-1, -2)  # (B,nc,i,j)
    w = cb[:, :, None] * seg
    w.mul_(dtc[..., None, :])
    del seg
    y = w @ xc  # (B,nc,H,cs,hd)
    del w

    # across chunks: the state entering chunk c, decayed into each step
    tail = torch.exp(cum[..., -1:] - cum) * dtc  # decay from j to the end
    contrib = (xc * tail[..., None]).transpose(-1, -2) @ Bc[:, :, None]
    chunk_decay = torch.exp(cum[..., -1])  # (B,nc,H)
    state = torch.zeros((b, nh, hd, ns), dtype=torch.float32,
                        device=x.device)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * chunk_decay[:, c, :, None, None] + contrib[:, c]
    states = torch.stack(entering, dim=1)  # (B,nc,H,hd,N)
    y_state = Cc[:, :, None] @ states.transpose(-1, -2)  # (B,nc,H,cs,hd)
    y = y + y_state * torch.exp(cum)[..., None]

    y = y.transpose(2, 3).reshape(b, s, nh, hd)
    y = y + p["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(b, s, di).to(x.dtype)
    y = _gated_norm(y, z, p["norm_scale"], cfg.norm_eps, cfg.d_inner)
    return leave(y @ p["out_proj"], split)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_ssm_state(cfg: ArchConfig, batch: int, *, device=None) -> dict:
    """One layer's decode state: ``ssm`` (B, H, hd, N) f32 and ``conv``
    (B, K-1, C) in the model's dtype (the module docstring says why)."""
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                            cfg.ssm_state), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, conv_ch),
                            dtype=getattr(torch, cfg.dtype), device=device),
    }


def _whole_xbc(cfg: ArchConfig, xbc: torch.Tensor) -> torch.Tensor:
    """The conv's whole input row (B, 1, d_inner + 2·ssm_state) from this
    model rank's ``xbc``, its heads' x channels and all of B and C: each
    rank puts its x channels (and rank 0 B and C) into zeros, and ``leave``
    sums the ranks' rows, which adds each value to zeros only: exact."""
    di = cfg.d_inner
    w = xbc.shape[-1] - 2 * cfg.ssm_state
    r = model_index()
    row = xbc.new_zeros(xbc.shape[:-1] + (di + 2 * cfg.ssm_state,))
    row[..., r * w:(r + 1) * w] = xbc[..., :w]
    if r == 0:
        row[..., di:] = xbc[..., w:]
    return leave(row)


def mamba_decode_step(cfg: ArchConfig, p, x: torch.Tensor, state: dict
                      ) -> tuple[torch.Tensor, dict]:
    """x: (B, 1, D) -> ((B, 1, D), state): one token, O(1). ``state``'s
    ``ssm`` and ``conv`` are updated in place and returned.

    With this model rank's heads (``A_log`` shorter than the config's
    heads), ``ssm`` is this rank's heads and ``conv`` stays whole: the
    rank projects its z, x and dt columns and all of B and C, the ranks'
    x channels are joined into the conv's whole input row
    (``_whole_xbc``), every rank updates the whole ``conv`` alike, and the
    scan, the gated norm (its mean of squares over all of d_inner a
    ``model_sum``) and ``out_proj``'s partial sums (``leave``) run on its
    heads."""
    b = x.shape[0]
    hd, di, ns = cfg.ssm_head_dim, cfg.d_inner, cfg.ssm_state
    nh = p["A_log"].shape[0]  # this rank's heads
    split = nh != cfg.ssm_heads
    if split:
        x = enter(x)
        w = nh * hd
        zxbcdt = x @ _head_proj(cfg, p, nh)
        z, _, _, _, dt = _split_proj(zxbcdt, w, ns)
        row = _whole_xbc(cfg, _xbc(zxbcdt, w, ns))
    else:
        zxbcdt = x @ p["in_proj"]
        z, _, _, _, dt = _split_proj(zxbcdt, di, ns)
        row = _xbc(zxbcdt, di, ns)
    xbc, conv = _causal_conv(row, p["conv_w"], p["conv_b"], state["conv"])
    state["conv"].copy_(conv)
    xs, Bm, Cm = _split_xbc(xbc, di, ns)
    if split:  # this rank's heads' x channels
        r = model_index()
        xs = xs[..., r * w:(r + 1) * w]
    dt = F.softplus(dt.float() + p["dt_bias"])[:, 0]  # (B,H)
    A = -torch.exp(p["A_log"].float())
    xh = xs.reshape(b, nh, hd).float()
    Bf = Bm[:, 0].float()  # (B,N)
    Cf = Cm[:, 0].float()
    ssm = state["ssm"]
    ssm.mul_(torch.exp(dt * A)[:, :, None, None])
    ssm.add_((dt[:, :, None] * xh)[..., None] * Bf[:, None, None, :])
    y = (ssm @ Cf[:, None, :, None])[..., 0]  # (B,H,hd)
    y = y + p["D"].float()[None, :, None] * xh
    y = y.reshape(b, 1, nh * hd).to(x.dtype)
    y = _gated_norm(y, z, p["norm_scale"], cfg.norm_eps, di)
    y = y @ p["out_proj"]
    return (leave(y) if split else y), state
