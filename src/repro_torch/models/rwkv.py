"""RWKV6 ("Finch") block: linear attention with data-dependent decay.

Counterpart of the JAX package's ``models/rwkv.py``. Recurrence per head
(k-dim decay, hd = rwkv_head_size):
    out_t = r_t · (S_{t-1} + diag(u) k_t v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T ,  w_t = exp(-exp(w0 + lora(x_t)))

The reference computes prefill in a chunked parallel form (``_wkv_chunk``)
that takes exp(-cum) of a chunk's summed log-decays and overflows f32 under
strong decay; the port runs every WKV, prefill and decode alike, through
kernel B4 (``kernels/wkv``): a prefill at head dim 64 on its chunked
tensor-core kernel, which forms no exponent, decode and head dim 16 on the
sequential one, so ``ssm_chunk`` changes nothing here. Under a gradient
(training) the WKV goes through ``WkvFn``: B4's forward, then B4's
backward kernel. Decode carries (S, last_x): O(1) a token. The
per-head RMS norm with its (H, hd) scale stays torch ops, as it is inline
jnp in the reference (B2 takes one scale vector).

In a mesh step's model-parallel region the time mix may hold this rank's
heads of ``w_r``, ``w_k``, ``w_v``, ``w_g`` (columns), ``w_o`` (rows),
``bonus_u`` and ``ln_wkv`` (``w_r`` narrower than ``d_model``): its input
``enter``s, the token shift, the mixes and the decay LoRA's first product
are computed whole, the LoRA's second product and ``decay_base`` only on
this rank's channels, B4 and the per-head norm run on its heads, and the
output projection's partial sums ``leave``. So ``mu``, ``decay_base``,
``decay_A`` and ``decay_B`` get a partial gradient on each rank. The
channel mix may hold this rank's ffn columns of ``c_k`` and rows of
``c_v``: the k mix ``enter``s, ``c_k``/``c_v``'s partial output
``leave``s, and the receptance (``c_r``, whole) gates the sum.

Under a sequence split of the residual stream (``sharding.seq_parallel``,
Megatron-SP) each mix's input is this rank's rows. The token shift reads
the row before, so both mixes ``enter`` their input first, an all-gather
of the sequence: the time mix then runs as above and its output
``leave``s by a reduce-scatter into this rank's rows; the channel mix
computes its mixes and its receptance over the whole sequence, and the
receptance gates each rank's partial ``c_v`` output before the
reduce-scatter, so that every gradient inside the region is partial:
``mu_c`` and ``c_r`` then get a partial gradient too. A mix with whole
leaves gathers its input the same way and takes its own rows of its
output.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.wkv.ops import wkv
from repro_torch.parallel.sharding import (
    PDef, current_seq_split, enter, leave, model_index,
)


def rwkv_defs(cfg: ArchConfig) -> dict:
    d, r = cfg.d_model, cfg.rwkv_decay_rank
    f = cfg.d_ff
    h = cfg.rwkv_heads
    return {
        # time mix
        "mu": PDef((5, d), (None, "unsharded"), init="zeros"),  # r,k,v,g,w
        "w_r": PDef((d, d), ("fsdp", "rwkv_heads")),
        "w_k": PDef((d, d), ("fsdp", "rwkv_heads")),
        "w_v": PDef((d, d), ("fsdp", "rwkv_heads")),
        "w_g": PDef((d, d), ("fsdp", "rwkv_heads")),
        "w_o": PDef((d, d), ("rwkv_heads", "fsdp")),
        "decay_base": PDef((d,), ("unsharded",), init="zeros",
                           dtype=torch.float32),
        "decay_A": PDef((d, r), ("fsdp", None)),
        "decay_B": PDef((r, d), (None, "fsdp")),
        "bonus_u": PDef((h, cfg.rwkv_head_size), ("rwkv_heads", None),
                        init="zeros", dtype=torch.float32),
        "ln_wkv": PDef((h, cfg.rwkv_head_size), ("rwkv_heads", None),
                       init="ones", dtype=torch.float32),
        # channel mix
        "mu_c": PDef((2, d), (None, "unsharded"), init="zeros"),  # k,r
        "c_k": PDef((d, f), ("fsdp", "ffn")),
        "c_v": PDef((f, d), ("ffn", "fsdp")),
        "c_r": PDef((d, d), ("fsdp", "unsharded")),
    }


def _token_shift(x: torch.Tensor,
                 last_x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x_{t-1} along seq; the first position takes last_x (or zeros)."""
    first = torch.zeros_like(x[:, :1]) if last_x is None else last_x[:, None]
    return torch.cat([first, x[:, :-1]], dim=1)


def _mix(x, xx, mu):
    return x + (xx - x) * mu.to(x.dtype)


def _decays(cfg: ArchConfig, p, xw: torch.Tensor,
            channels: slice = slice(None)) -> torch.Tensor:
    """Log decays (negative) of ``channels``: (B,S,D) -> (B,S,C) float32."""
    lora = torch.tanh(xw.float() @ p["decay_A"].float())
    lora = lora @ p["decay_B"][:, channels].float()
    return -torch.exp(p["decay_base"][channels] + lora)  # log w


def rwkv_time_mix(cfg: ArchConfig, p, x: torch.Tensor, *, mode: str = "exec",
                  state: Optional[torch.Tensor] = None,
                  last_x: Optional[torch.Tensor] = None):
    """x: (B,S,D) -> (B,S,D). If ``state`` or ``last_x`` is given, returns
    (y, final state, x[:, -1]) instead; a given ``state`` (B,H,hd,hd) f32
    is updated in place and returned. ``mode`` is the reference's, which
    picks its chunk loop; the port has one path."""
    d = x.shape[2]
    hd = cfg.rwkv_head_size
    width = p["w_r"].shape[1]  # this rank's heads' channels
    h = width // hd
    split = width != d
    x = enter(x, split)
    b, s = x.shape[:2]
    xx = _token_shift(x, last_x)
    xr = _mix(x, xx, p["mu"][0])
    xk = _mix(x, xx, p["mu"][1])
    xv = _mix(x, xx, p["mu"][2])
    xg = _mix(x, xx, p["mu"][3])
    xw = _mix(x, xx, p["mu"][4])

    def heads(t):  # (B,S,D) -> (B,H,S,hd) f32, a view where x is f32
        return t.reshape(b, s, h, hd).transpose(1, 2).float()

    r = heads(xr @ p["w_r"])
    k = heads(xk @ p["w_k"])
    v = heads(xv @ p["w_v"])
    g = xg @ p["w_g"]
    mine = slice(model_index() * width, (model_index() + 1) * width)
    lw = heads(_decays(cfg, p, xw, mine if split else slice(None)))
    out, st = wkv(r, k, v, lw, p["bonus_u"], state=state,
                  chunk=cfg.ssm_chunk)

    # per-head rms norm (GroupNorm stand-in), then gate
    var = torch.mean(torch.square(out), dim=-1, keepdim=True)
    out = out * torch.rsqrt(var + cfg.norm_eps) * p["ln_wkv"][None, :, None, :]
    out = out.transpose(1, 2).reshape(b, s, width)
    out = out.to(x.dtype) * F.silu(g)
    y = leave(out @ p["w_o"], split)
    if state is not None or last_x is not None:
        return y, st, x[:, -1]
    return y


def rwkv_channel_mix(cfg: ArchConfig, p, x: torch.Tensor,
                     last_x: Optional[torch.Tensor] = None):
    split = p["c_k"].shape[1] != cfg.d_ff
    seq = current_seq_split() is not None
    if seq:  # the token shift reads the whole sequence
        x = enter(x, split)
    xx = _token_shift(x, last_x)
    xk = _mix(x, xx, p["mu_c"][0])
    xr = _mix(x, xx, p["mu_c"][1])
    if split and not seq:
        xk = enter(xk)
    k = torch.square(F.relu(xk @ p["c_k"]))
    kv = k @ p["c_v"]
    r = torch.sigmoid(xr @ p["c_r"])
    if seq:  # each rank's partial kv gated, then scattered into its rows
        out = leave(r * kv, split)
    else:
        out = r * (leave(kv) if split else kv)
    if last_x is not None:
        return out, x[:, -1]
    return out


# ---------------------------------------------------------------------------
# Decode state
# ---------------------------------------------------------------------------

def init_rwkv_state(cfg: ArchConfig, batch: int, device=None) -> dict:
    """One layer's decode state. ``tm_x`` and ``cm_x`` are bf16 in every
    model, as in the reference."""
    h, hd = cfg.rwkv_heads, cfg.rwkv_head_size
    return {
        "wkv": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                           device=device),
        "tm_x": torch.zeros((batch, cfg.d_model), dtype=torch.bfloat16,
                            device=device),
        "cm_x": torch.zeros((batch, cfg.d_model), dtype=torch.bfloat16,
                            device=device),
    }


def rwkv_decode_step(cfg: ArchConfig, p, x: torch.Tensor, state: dict):
    """x: (B,1,D). Returns (time-mix output, state): ``wkv`` is updated in
    place and ``tm_x`` replaced by the new last input, rounded to bf16."""
    y_t, wkv_state, tm_x = rwkv_time_mix(
        cfg, p, x, mode="probe", state=state["wkv"],
        last_x=state["tm_x"].to(x.dtype))
    return y_t, {"wkv": wkv_state, "tm_x": tm_x.to(torch.bfloat16),
                 "cm_x": state["cm_x"]}
