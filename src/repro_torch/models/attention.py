"""Attention: GQA/MQA/MHA, RoPE, sliding window; full-sequence
self-attention through kernel B3, cross-attention, and single-token decode
against a KV cache or a fixed memory.

Counterpart of the JAX package's ``models/attention.py``. Its ``attention()``
runs the einsum ``_sdpa`` over query chunks (``mode="exec"``, a scan, or
``"probe"``, unrolled); here self-attention in both modes is one call of
the flash kernel, which skips fully-masked KV tiles and reads each K/V head
for its H/K query heads itself, so nothing repeats K/V. Cross-attention
(``kv_x``: queries from ``x``, keys and values from the encoder's memory,
whose length may differ, no rope, no mask) and ``decode_attention`` stay
PyTorch ops, as the reference computes them with einsums outside any
kernel (B3 takes q and k/v of one length); both group the query heads over
the K/V heads rather than repeat K/V. ``decode_attention`` writes the new
K/V rows into the cache in place, or reads a fixed memory (``kv_memory``)
and writes nothing.

In a mesh step's model-parallel region ``attention`` may hold this rank's
query heads of ``wq``/``bq``/``wo`` (``wq`` narrower than the config's
heads): its inputs ``enter``, it projects and attends over those heads
only, and the output projection's partial sums ``leave``. Its K/V heads
are then this rank's too where ``wk``/``wv`` came split; where they came
whole (K not divisible by the model size, as MQA), the rank projects
every KV head and hands B3 the block its query heads read
(``kv_block``), so B3 and ``_grouped_sdpa`` see local heads only. Under
a sequence split of the residual stream (``sharding.seq_parallel``,
Megatron-SP) its input is this rank's rows: ``enter`` all-gathers the
sequence, so that B3 runs over the whole of it, and ``leave``
reduce-scatters the output projection's partial sums into this rank's
rows; attention with every head whole (its heads do not divide the model
size) gathers its input the same way and takes its own rows of its
output. Cross-attention's memory comes as this rank's rows where the
encoder's stream split too, and ``enter`` gathers it whole; a memory
whose length did not split comes whole (``memory_rows`` False).

In a prefill whose rules keep the blocks' inner sequence on "model" (the
reference's ``seq_inner``, ``SeqSplit.inner``), every head and leaf is
whole and attention runs on this rank's rows with no ``enter`` or
``leave``: q, K and V are projected from the rows, roped at their
positions in the whole sequence (the rank's offset, a VLM's patches
counted in it), K and V all-gathered along the sequence
(``sharding.seq_gather``), and B3 takes the rows' queries at their offset
against the whole K/V (``q_offset``, Sq != Sk); ``wo`` projects the rows.
Cross-attention takes its queries as rows and its memory whole (gathered
where it comes as rows).

In a mesh serve step the caches may be this rank's shard of their
sequence (``parallel/sharding.py`` ``kv_split``: the reference's
``kv_seq`` on "model", or on "data" and "model" at batch 1), with every
query head and ``wo`` whole, as the reference's ``act_heads`` None gives.
``decode_attention`` then writes a slot's new K/V row only into the
shard that holds its global index, masks the shard's rows by their global
indices, and combines the shards' softmax (flash-decode, ``_split_sdpa``):
the scores' max over the shards, their exponentials' sum under it, and
the partial products of the probabilities with V, each an all-reduce
over the ranks that hold the other shards. The probabilities are
normalised by the global sum before the product, so that they round to
v's dtype as the single device's softmax rounds them; a combine of
unnormalised partials rescaled by ``exp(m_r - M)`` would round the
output, not the probabilities, and part from it by a bf16 ulp. Outside
such a split the path is the single device's.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import NEG_INF
from repro_torch.models.layers import apply_rope
from repro_torch.parallel.sharding import (
    KvSplit, PDef, current_kv_split, current_seq_split, enter, leave,
    model_index, on_rows, seq_gather,
)

def attention_defs(cfg: ArchConfig, cross: bool = False) -> dict:
    d, h, k, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                   cfg.resolved_head_dim)
    defs = {
        "wq": PDef((d, h, hd), ("fsdp", "heads", None)),
        "wk": PDef((d, k, hd), ("fsdp", "kv_heads", None)),
        "wv": PDef((d, k, hd), ("fsdp", "kv_heads", None)),
        "wo": PDef((h, hd, d), ("heads", None, "fsdp")),
    }
    if cfg.qkv_bias and not cross:
        defs["bq"] = PDef((h, hd), ("heads", None), init="zeros")
        defs["bk"] = PDef((k, hd), ("kv_heads", None), init="zeros")
        defs["bv"] = PDef((k, hd), ("kv_heads", None), init="zeros")
    return defs


def _project_q(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    return q


def _project_kv(cfg: ArchConfig, p, x: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    return k, v


def kv_block(h: int, k: int, m: int, r: int) -> tuple[int, int]:
    """(first, count): the KV heads that model rank ``r``'s query heads
    ``[r·h/m, (r+1)·h/m)`` read, query head i reading KV head ``i //
    (h/k)``, where the ``k`` KV heads are not split over the ``m`` ranks.
    The block must serve the rank's heads evenly, as B3 reads it (local
    head j reads local KV head ``j // (heads / kv heads)``): else it
    raises."""
    hl, g = h // m, h // k
    if hl % g == 0:
        return r * hl // g, hl // g
    if g % hl == 0:
        return r * hl // g, 1
    raise ValueError(
        f"{h} query heads over {k} KV heads do not split over {m} model "
        f"ranks: a rank's {hl} query heads do not read a whole block of "
        f"KV heads")


def _local_kv(cfg: ArchConfig, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """k and v (B, T, K, hd) for this rank's query heads ``q`` (B, S, Hl,
    hd): as they are where they are this rank's KV heads already, else the
    block of ``kv_block``."""
    if q.shape[2] == cfg.num_heads or k.shape[2] != cfg.num_kv_heads:
        return k, v
    m = cfg.num_heads // q.shape[2]
    first, n = kv_block(cfg.num_heads, cfg.num_kv_heads, m, model_index())
    return k[:, :, first:first + n], v[:, :, first:first + n]


def _repeat_kv(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, T, K, hd) -> (B, T, H, hd) by repeating each KV head H/K times.
    The flash kernel does without it; kept for callers that need the
    reference's layout."""
    if x.shape[2] == num_heads:
        return x
    return x.repeat_interleave(num_heads // x.shape[2], dim=2)


def _causal_window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                        window: int) -> torch.Tensor:
    m = k_pos[None, :] <= q_pos[:, None]
    if window:
        m &= k_pos[None, :] > (q_pos[:, None] - window)
    return m


def _promote(a: torch.Tensor, b: torch.Tensor) -> torch.dtype:
    """The dtype JAX's einsum computes a mixed pair in (bf16 with f32 is
    f32); PyTorch's einsum takes one dtype only."""
    return torch.promote_types(a.dtype, b.dtype)


def _scores(q: torch.Tensor, k: torch.Tensor,
            mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, K, H/K, S, T) f32 scores of q (B, S, H, hd) against k (B, T, K,
    hd), each K head serving its H/K query heads: the einsum in the
    operands' (promoted) dtype, then cast to f32 and scaled, as the
    reference's einsum rounds bf16 scores before its cast; NEG_INF where
    ``mask`` (None or (B, T)) is False."""
    b, s, h, hd = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, s, kh, h // kh, hd)
    dt = _promote(qg, k)
    scores = torch.einsum("bqkgd,btkd->bkgqt", qg.to(dt),
                          k.to(dt)).float() * hd ** -0.5
    if mask is not None:
        scores = torch.where(mask[:, None, None, None, :], scores, NEG_INF)
    return scores


def _grouped_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The reference's ``_sdpa`` with each K/V head serving its H/K query
    heads in place of ``_repeat_kv``: q (B, S, H, hd), k and v (B, T, K,
    hd), ``mask`` None or (B, T). The scores are ``_scores``; softmax in
    f32, the probabilities cast to v's dtype. Returns (B, S, H, hd)."""
    probs = torch.softmax(_scores(q, k, mask), dim=-1).to(v.dtype)
    out = torch.einsum("bkgqt,btkd->bqkgd", probs, v)
    return out.reshape(q.shape)


def _split_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: Optional[torch.Tensor], split: KvSplit) -> torch.Tensor:
    """``_grouped_sdpa`` over a cache whose sequence is split into
    ``split.count`` shards, k and v (B, T/count, K, hd) this rank's, and
    ``mask`` its rows' (flash-decode). The scores are ``_scores``; the
    softmax takes their max over every shard (an all-reduce MAX), the sum
    of ``exp(s - M)`` over every shard (an all-reduce SUM), and the
    probabilities ``exp(s - M) / L`` cast to v's dtype; each shard's
    product with its V rows, in f32, is summed over the shards (an
    all-reduce SUM) and cast to v's dtype. A shard with no live row of a
    slot has every score NEG_INF, finite, so its exponentials are 0 under
    the global max, which a live row always sets (the slot's own row, or
    the unmasked memory). Returns (B, S, H, hd)."""
    scores = _scores(q, k, mask)
    m = split.reduce(scores.amax(dim=-1, keepdim=True), "max")
    e = torch.exp(scores - m)
    total = split.reduce(e.sum(dim=-1, keepdim=True), "sum")
    probs = (e / total).to(v.dtype)
    out = split.reduce(torch.einsum("bkgqt,btkd->bqkgd", probs.float(),
                                    v.float()), "sum")
    return out.to(v.dtype).reshape(q.shape)


# ---------------------------------------------------------------------------
# Full-sequence attention (train / prefill): kernel B3 for self-attention
# ---------------------------------------------------------------------------

def attention(
    cfg: ArchConfig,
    p,
    x: torch.Tensor,
    *,
    kv_x: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: int = 0,
    rope: bool = True,
    mode: str = "exec",
    positions: Optional[torch.Tensor] = None,
    memory_rows: Optional[bool] = None,
) -> torch.Tensor:
    """Self-attention (``kv_x`` None) over full sequences through the flash
    kernel (causal with an optional window, or full), or cross-attention
    over ``kv_x`` (B, T, D) as PyTorch ops, with no rope and no mask.
    ``mode`` is accepted for the reference's signature; both of its modes
    compute the same function. With this rank's query heads (a model
    split) the output is summed over the model ranks. Under a sequence
    split ``memory_rows`` says whether ``kv_x`` is this rank's rows of
    it too (None: as ``x``). Under prefill's ``seq_inner`` with whole
    heads (``on_rows``) ``x`` stays this rank's rows, from row
    ``index·rows`` of the whole sequence: no ``enter`` or ``leave``, K and
    V gathered along the sequence, B3 at that query offset."""
    split = p["wq"].shape[1] != cfg.num_heads
    rows = on_rows(split)  # seq_inner: this rank's rows, no enter/leave
    off = current_seq_split().index * x.shape[1] if rows else 0
    x = x if rows else enter(x, split)
    kv_x = None if kv_x is None else enter(kv_x, split, memory_rows)
    s = x.shape[1]
    q = _project_q(cfg, p, x)
    if kv_x is not None:
        if causal:
            raise ValueError("cross-attention takes no causal mask")
        k, v = _local_kv(cfg, q, *_project_kv(cfg, p, kv_x))
        out = torch.einsum("bshk,hkd->bsd", _grouped_sdpa(q, k, v, mask=None),
                           p["wo"])
        return out if rows else leave(out, split)
    k, v = _local_kv(cfg, q, *_project_kv(cfg, p, x))
    if rope:
        pos = (positions[..., off:off + s] if positions is not None
               else torch.arange(off, off + s, device=x.device))
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    if rows:  # every rank's rows read the whole sequence's K/V
        k, v = seq_gather(k), seq_gather(v)
    # (B, S, heads, hd) -> (B, heads, S, hd); K/V keep their K heads
    out = flash_attention(q.transpose(1, 2).contiguous(),
                          k.transpose(1, 2).contiguous(),
                          v.transpose(1, 2).contiguous(),
                          causal=causal, window=window if causal else 0,
                          q_offset=off)
    out = torch.einsum("bhsk,hkd->bsd", out, p["wo"])
    return out if rows else leave(out, split)


# ---------------------------------------------------------------------------
# Decode (single new token against a KV cache)
# ---------------------------------------------------------------------------

def cache_logical_axes() -> dict:
    return {
        "k": ("kv_batch", "kv_seq", "act_kv_heads", None),
        "v": ("kv_batch", "kv_seq", "act_kv_heads", None),
    }


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, window: int = 0,
                  *, device=None) -> dict:
    """Cache for ONE layer (callers stack over layers). Always bf16, whatever
    the model's dtype, as in the reference."""
    hd = cfg.resolved_head_dim
    length = min(max_len, window) if window else max_len
    shape = (batch, length, cfg.num_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
        "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
    }


def decode_attention(
    cfg: ArchConfig,
    p,
    x: torch.Tensor,
    cache: dict,
    pos,
    *,
    window: int = 0,
    kv_memory: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    rope: bool = True,
) -> tuple[torch.Tensor, dict]:
    """x: (B, 1, D); pos: the current position, a scalar or a (B,) vector of
    per-slot position streams. Returns (out, cache).

    The new K/V rows are written into ``cache["k"]``/``cache["v"]`` in place
    (index assignment at slot ``pos``, or ``pos % length`` in a
    sliding-window ring buffer), so the returned cache is the one passed in:
    the reference's functional ``.at[].set`` under a donated jit buffer.
    With ``kv_memory`` (k, v: (B, T, K, hd), an encoder's memory), the
    query attends to it unmasked and ``cache`` is returned untouched.
    Under a ``kv_split`` the cache and the memory are this rank's shard of
    their sequence (the module docstring says how the shards combine).
    """
    b = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device).expand(b)
    split = current_kv_split()

    q = _project_q(cfg, p, x)
    if rope:
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
    if kv_memory is not None:  # cross-attention: a fixed memory
        k, v = kv_memory
        mask = None
    else:
        k, v, mask = _write_cache(cfg, p, x, cache, pos, window=window,
                                  rope=rope, split=split)
    out = (_grouped_sdpa(q, k, v, mask=mask) if split is None
           else _split_sdpa(q, k, v, mask, split))
    dt = _promote(out, p["wo"])
    return torch.einsum("bshk,hkd->bsd", out.to(dt), p["wo"].to(dt)), cache


def _shard_rows(split: Optional[KvSplit], rows: int) -> tuple[int, int]:
    """(the global index of this shard's first row, the whole cache's
    rows) for a cache of ``rows`` rows here."""
    if split is None:
        return 0, rows
    return split.index * rows, split.count * rows


def _owned(live: torch.Tensor, slot: torch.Tensor,
           rows: int) -> torch.Tensor:
    """The live slots whose row ``slot`` (this shard's index of their
    global row) lies in this shard of ``rows`` rows."""
    return live & (slot >= 0) & (slot < rows)


def _write_cache(cfg: ArchConfig, p, x: torch.Tensor, cache: dict,
                 pos: torch.Tensor, *, window: int, rope: bool,
                 split: Optional[KvSplit] = None):
    """Write x's new K/V rows into ``cache`` in place; returns the cache's
    k, v and the (B, rows) mask of the rows each slot may see. With
    ``split`` the cache is this rank's shard of the sequence: a slot's row
    (``pos``, or ``pos % length`` in a ring) is written only where this
    shard holds it, and the mask reads the shard's global indices."""
    b = x.shape[0]
    k_new, v_new = _project_kv(cfg, p, x)
    if rope:
        k_new = apply_rope(k_new, pos[:, None], cfg.rope_theta)
    k, v = cache["k"], cache["v"]
    rows_here = k.shape[1]
    first, length = _shard_rows(split, rows_here)
    slot = (pos % length) if window else pos
    rows = torch.arange(b, device=x.device)
    # a slot whose stream ran past the cache (an idle serving slot keeps
    # stepping) writes nothing, as JAX drops an out-of-bounds scatter
    live = slot < length
    if split is not None:  # and only the shard that holds the row writes
        slot = slot - first
        live = _owned(live, slot, rows_here)
    live = live[:, None, None]
    slot = slot.clamp(min=None if split is None else 0, max=rows_here - 1)
    k[rows, slot] = torch.where(live, k_new[:, 0].to(k.dtype), k[rows, slot])
    v[rows, slot] = torch.where(live, v_new[:, 0].to(v.dtype), v[rows, slot])
    idx = torch.arange(first, first + rows_here, device=x.device)
    if window:
        # ring buffer: once wrapped, every slot holds one of the last
        # `length` positions; before wrapping only slots <= pos are live.
        mask = (idx[None, :] <= pos[:, None]) | (pos[:, None] >= length)
    else:
        # per-row causality doubles as slot-reset hygiene: rows whose
        # stream restarted at 0 can only see cache entries they have
        # (re)written since the reset.
        mask = idx[None, :] <= pos[:, None]
    return k, v, mask
