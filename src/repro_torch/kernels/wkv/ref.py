"""Plain PyTorch WKV6, the counterpart of the JAX package's
``kernels/wkv/ref.py``: the naive sequential scan.

    out_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T    (w_t = exp(lw_t), decay on k-dim)

``wkv_chunked_ref`` is the same function in the chunked arithmetic of the
tensor-core kernel (``csrc/wkv.cu`` ``wkv_chunk_kernel``), step for step in
plain PyTorch: the tests hold it against the JAX package's oracle on the
CPU, so the algorithm's precision is known before the card runs it. The
main path never calls it.

``wkv_backward_ref`` is the plain version of B4's backward kernel
(``csrc/wkv.cu`` ``back::wkv_backward_kernel``): the gradient of
``wkv_ref``, written out as its reverse recurrence.
"""
from __future__ import annotations

from typing import Optional

import torch

CHUNK = 64  # tokens a chunk (the kernel's C)
SUB = 8     # tokens of the smallest block, whose pairs are formed one by one


def wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            lw: torch.Tensor, u: torch.Tensor,
            state: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, lw: (B, H, S, D) float32; u: (H, D); state: (B, H, D, D) or
    None (zeros). Returns (out (B, H, S, D) in r's dtype, final state f32).
    ``state`` itself is not changed. The state's recurrence runs token by
    token and keeps every S_{t-1} (B*H*S*D*D floats); out is then one
    product over every token, r_t . S_{t-1} plus the bonus
    (r_t . diag(u) k_t) v_t."""
    b, h, s, d = r.shape
    f32 = torch.float32
    rf, kf, vf = r.to(f32), k.to(f32), v.to(f32)
    w = torch.exp(lw.to(f32))
    S = (torch.zeros((b, h, d, d), dtype=f32, device=r.device)
         if state is None else state.to(f32).clone())
    states = []
    for t in range(s):
        states.append(S)
        S = w[:, :, t, :, None] * S + kf[:, :, t, :, None] * vf[:, :, t, None]
    S_prev = torch.stack(states, dim=2)  # (B, H, S, D, D)
    bonus = (rf * u.to(f32)[None, :, None, :] * kf).sum(-1, keepdim=True)
    out = (rf[..., None, :] @ S_prev)[..., 0, :] + bonus * vf
    return out.to(r.dtype), S


def wkv_backward_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lw: torch.Tensor, u: torch.Tensor, dout: torch.Tensor
                     ) -> tuple[torch.Tensor, ...]:
    """The gradient of ``wkv_ref``'s out with no initial state, for the
    cotangent ``dout`` of out and none on the final state: (dr, dk, dv,
    dlw, du), f32. With w_t = exp(lw_t) and G_t = dL/dS_t, from
    G_{S-1} = 0:

        G_{t-1}  = diag(w_t) G_t + r_t dout_t^T
        dr_t     = S_{t-1} dout_t + u * k_t (v_t . dout_t)
        dk_t     = G_t v_t + u * r_t (v_t . dout_t)
        dv_t     = G_t^T k_t + (r_t . diag(u) k_t) dout_t
        dlw_t    = w_t * rowsum(S_{t-1} * G_t)
        du       = sum over b, t of r_t * k_t (v_t . dout_t)

    The two recurrences run token by token, forward for S and backward for
    G, each state kept (2 * B*H*S*D*D floats); S_{t-1} is never
    reconstructed from S_t. The rest is products over every token at
    once."""
    b, h, s, d = r.shape
    f32 = torch.float32
    r, k, v, lw, dout = (t.to(f32) for t in (r, k, v, lw, dout))
    uu = u.to(f32)[None, :, None, :]
    w = torch.exp(lw)
    S = torch.zeros((b, h, d, d), dtype=f32, device=r.device)
    G = torch.zeros_like(S)
    states, grads = [], [None] * s
    for t in range(s):
        states.append(S)
        S = w[:, :, t, :, None] * S + k[:, :, t, :, None] * v[:, :, t, None]
    for t in range(s - 1, -1, -1):
        grads[t] = G
        G = w[:, :, t, :, None] * G + r[:, :, t, :, None] \
            * dout[:, :, t, None]
    S_prev = torch.stack(states, dim=2)  # (B, H, S, D, D): S_{t-1}
    del states
    G = torch.stack(grads, dim=2)        # G_t
    del grads
    vd = (v * dout).sum(-1, keepdim=True)
    dr = (S_prev @ dout[..., None])[..., 0] + uu * k * vd
    dk = (G @ v[..., None])[..., 0] + uu * r * vd
    dv = (k[..., None, :] @ G)[..., 0, :] \
        + (r * uu * k).sum(-1, keepdim=True) * dout
    dlw = w * (S_prev * G).sum(-1)
    du = (r * k * vd).sum((0, 2))
    return dr, dk, dv, dlw, du


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as the kernel rounds the large part of an operand; x finite
    float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def truncate_tf32(x: torch.Tensor) -> torch.Tensor:
    """x truncated to TF32, as the tensor cores read an f32 operand."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _matmul(a: torch.Tensor, b: torch.Tensor, split: bool) -> torch.Tensor:
    """a @ b in f32, or as the kernel's 3xTF32 split computes it: each
    operand x = hi + lo with hi = x rounded to TF32 and lo = x - hi
    truncated to TF32, and hi.hi + (hi.lo + lo.hi), the small products
    summed apart."""
    if not split:
        return a @ b
    a_hi, b_hi = round_tf32(a), round_tf32(b)
    a_lo, b_lo = truncate_tf32(a - a_hi), truncate_tf32(b - b_hi)
    return a_hi @ b_hi + (a_hi @ b_lo + a_lo @ b_hi)


def _exclusive_products(w: torch.Tensor, dim: int, reverse: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Running products of w along ``dim``, each excluding its own element
    (from the start, or from the end if ``reverse``), one multiply a step;
    and the product of all of them."""
    n = w.shape[dim]
    out = torch.empty_like(w)
    p = torch.ones_like(w.select(dim, 0))
    for i in (range(n - 1, -1, -1) if reverse else range(n)):
        out.select(dim, i).copy_(p)
        p = p * w.select(dim, i)
    return out, p


def _chunk_a(rc, kc, w, u, rL, kL, F, mm) -> torch.Tensor:
    """A chunk's A[t, i] = sum_d r_t k_i W(i, t) (i < t) with the bonus
    r_t . diag(u) k_t on the diagonal, zero above it, as the tensor-core
    kernel forms it (``wkv_chunked_ref``): pairs inside an 8-block from
    running products of w, the others factored through a reference token
    by the products ``mm``. rc, kc, w (B, H, C, D) of the chunk; rL, kL its
    rows and columns scaled within their 8-blocks; F (B, H, 8, D) the
    8-blocks' W."""
    b, h = rc.shape[:2]
    f32, dev = torch.float32, rc.device
    nq, ns = CHUNK // SUB, CHUNK // (2 * SUB)
    A = torch.zeros((b, h, CHUNK, CHUNK), dtype=f32, device=dev)
    # inside an 8-block, pair by pair: running products of w from i on
    for q in range(nq):
        t0 = q * SUB
        rq, kq, wq = (x[:, :, t0:t0 + SUB] for x in (rc, kc, w))
        for i in range(SUB):
            A[:, :, t0 + i, t0 + i] = (rq[:, :, i] * u * kq[:, :, i]
                                       ).sum(-1)
            x = kq[:, :, i]
            for t in range(i + 1, SUB):
                A[:, :, t0 + t, t0 + i] = (rq[:, :, t] * x).sum(-1)
                x = x * wq[:, :, t]
    # the second 8-block of a 16-block against its first: ref = the
    # second's start, so rows rL and columns kL as they are
    for m in range(ns):
        rows, cols = slice(16 * m + 8, 16 * m + 16), slice(16 * m,
                                                           16 * m + 8)
        A[:, :, rows, cols] = mm(rL[:, :, rows],
                                 kL[:, :, cols].transpose(-1, -2))
    # 16-block m against an earlier 16-block a: ref = m's start
    for m in range(1, ns):
        rows = slice(16 * m, 16 * m + 16)
        rI = rL[:, :, rows].clone()
        rI[:, :, 8:] *= F[:, :, 2 * m, None]  # W[start of m, t)
        for q in range(2 * m):  # the 8-blocks of the earlier ones
            fac = torch.ones_like(F[:, :, 0])
            for q2 in range(q + 1, 2 * m):
                fac = fac * F[:, :, q2]
            cols = slice(SUB * q, SUB * q + SUB)
            A[:, :, rows, cols] = mm(
                rI, (kL[:, :, cols] * fac[:, :, None]).transpose(-1, -2))
    return A


def wkv_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lw: torch.Tensor, u: torch.Tensor,
                    state: Optional[torch.Tensor] = None, *,
                    tf32_split: bool = False
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``wkv_ref``'s function in chunks of 64 tokens, as the tensor-core
    kernel computes it; ``tf32_split`` rounds the operands of every matrix
    product as the kernel's 3xTF32 products do. Same arguments and results
    as ``wkv_ref``, float32.

    In a chunk with incoming state S0, for t and i in it (lw <= 0):
      out_t = (r_t * e^{cum_{t-1}}) S0 + sum_{i<=t} A[t,i] v_i
      S_end = diag(e^{cum_63}) S0 + sum_i (k_i * e^{cum_63 - cum_i}) v_i^T
    with A[t,i] = sum_d r_t k_i e^{cum_{t-1} - cum_i} (i < t) and the
    bonus A[t,t] = r_t . diag(u) k_t. No exponent is ever formed: every
    decay is a product of w = e^{lw} <= 1 over a range of tokens, so each
    factor lies in [0, 1] and strong decay underflows to 0, never to inf.
    The tokens fall into 8-blocks of 8 and 16-blocks of 16; within an
    8-block the pairs (t, i) take running products of w, and between blocks
    A factors through the start of t's block ("ref"), as
    (r_t * W[ref, t)) (k_i * W(i, ref))^T, W[a, b) the product of w over
    tokens a..b-1: rows relative to the start of their 16-block (8-block
    for the pairs inside one 16-block), columns to it from i on.
    """
    b, h, s, d = r.shape
    dev = r.device
    f32 = torch.float32
    n = -(-s // CHUNK) * CHUNK
    pad = n - s

    def padded(x, fill=0.0):
        x = x.to(f32)
        if pad:
            x = torch.cat([x, x.new_full((b, h, pad, d), fill)], dim=2)
        return x

    r, k, v, lw = padded(r), padded(k), padded(v), padded(lw)  # lw 0: w 1
    u = u.to(f32)
    S = (torch.zeros((b, h, d, d), dtype=f32, device=dev) if state is None
         else state.to(f32).clone())
    out = torch.empty((b, h, n, d), dtype=f32, device=dev)
    nq, ns = CHUNK // SUB, CHUNK // (2 * SUB)  # 8-blocks, 16-blocks
    mm = lambda a, c: _matmul(a, c, tf32_split)  # noqa: E731
    for c0 in range(0, n, CHUNK):
        sl = slice(c0, c0 + CHUNK)
        rc, kc, vc = r[:, :, sl], k[:, :, sl], v[:, :, sl]
        w = torch.exp(lw[:, :, sl])
        # within each 8-block: W[start, t) and W(t, end], and the block's W
        shape8 = (b, h, nq, SUB, d)
        pre, F = _exclusive_products(w.reshape(shape8), 3)
        suf, _ = _exclusive_products(w.reshape(shape8), 3, reverse=True)
        rL = (rc.reshape(shape8) * pre).reshape(b, h, CHUNK, d)
        kL = (kc.reshape(shape8) * suf).reshape(b, h, CHUNK, d)
        # over the 8-blocks: W of the blocks before q, after q, of all
        RS, Ftot = _exclusive_products(F, 2)
        KS, _ = _exclusive_products(F, 2, reverse=True)

        A = _chunk_a(rc, kc, w, u, rL, kL, F, mm)

        rS = (rL.reshape(shape8) * RS[:, :, :, None]).reshape(b, h, CHUNK, d)
        kS = (kL.reshape(shape8) * KS[:, :, :, None]).reshape(b, h, CHUNK, d)
        out[:, :, sl] = mm(rS, S) + mm(A, vc)
        S = Ftot[..., None] * S + mm(kS.transpose(-1, -2), vc)
    return out[:, :, :s], S


def wkv_chunked_backward_ref(r: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, lw: torch.Tensor,
                             u: torch.Tensor, dout: torch.Tensor, *,
                             tf32_split: bool = False
                             ) -> tuple[torch.Tensor, ...]:
    """``wkv_backward_ref``'s function in chunks of 64 tokens, as the
    chunked backward kernel (``csrc/wkv.cu`` ``chunk::wkv_carry_kernel`` and
    ``chunk::wkv_chunk_backward_kernel``) computes it; ``tf32_split`` rounds
    the operands of every matrix product as the kernel's 3xTF32 products
    do. Same arguments and results as ``wkv_backward_ref``, float32.

    The exponent rule of ``wkv_chunked_ref``: every decay is a product of
    w <= 1 over a forward range of tokens, W[a, b) over a..b-1 and W(a, b)
    over a+1..b-1 of the chunk. Two D x D matrices cross chunks: the state
    S0 entering a chunk, carried forward, and G = dL/dS at its last token,
    carried backward from 0:

        S0'   = diag(W[0, 64)) S0 + (k * W(., 64))^T V
        G_prev = diag(W[0, 64)) G + (r * W[0, .))^T dOut

    Within a chunk, with B[t, i] = dout_t . v_i and the forward's A (its
    bonus on the diagonal):

        dv = A^T dOut + (k * W(., 64)) G
        dr_t = W[0, t) (S0 dout_t) + sum_{i<t} B[t, i] k_i W(i, t)
        dk_t = W(t, 64) (G v_t) + sum_{tau>t} B[tau, t] r_tau W(t, tau)

    plus the bonus terms u * k_t (v_t . dout_t) and u * r_t (v_t . dout_t).
    The pairs inside a 16-block run on running products of w; the others
    factor through the start of the later one's 16-block (for dr, as A's
    rows do) or the end of the earlier one's (for dk). dlw needs no product
    of its own: with a_t = r_t * (dr_t less its bonus) and b_t = k_t * (dk_t
    less its bonus), dlw_t = w_t rowsum(S_{t-1} * G_t) is

        dlw_t = rowsum(S_end * G) + sum_{tau>t} a_tau - sum_{i>=t} b_i

    over the chunk's tokens (S_end the state leaving it): the terms that
    cancel stay within one chunk, each at most 64 tokens' worth.
    """
    b, h, s, d = r.shape
    dev = r.device
    f32 = torch.float32
    n = -(-s // CHUNK) * CHUNK
    pad = n - s
    nc = n // CHUNK

    def padded(x):
        x = x.to(f32)
        if pad:
            x = torch.cat([x, x.new_zeros((b, h, pad, d))], dim=2)
        return x

    r, k, v, lw, dout = (padded(t) for t in (r, k, v, lw, dout))  # w 1
    u = u.to(f32)
    uu = u[None, :, None, :]
    mm = lambda a, c: _matmul(a, c, tf32_split)  # noqa: E731
    nq, ns = CHUNK // SUB, CHUNK // (2 * SUB)
    chunks = [slice(c0, c0 + CHUNK) for c0 in range(0, n, CHUNK)]
    w_all = torch.exp(lw)

    # the carries: S0 of each chunk forward, G at each chunk's end backward
    S0 = [torch.zeros((b, h, d, d), dtype=f32, device=dev)]
    for sl in chunks:
        suf, Ftot = _exclusive_products(w_all[:, :, sl], 2, reverse=True)
        S0.append(Ftot[..., None] * S0[-1]
                  + mm((k[:, :, sl] * suf).transpose(-1, -2), v[:, :, sl]))
    G = [None] * nc
    G[-1] = torch.zeros((b, h, d, d), dtype=f32, device=dev)
    for c in range(nc - 1, 0, -1):
        sl = chunks[c]
        pre, Ftot = _exclusive_products(w_all[:, :, sl], 2)
        G[c - 1] = Ftot[..., None] * G[c] + mm(
            (r[:, :, sl] * pre).transpose(-1, -2), dout[:, :, sl])

    dr, dk, dv, dlw = (torch.empty((b, h, n, d), dtype=f32, device=dev)
                       for _ in range(4))
    du = torch.zeros((h, d), dtype=f32, device=dev)
    below = torch.ones(CHUNK, CHUNK, device=dev).tril(-1)  # i < t
    for c, sl in enumerate(chunks):
        rc, kc, vc, dc, w = (x[:, :, sl] for x in (r, k, v, dout, w_all))
        shape8 = (b, h, nq, SUB, d)
        P, F = _exclusive_products(w.reshape(shape8), 3)   # W[8q, t)
        Q, _ = _exclusive_products(w.reshape(shape8), 3, reverse=True)
        P, Q = P.reshape(b, h, CHUNK, d), Q.reshape(b, h, CHUNK, d)
        RS, _ = _exclusive_products(F, 2)
        KS, _ = _exclusive_products(F, 2, reverse=True)
        q_of = torch.arange(CHUNK, device=dev) // SUB
        rL, kL = rc * P, kc * Q
        A = _chunk_a(rc, kc, w, u, rL, kL, F, mm)
        Bm = mm(dc, vc.transpose(-1, -2)) * below   # dout_t . v_i, i < t
        vd = (dc * vc).sum(-1, keepdim=True)
        Gc = G[c]

        dv[:, :, sl] = mm(A.transpose(-1, -2), dc) + mm(
            kL * KS[:, :, q_of], Gc)
        # across chunks
        drp = P * RS[:, :, q_of] * mm(dc, S0[c].transpose(-1, -2))
        dkp = Q * KS[:, :, q_of] * mm(vc, Gc.transpose(-1, -2))
        for m in range(ns):
            rows = slice(16 * m, 16 * m + 16)
            half = torch.ones_like(P[:, :, rows])
            # dr: earlier 16-blocks through ref = 16 m: W(i, 16m) is Q_i
            # times W over i's 8-block's successors below 16 m
            if m:
                fac = torch.ones_like(F[:, :, :2 * m])
                for q in range(2 * m):
                    for q2 in range(q + 1, 2 * m):
                        fac[:, :, q] = fac[:, :, q] * F[:, :, q2]
                cols = slice(0, 16 * m)
                kI = kL[:, :, cols] * fac[:, :, q_of[cols]]
                rowf = half.clone()
                rowf[:, :, 8:] = F[:, :, 2 * m, None].expand(-1, -1, 8, -1)
                drp[:, :, rows] += P[:, :, rows] * rowf * mm(
                    Bm[:, :, rows, cols], kI)
            # dk: later 16-blocks through ref = 16 (m + 1)
            if m < ns - 1:
                fac = torch.ones_like(F)
                for q in range(2 * m + 2, nq):
                    for q2 in range(2 * m + 2, q):
                        fac[:, :, q] = fac[:, :, q] * F[:, :, q2]
                cols = slice(16 * (m + 1), CHUNK)
                rI = rL[:, :, cols] * fac[:, :, q_of[cols]]
                rowf = half.clone()
                rowf[:, :, :8] = F[:, :, 2 * m + 1, None].expand(-1, -1, 8,
                                                                  -1)
                dkp[:, :, rows] += Q[:, :, rows] * rowf * mm(
                    Bm[:, :, cols, rows].transpose(-1, -2), rI)
            # pairs inside the 16-block, on running products of w
            for t in range(16 * m, 16 * m + 16):
                x = torch.ones_like(w[:, :, 0])
                for i in range(t - 1, 16 * m - 1, -1):
                    drp[:, :, t] += Bm[:, :, t, i, None] * kc[:, :, i] * x
                    x = x * w[:, :, i]
                x = torch.ones_like(w[:, :, 0])
                for tau in range(t + 1, 16 * m + 16):
                    dkp[:, :, t] += Bm[:, :, tau, t, None] * rc[:, :, tau] * x
                    x = x * w[:, :, tau]
        dr[:, :, sl] = drp + uu * kc * vd
        dk[:, :, sl] = dkp + uu * rc * vd
        # dlw from the chunk's own sums, last token first
        edge = (S0[c + 1] * Gc).sum(-1)
        a, bk = rc * drp, kc * dkp
        sa = torch.zeros_like(edge)
        sb = torch.zeros_like(edge)
        for t in range(CHUNK - 1, -1, -1):
            sb = sb + bk[:, :, t]
            dlw[:, :, c * CHUNK + t] = edge + sa - sb
            sa = sa + a[:, :, t]
        du += (rc * kc * vd).sum((0, 2))
    return (dr[:, :, :s], dk[:, :, :s], dv[:, :, :s], dlw[:, :, :s], du)
