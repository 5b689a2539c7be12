"""GQA attention: chunked online softmax (train / prefill) and KV-cache
decode (PyTorch port of ``repro/models/attention.py``).

Layouts are the reference's: ``wq`` (d, G, P, H) with G key/value heads
and P query heads each, ``wk``/``wv`` (d, G, H), ``wo`` (G, P, H, d);
activations q (B, S, G, P, H), k/v (B, S, G, H). The reference computes
attention in plain array code, outside any Pallas kernel, so the port's
is plain tensor code too: the online softmax over KV chunks never forms
the (S_q x S_kv) score matrix of a long sequence. ``attn_axes`` and the
``constrain`` calls are the reference's (``distributed/sharding.py``):
heads stay replicated, the query sequence goes over 'model'. Under a
layout (``distributed/parallelize.py``) training and prefill attend
context-parallel (each rank's queries, every rank's K/V), and decode
attends to this rank's block of the cache, combining the softmax over
the blocks.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import parallelize as par
from repro_torch.distributed.sharding import constrain
from repro_torch.models.layers import (apply_norm, apply_rope, dense_init,
                                       norm_init)

NEG_INF = -1e30


def attn_init(gen: torch.Generator, d_model: int, n_heads: int, n_kv: int,
              d_head: int, qk_norm: bool, dtype=torch.float32) -> dict:
    q_per = n_heads // n_kv
    p = {
        "wq": dense_init(gen, d_model, n_kv * q_per * d_head, dtype
                         ).reshape(d_model, n_kv, q_per, d_head),
        "wk": dense_init(gen, d_model, n_kv * d_head, dtype
                         ).reshape(d_model, n_kv, d_head),
        "wv": dense_init(gen, d_model, n_kv * d_head, dtype
                         ).reshape(d_model, n_kv, d_head),
        "wo": dense_init(gen, n_kv * q_per * d_head, d_model, dtype
                         ).reshape(n_kv, q_per, d_head, d_model),
    }
    if qk_norm:
        p["q_norm"] = norm_init("rms", d_head)
        p["k_norm"] = norm_init("rms", d_head)
    return p


def attn_axes(qk_norm: bool) -> dict:
    a = {
        "wq": ("w_fsdp", "kv_heads", "heads", "head_dim"),
        "wk": ("w_fsdp", "kv_heads", "head_dim"),
        "wv": ("w_fsdp", "kv_heads", "head_dim"),
        "wo": ("kv_heads", "heads", "head_dim", "w_fsdp"),
    }
    if qk_norm:
        a["q_norm"] = {"scale": ("head_dim",)}
        a["k_norm"] = {"scale": ("head_dim",)}
    return a


def _project_qkv(params, x: torch.Tensor, positions: torch.Tensor,
                 qk_norm: bool, rope_theta: float):
    """x (B, S, D) -> q (B, S, G, P, H), k/v (B, S, G, H)."""
    q = torch.einsum("bsd,dgph->bsgph", x, params["wq"])
    k = torch.einsum("bsd,dgh->bsgh", x, params["wk"])
    v = torch.einsum("bsd,dgh->bsgh", x, params["wv"])
    if qk_norm:
        q = apply_norm(params["q_norm"], q, "rms")
        k = apply_norm(params["k_norm"], k, "rms")
    # rope over the seq axis: move seq next-to-last
    q = apply_rope(q.movedim(1, 3), positions[:, None, None, :],
                   rope_theta).movedim(3, 1)
    k = apply_rope(k.movedim(1, 2), positions[:, None, :],
                   rope_theta).movedim(2, 1)
    return q, k, v


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, chunk: int = 512,
                             causal: bool = True,
                             q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention over KV chunks.

    q: (B, Sq, G, P, H); k, v: (B, Skv, G, H). Returns (B, Sq, G, P, H).
    KV is zero-padded to whole chunks and the padding masked out."""
    B, Sq, G, Pp, H = q.shape
    Skv = k.shape[1]
    chunk = min(chunk, Skv)
    n_chunks = -(-Skv // chunk)
    pad = n_chunks * chunk - Skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    dev = q.device
    qf = q.float() * (H ** -0.5)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, Sq, G, Pp), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, G, Pp), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, G, Pp, H), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        kblk = k[:, c * chunk:(c + 1) * chunk].float()
        vblk = v[:, c * chunk:(c + 1) * chunk].float()
        kv_pos = c * chunk + torch.arange(chunk, device=dev)
        s = torch.einsum("bsgph,bcgh->bsgpc", qf, kblk)
        live = (kv_pos < Skv)[None, :]
        mask = (kv_pos[None, :] <= q_pos[:, None]) & live if causal \
            else live.expand(Sq, chunk)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bsgpc,bcgh->bsgph", p,
                                                    vblk)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def attend_train(params, x: torch.Tensor, *, qk_norm: bool,
                 rope_theta: float, chunk: int = 512,
                 causal: bool = True) -> torch.Tensor:
    """Full self-attention for train / prefill. x: (B, S, D), this rank's
    chunk of the sequence where the layout splits it (context
    parallelism: queries at their global positions, K/V gathered whole,
    :func:`parallelize.gather_seq`). No padding mask enters here, as in
    the reference."""
    q, k, v = project_chunk(params, x, qk_norm, rope_theta)
    k, v = par.gather_seq(k), par.gather_seq(v)
    out = chunked_causal_attention(q, k, v, chunk=chunk, causal=causal,
                                   q_offset=par.seq_offset(x.shape[1]))
    out = torch.einsum("bsgph,gphd->bsd", out, params["wo"])
    return constrain(out, "batch", "seq", "embed")


def project_chunk(params, x: torch.Tensor, qk_norm: bool,
                  rope_theta: float):
    """q, k, v of this rank's chunk x (B, S, D) of the sequence, rotated at
    their global positions; ``constrain``'d as the reference's (queries
    over 'model', K/V replicated for attention)."""
    B, S, _ = x.shape
    start = par.seq_offset(S)
    positions = (torch.arange(S, device=x.device) + start).expand(B, S)
    q, k, v = _project_qkv(params, x, positions, qk_norm, rope_theta)
    q = constrain(q, "batch", "seq_q", "kv_heads", "heads", "head_dim")
    k = constrain(k, "batch", "seq_kv", "kv_heads", "head_dim")
    v = constrain(v, "batch", "seq_kv", "kv_heads", "head_dim")
    return q, k, v


def write_slot(cache: torch.Tensor, new: torch.Tensor,
               slot: torch.Tensor) -> None:
    """``cache[:, slot] = new`` in place where ``0 <= slot < S`` (a 0-dim
    tensor; no host sync), else nothing: the reference's masked write,
    one slot wide. cache (B, S, G, H), new (B, 1, G, H)."""
    S = cache.shape[1]
    at = torch.clamp(slot, 0, S - 1).reshape(1).long()
    inside = (slot >= 0) & (slot < S)
    cache.index_copy_(1, at, torch.where(inside, new.to(cache.dtype),
                                         cache.index_select(1, at)))


def attend_decode(params, x: torch.Tensor, cache_k: torch.Tensor,
                  cache_v: torch.Tensor, cur_len, *, qk_norm: bool,
                  rope_theta: float):
    """One-token decode against a KV cache.

    x: (B, 1, D); cache_k/v: (B, S_blk, G, H), this rank's block of the
    cache where the layout splits its sequence ("cache_seq"), else the
    whole cache; ``cur_len`` the global slot the token is written to (an
    int or a 0-dim tensor). The token's K/V are written in place, into
    the block that holds the slot (:func:`write_slot`). A split cache is
    attended flash-decode style: each rank's (max, sum, weighted V) over
    its block, one all-reduce of the per-rank maxima (B x heads floats),
    then one of the sums and weighted values scaled by the global
    maximum. Returns (out (B, 1, D), cache_k, cache_v): the caches are
    the tensors passed in."""
    B, S_blk = x.shape[0], cache_k.shape[1]
    axes = par.split_axes("batch", "cache_seq")
    g, start = None, 0
    if axes:
        mesh = par.current_layout().mesh
        g, start = par.group(mesh, axes), par.line_index(mesh, axes) * S_blk
    cur = torch.as_tensor(cur_len, device=x.device)
    positions = cur.expand(B, 1).to(torch.int32)
    q, k, v = _project_qkv(params, x, positions, qk_norm, rope_theta)
    write_slot(cache_k, k, cur - start)
    write_slot(cache_v, v, cur - start)
    qf = q.float() * (q.shape[-1] ** -0.5)
    s = torch.einsum("bsgph,bcgh->bsgpc", qf, cache_k.float())
    valid = torch.arange(S_blk, device=x.device)[None, :] + start <= cur
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    if g is None:
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bsgpc,bcgh->bsgph", p, cache_v.float())
    else:
        m = par.max_over(s.amax(-1), g)
        p = torch.exp(s - m[..., None])
        acc = torch.cat([torch.einsum("bsgpc,bcgh->bsgph", p,
                                      cache_v.float()),
                         p.sum(-1)[..., None]], -1)
        acc = par.reduce_from(acc, g)
        out = acc[..., :-1] / acc[..., -1:]
    out = torch.einsum("bsgph,gphd->bsd", out.to(x.dtype), params["wo"])
    return out, cache_k, cache_v
