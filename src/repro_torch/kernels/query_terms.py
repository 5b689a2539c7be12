"""The batch's queries as sparse term lists, the layout K1 and K2 read.

The JAX package hands its kernels dense ``(n_q, V + 1)`` query maps, the
shape the TPU's matrix unit wants. On the H100 a bound must stay IEEE
fp32 (no tensor cores), so every zero of a dense map costs a real FFMA
(K1) or a real gather (K2). A query has a few dozen terms out of V =
30522, so the kernels read only these. This module builds them once per
batch, in plain PyTorch on the queries' device:

  * per query (K1): its term ids in ascending order, their weights and a
    count, padded to the batch's ``q_pad`` with id V and weight 0.
    PAD_TERM slots (and any slot at id V) are left out;
  * per query block of K2's ``block_q`` (``block_q`` given):

      - ``bitmap``: one bit per term slot 0..V, set for the block's union
        of terms (V is never set, so a doc's padding always misses);
      - ``prefix``: per 32-bit word, the union terms in the words before
        it, so a hit on slot v sits at union position
        ``prefix[v >> 5] + popcount(bitmap[v >> 5] & ((1 << (v & 31)) - 1))``;
      - a CSR list for each union term (union ascending): its entries
        ``term_ptr[u] .. term_ptr[u + 1]`` of (local query ``ent_q``,
        weight ``ent_w``), queries ascending.

Every shape is fixed by (n_q, q_pad, block_q, V), so building the layout
reads nothing back to the host. A block holds at most ``block_q * q_pad``
entries; the CSR arrays are that wide, and every per-block row is padded
to a multiple of 16 bytes so that K2 fetches it with one bulk copy.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from repro_torch.core.types import QueryBatch


@dataclasses.dataclass(frozen=True)
class QueryTerms:
    """tids (n_q, q_pad) int32 ascending, V past ``count``; tw (n_q,
    q_pad) float32, 0 past ``count``; count (n_q,) int32. With
    ``block_q``: bitmap/prefix (n_qb, n_words) int32, n_union (n_qb,)
    int32, term_ptr (n_qb, E + 4) int32, ent_q (n_qb, E) int32, ent_w
    (n_qb, E) float32, E = block_q * q_pad rounded up to a multiple of 4
    (n_words likewise; the padding is zero, and term_ptr holds the entry
    count from n_union on)."""

    tids: torch.Tensor
    tw: torch.Tensor
    count: torch.Tensor
    vocab: int
    block_q: int | None = None
    bitmap: torch.Tensor | None = None
    prefix: torch.Tensor | None = None
    n_union: torch.Tensor | None = None
    term_ptr: torch.Tensor | None = None
    ent_q: torch.Tensor | None = None
    ent_w: torch.Tensor | None = None

    @property
    def n_queries(self) -> int:
        return self.tids.shape[0]

    @property
    def q_pad(self) -> int:
        return self.tids.shape[1]

    @property
    def device(self) -> torch.device:
        return self.tids.device

    @property
    def n_words(self) -> int:
        return words_for(self.vocab)

    @property
    def max_entries(self) -> int:
        return self.ent_q.shape[1]

    @functools.cached_property
    def qmaps(self) -> torch.Tensor:
        """(n_q, V + 1) dense maps, equal to ``QueryBatch.dense_map``: the
        plain versions' input. Built on first use, then kept."""
        live = (torch.arange(self.q_pad, device=self.device)[None]
                < self.count[:, None])
        return QueryBatch(tids=self.tids, tw=self.tw, mask=live,
                          vocab=self.vocab).dense_map()


def words_for(vocab: int) -> int:
    """32-bit words of a bitmap over the V + 1 term slots, rounded up to
    a multiple of 4 (16-byte rows)."""
    return -(-(vocab + 1) // 128) * 4


def query_terms(queries: QueryBatch, block_q: int | None = None
                ) -> QueryTerms:
    """The sparse layout of ``queries``; the per-block part only when
    ``block_q`` is given (the batched engine's executor)."""
    V = queries.vocab
    valid = queries.mask & (queries.tids < V)
    key = torch.where(valid, queries.tids, V).to(torch.int32)
    tids, order = torch.sort(key, dim=1, stable=True)
    tw = torch.where(valid, queries.tw, 0.0).float().gather(1, order)
    count = valid.sum(dim=1, dtype=torch.int32)
    if block_q is None:
        return QueryTerms(tids=tids, tw=tw, count=count, vocab=V)
    return QueryTerms(tids=tids, tw=tw, count=count, vocab=V,
                      block_q=block_q, **_blocks(tids, tw, V, block_q))


def _blocks(tids: torch.Tensor, tw: torch.Tensor, V: int,
            bq: int) -> dict:
    dev = tids.device
    n_q, qp = tids.shape
    n_qb = -(-n_q // bq)
    pad = n_qb * bq - n_q
    if pad:
        tids = torch.cat([tids, tids.new_full((pad, qp), V)])
        tw = torch.cat([tw, tw.new_zeros((pad, qp))])
    E = bq * qp
    E4 = -(-E // 4) * 4
    local = torch.arange(bq, device=dev)[None, :, None]
    # (term, local query) keys: unique per block, padding (id V) last
    key = (tids.long().reshape(n_qb, bq, qp) * bq + local).reshape(n_qb, E)
    key = F.pad(key, (0, E4 - E), value=V * bq)
    tw = F.pad(tw.reshape(n_qb, E), (0, E4 - E))
    E = E4
    skey, sidx = torch.sort(key, dim=1, stable=True)
    s_tid = skey // bq
    live = s_tid < V
    n_ent = live.sum(dim=1, dtype=torch.int32)
    first = live.clone()
    first[:, 1:] &= s_tid[:, 1:] != s_tid[:, :-1]
    uidx = torch.cumsum(first, dim=1) - 1
    n_union = first.sum(dim=1, dtype=torch.int32)
    pos = torch.arange(E, dtype=torch.int32, device=dev).expand(n_qb, E)
    # term_ptr[u] = first entry of union term u; n_ent from n_union on
    term_ptr = n_ent[:, None].expand(n_qb, E + 4).contiguous()
    term_ptr.scatter_(1, torch.where(first, uidx, E + 3),
                      torch.where(first, pos, n_ent[:, None]))
    ent_q = torch.where(live, skey % bq, 0).to(torch.int32)
    ent_w = torch.where(live, tw.gather(1, sidx), 0.0)

    n_words = words_for(V)
    bits = torch.zeros((n_qb, n_words * 32), dtype=torch.bool, device=dev)
    bits.scatter_(1, torch.where(first, s_tid, V), first)
    bits = bits.reshape(n_qb, n_words, 32)
    weight = torch.ones(32, dtype=torch.int64, device=dev) << torch.arange(
        32, device=dev)
    words = (bits.long() * weight).sum(dim=-1)            # [0, 2^32)
    bitmap = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    per_word = bits.sum(dim=-1, dtype=torch.int32)
    prefix = (torch.cumsum(per_word, dim=1) - per_word).to(torch.int32)
    return dict(bitmap=bitmap, prefix=prefix, n_union=n_union,
                term_ptr=term_ptr, ent_q=ent_q, ent_w=ent_w.float())


def block_map_t(terms: QueryTerms, b: int) -> torch.Tensor:
    """(V + 1, block_q) float32: query block ``b``'s transposed map,
    decoded from the bitmap, prefix counts and CSR the way K2 looks a
    term up. Equal to the block's columns of ``qmaps.T`` when the layout
    is right; the tests hold it to that."""
    V, bq = terms.vocab, terms.block_q
    dev = terms.device
    shifts = torch.arange(32, device=dev)
    bits = ((terms.bitmap[b][:, None] >> shifts) & 1).bool()  # (n_words, 32)
    below = torch.cumsum(bits, dim=1) - bits.long()
    rank = (terms.prefix[b][:, None] + below).reshape(-1)[:V + 1]
    hit = bits.reshape(-1)[:V + 1]
    ptr = terms.term_ptr[b].long()
    out = torch.zeros((V + 1, bq), dtype=torch.float32, device=dev)
    for v in torch.nonzero(hit).flatten().tolist():
        u = int(rank[v])
        for e in range(int(ptr[u]), int(ptr[u + 1])):
            out[v, int(terms.ent_q[b, e])] = terms.ent_w[b, e]
    return out
