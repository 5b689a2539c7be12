"""Wave-planner parity for the PyTorch port (repro_torch.core.plan).

Real admission masks come from the JAX package's batched engine
(``retrieve_with_plans``) on three layouts — segment-major (sorted),
arrival order, and a churned index with a dirty unsorted tail (built with
``repro.lifecycle`` and carried across with ``repro_torch.convert``). The
port's ``plan_wave`` must reproduce every integer and boolean WavePlan
field bit for bit, with each compaction backend, both union scopes and
whole-tile as well as sub-tiled doc blocking. The planner's edge cases
(``repro_torch.tools.plan_cases``, the same waves the ``gpu`` test and
``chip_smoke.py`` give the planner kernel) are held against the JAX
planner running the Pallas compaction in interpret mode. Modelled on
tests/test_plan_wave.py.
"""

from __future__ import annotations

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as jplan
from repro.core import search as jsearch
from repro_torch.convert import index_from_arrays
from repro_torch.core import plan as tplan
from repro_torch.core import search as tsearch
from repro_torch.core.plan import PLAN_FIELDS
from repro_torch.core.types import INDEX_FIELDS
from repro_torch.kernels.plan_wave.compact import (compact_front,
                                                   compact_front_plain)
from repro_torch.kernels.plan_wave.ref import compact_front_ref
from repro_torch.tools.plan_cases import plan_cases
from test_plan_wave import _index

_CACHE: dict = {}
# every compaction planner's six calls can take: the dispatch (the plain
# scan on these CPU tensors), the plain scan itself, the argsort reference
COMPACTIONS = {"kernel": compact_front, "plain": compact_front_plain,
               "ref": compact_front_ref}


def _recorded(layout: str, mu: float, eta: float, budget):
    """(JAX index, port index, stacked JAX plans) of one recorded run."""
    key = (layout, mu, eta, budget)
    if key not in _CACHE:
        jidx, q = _index(layout)
        cfg = jsearch.SearchConfig(k=8, mu=mu, eta=eta, engine="batched",
                                   block_q=4, block_d=8)
        b = None if budget is None else jnp.int32(budget)
        _, (plans, _) = jsearch.retrieve_with_plans(jidx, q, cfg, budget=b)
        tidx = index_from_arrays({f: np.asarray(getattr(jidx, f))
                                  for f in INDEX_FIELDS}, vocab=jidx.vocab,
                                 n_seg=jidx.n_seg, device="cpu")
        _CACHE[key] = (jidx, tidx, plans)
    return _CACHE[key]


def _t(x):
    return torch.from_numpy(np.array(x))


def assert_plan_equal(jp, tp, what: str):
    assert (tp.block_q, tp.block_d) == (jp.block_q, jp.block_d), what
    for f in PLAN_FIELDS:
        want = np.asarray(getattr(jp, f))
        got = getattr(tp, f).numpy()
        assert got.dtype == want.dtype, f"{what}: {f} dtype"
        np.testing.assert_array_equal(got, want, err_msg=f"{what}: {f}")
    assert int(tp.walked_docs()) == int(jp.walked_docs())


@pytest.mark.parametrize("layout", ["sorted", "arrival", "dirty"])
@pytest.mark.parametrize("mu,eta,budget", [(0.7, 0.9, None), (1.0, 1.0, 5),
                                           (0.5, 1.0, None)])
def test_wave_plan_bit_exact(layout, mu, eta, budget):
    jidx, tidx, plans = _recorded(layout, mu, eta, budget)
    n_waves = np.asarray(plans.cids).shape[0]
    for wave in range(min(n_waves, 3)):
        cids = np.array(plans.cids[wave])
        jc, tc = jnp.asarray(cids), torch.from_numpy(cids).long()
        jargs = (jc, plans.live[wave], plans.admit[wave],
                 plans.seg_admit[wave])
        targs = (torch.from_numpy(cids), _t(plans.live[wave]),
                 _t(plans.admit[wave]), _t(plans.seg_admit[wave]))
        for block_d in (8, None):
            for scope in ("qblock", "batch"):
                jp = jplan.plan_wave(
                    *jargs, 4, jidx.doc_seg_mod[jc], jidx.doc_mask[jc],
                    block_d=block_d, seg_offsets=jidx.seg_offsets[jc],
                    sorted_upto=jidx.sorted_upto[jc], union_scope=scope)
                for backend, compact in COMPACTIONS.items():
                    tp = tplan.plan_wave(
                        *targs, 4, tidx.doc_seg_mod[tc], tidx.doc_mask[tc],
                        block_d=block_d, seg_offsets=tidx.seg_offsets[tc],
                        sorted_upto=tidx.sorted_upto[tc], union_scope=scope,
                        _compact=compact)
                    assert_plan_equal(jp, tp, f"{layout} wave {wave} "
                                      f"block_d {block_d} {scope} "
                                      f"{backend}")


@pytest.mark.parametrize("case", plan_cases(), ids=lambda c: c.name)
def test_plan_edge_cases_match_pallas_planner(case):
    """Union scopes, the collapsed table, no layout metadata, a dirty
    tail, n_q = 37 at block_q 16, a partial and an empty wave, whole-tile
    blocking, dead tile and query-block slots, more than 32 positions and
    query blocks: every field bit-exact with the reference planner on the
    Pallas compaction (interpret mode)."""
    from repro.kernels.plan_wave.compact import compact_front_pallas
    j = {k: None if v is None else jnp.asarray(v)
         for k, v in case.arrays.items()}
    jp = jplan.plan_wave(
        j["cids"], j["live"], j["admit"], j["seg_admit"], case.block_q,
        j["doc_seg_mod"], j["doc_mask"], block_d=case.block_d,
        seg_offsets=j["seg_offsets"], sorted_upto=j["sorted_upto"],
        union_scope=case.union_scope, _compact=compact_front_pallas)
    args, kw = case.args("cpu")
    assert_plan_equal(jp, tplan.plan_wave(*args, **kw), case.name)


def test_plan_without_layout_metadata_and_helpers():
    """seg_offsets/sorted_upto None (pure mask-RLE), the collapsed n_seg=1
    table, doc admission, run masks and the segment histogram."""
    jidx, tidx, plans = _recorded("dirty", 0.7, 0.9, None)
    cids = np.array(plans.cids[0])
    jc, tc = jnp.asarray(cids), torch.from_numpy(cids).long()
    admit = np.asarray(plans.admit[0])
    for seg_admit in (np.asarray(plans.seg_admit[0]),
                      np.asarray(plans.seg_admit[0]).any(-1, keepdims=True)):
        jp = jplan.plan_wave(jc, plans.live[0], jnp.asarray(admit),
                             jnp.asarray(seg_admit), 2,
                             jidx.doc_seg_mod[jc], jidx.doc_mask[jc],
                             block_d=16)
        tp = tplan.plan_wave(torch.from_numpy(cids), _t(plans.live[0]),
                             _t(admit), _t(seg_admit), 2,
                             tidx.doc_seg_mod[tc], tidx.doc_mask[tc],
                             block_d=16)
        assert_plan_equal(jp, tp, f"n_seg_eff {seg_admit.shape[-1]}")
        np.testing.assert_array_equal(
            tplan.doc_admission(tp, tidx.doc_seg_mod[tc],
                                tidx.doc_mask[tc]).numpy(),
            np.asarray(jplan.doc_admission(jp, jidx.doc_seg_mod[jc],
                                           jidx.doc_mask[jc])))
        np.testing.assert_array_equal(
            tplan.runs_to_mask(tp.drun_start, tp.drun_len, tp.n_drun,
                               tp.d_pad).numpy(),
            np.asarray(jplan.runs_to_mask(jp.drun_start, jp.drun_len,
                                          jp.n_drun, jp.d_pad)))
    np.testing.assert_array_equal(
        tplan.segment_histogram(tidx.doc_seg_mod[tc], tidx.doc_mask[tc],
                                tidx.n_seg).numpy(),
        np.asarray(jplan.segment_histogram(jidx.doc_seg_mod[jc],
                                           jidx.doc_mask[jc], jidx.n_seg)))
    assert int(tp.n_blocks) <= int(tp.n_tiles) * tp.n_qb


def test_empty_admission_gives_empty_queues():
    _, tidx, plans = _recorded("sorted", 0.7, 0.9, None)
    cids = _t(plans.cids[0])
    tc = cids.long()
    admit = torch.zeros_like(_t(plans.admit[0]))
    seg = torch.zeros_like(_t(plans.seg_admit[0]))
    tp = tplan.plan_wave(cids, _t(plans.live[0]), admit, seg, 4,
                         tidx.doc_seg_mod[tc], tidx.doc_mask[tc],
                         seg_offsets=tidx.seg_offsets[tc],
                         sorted_upto=tidx.sorted_upto[tc])
    assert [int(tp.n_tiles), int(tp.n_blocks), int(tp.n_drun.sum()),
            int(tp.n_dblock.sum())] == [0, 0, 0, 0]


def test_block_arithmetic():
    """plan buffers match the reference; explicit blocks pass through;
    block_v "auto" is None (no vocab chunking, the only block_v the card's
    executor takes) even past 2^16 terms at block_q 64, where the
    reference would chunk."""
    for args in [(64, 4, 2, 8), (2560, 8, 1, 32), (72, 4, 3, 12)]:
        assert tsearch.plan_buffer_bytes(*args) == \
            jsearch.plan_buffer_bytes(*args)
    for d_pad, want in [(64, 8), (72, 9), (2560, 160), (97, 97)]:
        assert tplan.resolve_block_d(d_pad, want) == \
            jplan.resolve_block_d(d_pad, want)
    _, tidx, _ = _recorded("sorted", 0.7, 0.9, None)
    cfg = tsearch.SearchConfig(k=8, block_q=4, block_d=8, block_v=None)
    assert tsearch.resolve_blocks(tidx, 6, cfg) == (4, 8, None)
    bq, bd = tsearch.autotune_blocks(2560, 128, 8, 30522, 64, 32)
    assert bq == 64 and 2560 % bd == 0
    resident = (4 * bq * 30523 + 3 * bd * 128 + 4 * bq * bd
                + tsearch.plan_buffer_bytes(2560, 8, 1, 32))
    assert resident <= tsearch.L2_BLOCK_BUDGET
    assert tsearch.autotune_blocks(64, 24, 4, 256, 6)[:1] == (8,)
    big_vocab = SimpleNamespace(d_pad=2560, t_pad=128, n_seg=8, vocab=70000)
    assert 4 * 64 * 70001 > tsearch.L2_BLOCK_BUDGET // 2
    bq, bd, bv = tsearch.resolve_blocks(big_vocab, 64, tsearch.SearchConfig())
    assert (bq, bv) == (64, None) and 2560 % bd == 0
    assert jsearch.autotune_blocks(2560, 128, 8, 70000, 64, 8)[2] is not None
