"""The LM's 'model' axis in the port, as ``lm_rules`` lays it: sequence
parallelism with context-parallel attention in training and prefill,
tensor parallelism (the MLP by column and row, the vocab) with the KV
cache's sequence split in decode (``distributed/parallelize.py``,
``models/transformer.py``, ``attention.py``, ``layers.py``, ``moe.py``).

Tiny LMs (2 layers, d_model 64, 4 heads over 2 KV heads, vocab 256,
fp32, remat on, KV chunks of 8) start from the JAX package's
initialisation, carried across (``convert.lm_params_from_arrays``). One
module fixture spawns 2 gloo ranks on a (1, 2) ("data", "model") mesh and
4 on (2, 2), once each, and every test reads their results against the
port's single device, computed in this process:

  * a train step (batch 4 x 32, a mask that leaves each rank of the
    sequence another token count): the loss and every parameter's
    gradient (the whole tensors) rtol 1e-5 / atol 1e-6, then two AdamW
    steps' losses (the same) and parameters (atol 1e-5: at lr 1e-3 an
    entry whose gradient is near zero can tip its update by a fraction
    of lr, as tests/test_torch_transformer.py notes); the sharded loss
    also equals the JAX package's single-device ``loss_fn`` within 1e-5.
    Cases: swiglu with RMS norms and a tied head, gelu with LayerNorm and
    an untied head, both with qk-norm;
  * prefill (serving rules, bf16 weights not needed: fp32): the last
    token's logits on every rank and the K/V cache, each rank's block
    gathered along the sequence, rtol 1e-5 / atol 1e-6;
  * three greedy decode steps into the prefill's cache grown to 40 slots
    (the cache's sequence over 'model'): logits and tokens against one
    device's, the cache's storage the same across the steps;
  * on (2, 2), batch 1 under ``long_context`` (the cache over ("data",
    "model"), 10 slots a rank): three decode steps, as above;
  * on (1, 2), a tiny olmoe-like LM at no-drop capacity, with 4 experts
    (the expert-parallel all-to-all on each rank's chunk) and with 3 and
    a shared expert (the experts do not divide 'model': the sequence is
    gathered before dispatch): loss and every gradient as above.

In this process: ``chunked_causal_attention`` of a chunk of queries at
its offset equals the matching rows of full attention; a sequence that
'model' does not divide raises in ``local_batch``, as ``parallelize.py``
documents; the single-device decode writes its cache in place.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn_ranks

RANK_TIMEOUT_S = 120.0
B, S, S_MAX, STEPS, DECODE = 4, 32, 40, 2, 3
LR = 1e-3
TOL = dict(rtol=1e-5, atol=1e-6)
DENSE = {"swiglu_tied": dict(act="swiglu", norm="rms", tie_embeddings=True),
         "gelu_untied": dict(act="gelu", norm="ln", tie_embeddings=False)}
# E, shared: 4 experts divide 'model' (the all-to-all), 3 do not
MOE = {"moe_a2a": (4, 0), "moe_gathered": (3, 1)}


def _over(name: str) -> dict:
    base = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                vocab=256, qk_norm=True, rope_theta=1e4, dtype="float32",
                remat=True, attn_chunk=8)
    return {**base, **DENSE.get(name, {})}


def _configs(name: str):
    """(the port's config, the reference's) of case ``name``."""
    from repro.configs import get_arch as j_get_arch
    from repro.models import moe as j_moe
    from repro_torch.configs import get_arch
    from repro_torch.models import moe
    over = _over(name)
    t_over, j_over = dict(over), dict(over)
    if name in MOE:
        E, shared = MOE[name]
        kw = dict(n_experts=E, top_k=2, d_ff_expert=32, n_shared=shared,
                  capacity_factor=E / 2)
        t_over["moe"], j_over["moe"] = moe.MoEConfig(**kw), \
            j_moe.MoEConfig(**kw)
    return (dataclasses.replace(get_arch("olmo-1b").smoke_config(),
                                **t_over),
            dataclasses.replace(j_get_arch("olmo-1b").smoke_config(),
                                **j_over))


def _batch(step: int, batch: int = B) -> dict:
    rng = np.random.default_rng(10 + step)
    toks = rng.integers(0, 256, (batch, S + 1))
    mask = np.ones((batch, S), np.float32)
    # rows 0-1 drop tokens from the sequence's first half only, so the
    # ranks of 'model' (and of "data") count other numbers of tokens
    mask[0, :5] = mask[1, 2:9] = 0.0
    return {"tokens": toks[:, :S], "labels": toks[:, 1:], "mask": mask}


def _torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) if k == "mask"
            else torch.from_numpy(v).long() for k, v in b.items()}


def _model(cfg, tree):
    from repro_torch.convert import lm_params_from_arrays
    return lm_params_from_arrays(tree, cfg, device="cpu")


def _arrays(tree) -> list[np.ndarray]:
    from repro_torch.convert import to_arrays
    from repro_torch.training.tree import leaves
    return [np.asarray(a) for a in leaves(to_arrays(tree))]


# ---------------------------------------------------------------------------
# shared by the ranks and the single-device side
# ---------------------------------------------------------------------------

def _train(cfg, tree, layout=None, steps: int = STEPS) -> dict:
    """The step-0 loss and gradients (whole tensors), then ``steps``
    AdamW steps' losses and the parameters after them."""
    from repro_torch.distributed import parallelize as par
    from repro_torch.models import transformer as tf
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.train_loop import TrainConfig, make_train_step
    from repro_torch.training.tree import leaves, module_tree
    model = _model(cfg, tree)
    batch = _torch_batch(_batch(0))
    if layout is not None:
        par.shard_module(model, layout.rules, tf.param_axes(cfg))
        batch, axes = par.local_batch(batch, layout)
        with par.use_layout(par.Layout(layout.rules, axes)):
            local = tf.loss_fn(model, batch)
            loss = par.batch_sum(local.detach())
    else:
        local = loss = tf.loss_fn(model, batch)
    # the backward (and the remat recompute in it) outside the layout's
    # context, as the autograd engine runs it for a CUDA tensor
    grads = torch.autograd.grad(local, leaves(module_tree(model)))
    out = {"loss0": float(loss.detach()),
           "grads0": [par.full(g).numpy() for g in grads]}
    if not steps:
        return out
    opt = opt_lib.adamw(opt_lib.constant_schedule(LR))
    state = opt.init(module_tree(model))
    step = make_train_step(tf.loss_fn, opt, TrainConfig(), layout=layout)
    out["losses"] = []
    for i in range(steps):
        model, state, m = step(model, state, _torch_batch(_batch(i)), i)
        out["losses"].append(float(m["loss"]))
    out["params"] = _arrays(model)
    return out


def _decode(model, cfg, logits, cache_whole, row_ranks, start_len):
    """``DECODE`` greedy steps from ``logits`` into a cache of ``S_MAX``
    slots holding ``cache_whole`` (this rank's rows of the prefill's whole
    cache) in its first slots, as this rank's block under the installed
    layout: each step's logits and tokens, and whether the cache kept its
    storage."""
    from repro_torch.distributed import parallelize as par
    from repro_torch.models import transformer as tf
    grown = tf.init_cache(cfg, cache_whole["k"].shape[1] * row_ranks,
                          S_MAX, torch.float32, device="cpu")
    n = grown["k"].shape[2]
    axes = par.split_axes("batch", "cache_seq")
    lo = (par.line_index(par.current_layout().mesh, axes) * n
          if axes else 0)
    for kv in ("k", "v"):
        whole = torch.zeros(grown[kv].shape[:2] + (S_MAX,)
                            + grown[kv].shape[3:])
        whole[:, :, :start_len] = cache_whole[kv]
        grown[kv].copy_(whole[:, :, lo:lo + n])
    grown["len"] = torch.tensor(start_len, dtype=torch.int32)
    ptrs = (grown["k"].data_ptr(), grown["v"].data_ptr())
    nxt = logits[:, -1].argmax(-1, keepdim=True)
    out, toks, kept = [], [], True
    for _ in range(DECODE):
        dec, grown = tf.decode_step(model, grown, nxt)
        kept &= (grown["k"].data_ptr(), grown["v"].data_ptr()) == ptrs
        nxt = dec[:, -1].argmax(-1, keepdim=True)
        out.append(dec.numpy())
        toks.append(nxt.numpy())
    return {"logits": out, "tokens": toks, "storage_kept": kept,
            "len": int(grown["len"])}


def _serve(cfg, tree, mesh=None) -> dict:
    """Prefill of batch 0's tokens (its last-token logits and the whole
    cache, gathered along the sequence), then ``_decode`` under decode
    rules."""
    from repro_torch.distributed import parallelize as par
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import transformer as tf
    model = _model(cfg, tree)
    toks = {"tokens": torch.from_numpy(_batch(0)["tokens"]).long()}
    pre = dec = None
    if mesh is not None:
        rules = sh.lm_rules(mesh, training=False)
        par.shard_module(model, rules, tf.param_axes(cfg))
        pre = par.Layout(rules, par.batch_axes_of(rules))
        toks, _ = par.local_batch(toks, pre)
        drules = sh.lm_rules(mesh, training=False, decode=True)
        dec = par.Layout(drules, par.batch_axes_of(drules))
    with torch.no_grad():
        with par.use_layout(pre):
            logits, cache = tf.prefill(model, toks["tokens"],
                                       cache_dtype=torch.float32)
            g = par.seq_group()
            whole = {k: par._gather_dim(cache[k], 2, g) if g is not None
                     else cache[k] for k in ("k", "v")}
        out = {"logits": logits.numpy(), "len": int(cache["len"]),
               "k": whole["k"].numpy(), "v": whole["v"].numpy()}
        with par.use_layout(dec):
            rows = (par.axes_size(mesh, dec.batch_axes)
                    if dec is not None and dec.batch_axes else 1)
            out["decode"] = _decode(model, cfg, logits, whole, rows,
                                    int(cache["len"]))
    return out


def _long(cfg, tree, mesh=None) -> dict:
    """Batch 1 (row 2 of batch 0): the prefill on one device (every rank
    computes it alike), then ``_decode`` under ``long_context`` rules:
    no batch split, the cache's sequence over ("data", "model")."""
    from repro_torch.distributed import parallelize as par
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import transformer as tf
    model = _model(cfg, tree)
    toks = torch.from_numpy(_batch(0)["tokens"][2:3]).long()
    with torch.no_grad():
        logits, cache = tf.prefill(model, toks, cache_dtype=torch.float32)
    layout = None
    if mesh is not None:
        rules = sh.lm_rules(mesh, training=False, decode=True,
                            long_context=True)
        par.shard_module(model, rules, tf.param_axes(cfg))
        layout = par.Layout(rules, par.batch_axes_of(rules))
    with torch.no_grad(), par.use_layout(layout):
        out = _decode(model, cfg, logits, cache, 1, S)
        out["cache_block"] = list(tf.init_cache(
            cfg, 1, S_MAX, torch.float32, device="cpu")["k"].shape)
    return out


def _moe(cfg, tree, layout=None) -> dict:
    """The MoE LM's step-0 loss and gradients, with the all-to-alls the
    step made counted."""
    from repro_torch.distributed import parallelize as par
    calls, real = [], par.all_to_all

    def counted(x, g):
        calls.append(tuple(x.shape))
        return real(x, g)

    par.all_to_all = counted
    try:
        out = _train(cfg, tree, layout, steps=0)
    finally:
        par.all_to_all = real
    out["a2a_calls"] = len(calls)
    return out


# ---------------------------------------------------------------------------
# rank functions (spawned ranks import them by name)
# ---------------------------------------------------------------------------

def _rank(rank: int, shape: tuple, cases: dict) -> dict:
    from repro_torch.distributed import parallelize as par
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    mesh = make_host_mesh(shape, ("data", "model"))
    rules = sh.lm_rules(mesh)
    layout = par.Layout(rules, par.batch_axes_of(rules))
    out = {"coord": mesh.get_coordinate(), "seq_axes": layout.seq_axes}
    for name, (cfg, tree) in cases.items():
        if name in MOE:
            out[name] = _moe(cfg, tree, layout)
            continue
        out[name] = _train(cfg, tree, layout)
        if name == "swiglu_tied":
            out["serve"] = _serve(cfg, tree, mesh)
            if shape == (2, 2):
                out["long"] = _long(cfg, tree, mesh)
    return out


@pytest.fixture(scope="module")
def runs() -> dict:
    import jax

    from repro.models import transformer as j_tf
    cases, jax_loss = {}, {}
    for name in (*DENSE, *MOE):
        cfg, jcfg = _configs(name)
        params = j_tf.init_params(jax.random.PRNGKey(3), jcfg)
        tree = jax.tree_util.tree_map(np.asarray, params)
        cases[name] = (cfg, tree)
        b = {k: jax.numpy.asarray(v) for k, v in _batch(0).items()}
        jax_loss[name] = float(j_tf.loss_fn(params, b, jcfg))
    dense = {k: v for k, v in cases.items() if k in DENSE}
    out = {"jax_loss": jax_loss,
           "r2": spawn_ranks(_rank, 2, ((1, 2), cases),
                             timeout_s=RANK_TIMEOUT_S),
           "r4": spawn_ranks(_rank, 4, ((2, 2), dense),
                             timeout_s=RANK_TIMEOUT_S)}
    out["single"] = {name: (_moe if name in MOE else _train)(cfg, tree)
                     for name, (cfg, tree) in cases.items()}
    cfg, tree = cases["swiglu_tied"]
    out["single"]["serve"] = _serve(cfg, tree)
    out["single"]["long"] = _long(cfg, tree)
    return out


def _close(got, want, what, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=what, **(tol or TOL))


def _block(world: str, rank: int) -> tuple[slice, slice]:
    """Rank ``rank``'s rows and chunk of the sequence of a (B, S) batch."""
    d, m = (rank // 2, rank % 2) if world == "r4" else (0, rank)
    n_data = 2 if world == "r4" else 1
    rows = B // n_data
    return slice(d * rows, (d + 1) * rows), slice(m * S // 2,
                                                  (m + 1) * S // 2)


@pytest.mark.parametrize("world", ["r2", "r4"])
@pytest.mark.parametrize("case", list(DENSE))
def test_train_step_matches_single_device_and_reference(runs, world, case):
    """The sequence split over 'model' (and the rows over "data" on
    (2, 2)): the step-0 loss equals one device's and the JAX package's,
    every gradient one device's; then two AdamW steps."""
    want = runs["single"][case]
    for r, res in enumerate(runs[world]):
        assert res["seq_axes"] == ("model",)
        got = res[case]
        _close(got["loss0"], want["loss0"], f"rank {r} loss0")
        _close(got["loss0"], runs["jax_loss"][case], f"rank {r} vs jax",
               rtol=1e-5, atol=1e-5)
        assert len(got["grads0"]) == len(want["grads0"])
        for i, (a, b) in enumerate(zip(got["grads0"], want["grads0"])):
            _close(a, b, f"rank {r} grad {i}")
        _close(got["losses"], want["losses"], f"rank {r} losses")
        for i, (a, b) in enumerate(zip(got["params"], want["params"])):
            _close(a, b, f"rank {r} param {i}", rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("world", ["r2", "r4"])
def test_prefill_matches_single_device(runs, world):
    """Every rank returns the last token's logits (computed on the rank
    holding the last chunk); its cache block is its chunk's K/V, and the
    blocks gathered along the sequence equal one device's cache rows."""
    want = runs["single"]["serve"]
    for r, res in enumerate(runs[world]):
        got = res["serve"]
        rows, _ = _block(world, r)
        assert got["len"] == want["len"] == S
        _close(got["logits"], want["logits"][rows], f"rank {r} logits")
        for kv in ("k", "v"):
            _close(got[kv], want[kv][:, rows], f"rank {r} cache {kv}")


@pytest.mark.parametrize("world", ["r2", "r4"])
def test_decode_steps_match_single_device(runs, world):
    """Three greedy decode steps, the cache's sequence over 'model', the
    MLP and the vocab tensor-parallel: every vocab block's logits and the
    greedy tokens equal one device's; each side's cache keeps its
    storage (written in place)."""
    want = runs["single"]["serve"]["decode"]
    assert want["storage_kept"] and want["len"] == S + DECODE
    for r, res in enumerate(runs[world]):
        got = res["serve"]["decode"]
        rows, _ = _block(world, r)
        assert got["storage_kept"] and got["len"] == S + DECODE
        for i in range(DECODE):
            _close(got["logits"][i], want["logits"][i][rows],
                   f"rank {r} step {i} logits")
            np.testing.assert_array_equal(got["tokens"][i],
                                          want["tokens"][i][rows])


def test_long_context_decode_matches_single_device(runs):
    """(2, 2) with batch 1 under ``long_context``: the cache's 40 slots
    over ("data", "model"), 10 a rank; three steps as above."""
    want = runs["single"]["long"]
    assert want["cache_block"][2] == S_MAX
    for r, res in enumerate(runs["r4"]):
        got = res["long"]
        assert got["cache_block"] == [2, 1, S_MAX // 4, 2, 16]
        assert got["storage_kept"] and got["len"] == S + DECODE
        for i in range(DECODE):
            _close(got["logits"][i], want["logits"][i], f"rank {r} step {i}")
            np.testing.assert_array_equal(got["tokens"][i],
                                          want["tokens"][i])


@pytest.mark.parametrize("case", list(MOE))
def test_moe_lm_matches_single_device(runs, case):
    """The MoE LM on (1, 2): 4 experts take the all-to-all on each rank's
    chunk of the sequence; 3 (and a shared expert) do not divide 'model',
    so the sequence is gathered before the dispatch and split after. The
    loss equals one device's and the JAX package's, every gradient one
    device's."""
    want = runs["single"][case]
    for r, res in enumerate(runs["r2"]):
        got = res[case]
        assert (got["a2a_calls"] > 0) == (case == "moe_a2a"), got
        _close(got["loss0"], want["loss0"], f"rank {r} loss")
        _close(got["loss0"], runs["jax_loss"][case], f"rank {r} vs jax",
               rtol=1e-5, atol=1e-5)
        for i, (a, b) in enumerate(zip(got["grads0"], want["grads0"])):
            _close(a, b, f"rank {r} grad {i}")


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offset", [0, 8, 20])
def test_chunked_attention_of_a_query_chunk_is_its_rows(offset):
    """Queries at an offset against the whole K/V are the matching rows
    of full causal attention, the chunk boundaries falling anywhere."""
    from repro_torch.models.attention import chunked_causal_attention
    g = torch.Generator().manual_seed(offset)
    q = torch.randn((2, 32, 2, 2, 16), generator=g)
    k = torch.randn((2, 32, 2, 16), generator=g)
    v = torch.randn((2, 32, 2, 16), generator=g)
    full = chunked_causal_attention(q, k, v, chunk=8)
    part = chunked_causal_attention(q[:, offset:offset + 12], k, v,
                                    chunk=8, q_offset=offset)
    torch.testing.assert_close(part, full[:, offset:offset + 12],
                               rtol=1e-6, atol=1e-6)


def test_a_sequence_model_does_not_divide_raises():
    """``parallelize.local_batch`` refuses a sequence that the axes the
    rules split it over do not divide (the documented behaviour: no rank
    runs it whole where the rules split it); the rows' fallback stays."""
    from repro_torch.distributed import parallelize as par
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import fake_world, make_host_mesh
    with fake_world(4):
        mesh = make_host_mesh((2, 2), ("data", "model"))
        rules = sh.lm_rules(mesh)
        layout = par.Layout(rules, par.batch_axes_of(rules))
        assert layout.seq_axes == ("model",)
        assert layout.token_axes == ("data", "model")
        ok, axes = par.local_batch({"tokens": torch.zeros(4, 6)}, layout)
        assert ok["tokens"].shape == (2, 3) and axes == ("data",)
        # three rows: whole on every data rank, the sequence still split
        ok, axes = par.local_batch({"tokens": torch.zeros(3, 6)}, layout)
        assert ok["tokens"].shape == (3, 3) and axes == ()
        with pytest.raises(ValueError, match="does not divide"):
            par.local_batch({"tokens": torch.zeros(4, 7)}, layout)
        # decode's rules leave the sequence whole
        dec = par.Layout(sh.lm_rules(mesh, training=False, decode=True),
                         ("data",))
        assert dec.seq_axes == ()
        ok, _ = par.local_batch({"tokens": torch.zeros(4, 7)}, dec)
        assert ok["tokens"].shape == (2, 7)


def test_single_device_decode_writes_the_cache_in_place():
    """No layout: ``decode_step`` returns the cache tensors it was given,
    the token's K/V written into its slot, the other slots untouched."""
    from repro_torch.models import transformer as tf
    cfg, _ = _configs("swiglu_tied")
    model = tf.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    cache = tf.init_cache(cfg, 2, 8, torch.float32, device="cpu")
    cache["k"].fill_(7.0)
    cache["len"] = torch.tensor(3, dtype=torch.int32)
    k = cache["k"]
    with torch.no_grad():
        _, new = tf.decode_step(model, cache, torch.tensor([[1], [2]]))
    assert new["k"] is k and int(new["len"]) == 4
    assert torch.all(k[:, :, 3] != 7.0)
    assert torch.all(k[:, :, :3] == 7.0) and torch.all(k[:, :, 4:] == 7.0)
