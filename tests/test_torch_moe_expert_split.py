"""The MoE's experts split over 'model' where the all-to-all does not
apply (``models/moe.py``): every 'model' rank holds the same tokens and
dispatch, runs its own E / mp experts on their slots, and the partial
outputs are summed over 'model' in float32, as GSPMD runs the reference's
``_expert_ffn`` with the expert dim on 'model'.

A tiny olmoe-like LM (2 layers, d_model 64, 4 heads over 2 KV heads,
vocab 256, fp32, top-2 of 4 experts of width 32, capacity E / K so that
no pick drops on either path) starts from the JAX package's
initialisation (``convert.lm_params_from_arrays``). Module fixtures
spawn 2 gloo ranks on a ("data" 1, "model" 2) mesh and 4 on (2, 2), once
each:

  * on (1, 2), serving rules: prefill of 2 x 16 tokens (the sequence over
    'model', the all-to-all), then four greedy decode steps into a cache
    of 24 slots split over 'model' (one-token groups: the split experts).
    The last token's logits and every decode step's within 1e-5 (rtol
    and atol) of one device and of the reference's ``prefill`` and
    ``decode_step``, greedy tokens equal. In each decode step every
    expert weight a rank computes with holds E / 2 experts, and no expert
    weight is all-gathered: the step's all-gather bytes, counted by
    ``launch/dryrun.py``'s ``CollectiveCounter``, stay under one expert
    weight's whole bytes, and its all-reduces carry each layer's partial
    outputs;
  * the same with 3 experts and a shared expert: 3 do not divide
    'model', so the placement keeps every expert whole on each rank,
    which runs them all (the gathered path), and still equals one
    device;
  * on (2, 2), training, a batch of 3 rows that the data axes do not
    divide (rows whole on every rank, the sequence over 'model': the
    all-to-all does not apply) with 4 experts: the split experts in a
    train step; the loss (rtol 1e-5, atol 1e-6) and every gradient (rtol
    1e-4, atol 1e-6, whole tensors) against one device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn_ranks

RANK_TIMEOUT_S = 120.0
B, S, S_MAX, DECODE = 2, 16, 24, 4
TRAIN_B = 3
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# experts, shared experts
CASES = {"split": (4, 0), "gathered": (3, 1)}


def _configs(E: int, shared: int):
    """(the port's config, the reference's)."""
    from repro.configs import get_arch as j_get_arch
    from repro.models import moe as j_moe
    from repro_torch.configs import get_arch
    from repro_torch.models import moe
    over = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                vocab=256, qk_norm=True, rope_theta=1e4, dtype="float32",
                remat=True, attn_chunk=8)
    kw = dict(n_experts=E, top_k=2, d_ff_expert=32, n_shared=shared,
              capacity_factor=E / 2)
    return (dataclasses.replace(get_arch("olmo-1b").smoke_config(), **over,
                                moe=moe.MoEConfig(**kw)),
            dataclasses.replace(j_get_arch("olmo-1b").smoke_config(),
                                **over, moe=j_moe.MoEConfig(**kw)))


def _tokens(batch: int, seq: int, seed: int = 5) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (batch, seq + 1))


def _model(cfg, tree):
    from repro_torch.convert import lm_params_from_arrays
    return lm_params_from_arrays(tree, cfg, device="cpu")


# ---------------------------------------------------------------------------
# shared by the ranks and the single-device side
# ---------------------------------------------------------------------------

def _serve(cfg, tree, mesh=None) -> dict:
    """Prefill, then ``DECODE`` greedy steps into a grown cache (on
    ``mesh``: the prefill sequence-split, decode under decode rules),
    with each step's expert weight widths and collectives."""
    from repro_torch.distributed import parallelize as par
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.dryrun import CollectiveCounter
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    model = _model(cfg, tree)
    toks = {"tokens": torch.from_numpy(_tokens(B, S)[:, :S])}
    pre = dec = None
    if mesh is not None:
        rules = sh.lm_rules(mesh, training=False)
        par.shard_module(model, rules, tf.param_axes(cfg))
        pre = par.Layout(rules, par.batch_axes_of(rules))
        toks, _ = par.local_batch(toks, pre)
        drules = sh.lm_rules(mesh, training=False, decode=True)
        dec = par.Layout(drules, par.batch_axes_of(drules))
    widths, real = [], moe._expert_ffn

    def recorded(params, x, act):
        widths.append(int(params["w_up"].shape[0]))
        return real(params, x, act)

    moe._expert_ffn = recorded
    try:
        with torch.no_grad():
            with par.use_layout(pre):
                logits, cache = tf.prefill(model, toks["tokens"],
                                           cache_dtype=torch.float32)
                g = par.seq_group()
                whole = {kv: par.gather(cache[kv], 2, g) for kv in ("k", "v")}
            out = {"prefill": logits.numpy(), "steps": []}
            with par.use_layout(dec):
                grown = tf.init_cache(cfg, B, S_MAX, torch.float32,
                                      device="cpu")
                n = grown["k"].shape[2]
                axes = par.split_axes("batch", "cache_seq")
                lo = par.line_index(mesh, axes) * n if axes else 0
                hi = min(lo + n, S)
                for kv in ("k", "v"):
                    if hi > lo:
                        grown[kv][:, :, :hi - lo] = whole[kv][:, :, lo:hi]
                grown["len"] = torch.tensor(S, dtype=torch.int32)
                nxt = logits[:, -1].argmax(-1, keepdim=True)
                for _ in range(DECODE):
                    widths.clear()
                    counter = CollectiveCounter()
                    with counter:
                        d, grown = tf.decode_step(model, grown, nxt)
                    nxt = d[:, -1].argmax(-1, keepdim=True)
                    out["steps"].append({
                        "logits": d.numpy(), "tokens": nxt.numpy(),
                        "expert_widths": list(widths),
                        "collectives": counter.counts})
    finally:
        moe._expert_ffn = real
    return out


def _train(cfg, tree, layout=None) -> dict:
    """Step 0's loss and gradients (whole) on a batch of ``TRAIN_B`` rows,
    with the expert widths the step computed with and its all-to-alls."""
    from repro_torch.distributed import parallelize as par
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.training.tree import leaves, module_tree
    model = _model(cfg, tree)
    t = torch.from_numpy(_tokens(TRAIN_B, S, seed=6))
    batch = {"tokens": t[:, :S], "labels": t[:, 1:],
             "mask": torch.ones((TRAIN_B, S))}
    if layout is not None:
        par.shard_module(model, layout.rules, tf.param_axes(cfg))
        batch, axes = par.local_batch(batch, layout)
        layout = par.Layout(layout.rules, axes)
    widths, a2a = [], []
    real_ffn, real_a2a = moe._expert_ffn, par.all_to_all

    def recorded(params, x, act):
        widths.append(int(params["w_up"].shape[0]))
        return real_ffn(params, x, act)

    def counted(x, g):
        a2a.append(tuple(x.shape))
        return real_a2a(x, g)

    moe._expert_ffn, par.all_to_all = recorded, counted
    try:
        with par.use_layout(layout):
            local = tf.loss_fn(model, batch)
            loss = par.batch_sum(local.detach())
        grads = torch.autograd.grad(local, leaves(module_tree(model)))
    finally:
        moe._expert_ffn, par.all_to_all = real_ffn, real_a2a
    return {"loss": float(loss), "grads": [par.full(g).numpy()
                                           for g in grads],
            "expert_widths": widths, "a2a_calls": len(a2a),
            "axes": layout.batch_axes if layout is not None else None}


# ---------------------------------------------------------------------------
# rank functions (spawned ranks import them by name)
# ---------------------------------------------------------------------------

def _serve_rank(rank: int, cases: dict) -> dict:
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    mesh = make_host_mesh((1, 2), ("data", "model"))
    return {name: _serve(cfg, tree, mesh)
            for name, (cfg, tree) in cases.items()}


def _train_rank(rank: int, cfg, tree) -> dict:
    from repro_torch.distributed import parallelize as par
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    mesh = make_host_mesh((2, 2), ("data", "model"))
    rules = sh.lm_rules(mesh)
    return _train(cfg, tree, par.Layout(rules, par.batch_axes_of(rules)))


def _reference(jcfg, params) -> dict:
    """The JAX package on one device: prefill, then greedy decode steps."""
    import jax.numpy as jnp

    from repro.models import transformer as j_tf
    toks = jnp.asarray(_tokens(B, S)[:, :S])
    logits, cache = j_tf.prefill(params, toks, jcfg, cache_dtype=jnp.float32)
    full = j_tf.init_cache(jcfg, B, S_MAX, jnp.float32)
    full["k"] = full["k"].at[:, :, :S].set(cache["k"])
    full["v"] = full["v"].at[:, :, :S].set(cache["v"])
    full["len"] = cache["len"]
    nxt = jnp.argmax(logits[:, -1], -1)[:, None]
    out = {"prefill": np.asarray(logits), "steps": []}
    for _ in range(DECODE):
        d, full = j_tf.decode_step(params, full, nxt, jcfg)
        nxt = jnp.argmax(d[:, -1], -1)[:, None]
        out["steps"].append({"logits": np.asarray(d),
                             "tokens": np.asarray(nxt)})
    return out


@pytest.fixture(scope="module")
def served() -> dict:
    import jax

    from repro.models import transformer as j_tf
    cases, ref = {}, {}
    for name, (E, shared) in CASES.items():
        cfg, jcfg = _configs(E, shared)
        params = j_tf.init_params(jax.random.PRNGKey(3), jcfg)
        cases[name] = (cfg, jax.tree_util.tree_map(np.asarray, params))
        ref[name] = _reference(jcfg, params)
    return {"ref": ref, "cfg": {k: c for k, (c, _) in cases.items()},
            "ranks": spawn_ranks(_serve_rank, 2, (cases,),
                                 timeout_s=RANK_TIMEOUT_S),
            "single": {name: _serve(cfg, tree)
                       for name, (cfg, tree) in cases.items()}}


@pytest.fixture(scope="module")
def trained() -> dict:
    import jax

    from repro.models import transformer as j_tf
    cfg, jcfg = _configs(*CASES["split"])
    tree = jax.tree_util.tree_map(
        np.asarray, j_tf.init_params(jax.random.PRNGKey(3), jcfg))
    return {"ranks": spawn_ranks(_train_rank, 4, (cfg, tree),
                                 timeout_s=RANK_TIMEOUT_S),
            "single": _train(cfg, tree)}


def _expert_bytes(cfg) -> int:
    """One expert weight's whole bytes (fp32)."""
    return cfg.moe.n_experts * cfg.d_model * cfg.moe.d_ff_expert * 4


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_one_device_and_reference(served, case):
    """The last prompt token's logits and four greedy decode steps: within
    1e-5 of one device and of the reference, tokens equal on all three."""
    one, ref = served["single"][case], served["ref"][case]
    np.testing.assert_allclose(one["prefill"], ref["prefill"], **TOL)
    for r, res in enumerate(served["ranks"]):
        got = res[case]
        np.testing.assert_allclose(got["prefill"], one["prefill"], **TOL,
                                   err_msg=f"rank {r} prefill")
        for i, (g, o, w) in enumerate(zip(got["steps"], one["steps"],
                                          ref["steps"])):
            what = f"rank {r} step {i}"
            np.testing.assert_allclose(g["logits"], o["logits"], **TOL,
                                       err_msg=what)
            np.testing.assert_allclose(g["logits"], w["logits"], **TOL,
                                       err_msg=what + " vs the reference")
            np.testing.assert_array_equal(g["tokens"], o["tokens"])
            np.testing.assert_array_equal(g["tokens"], w["tokens"])


def test_decode_runs_each_ranks_experts_and_gathers_none(served):
    """4 experts on 'model' 2: every decode step computes with 2 experts
    a layer on each rank (4 on one device), all-gathers less than one
    expert weight and all-reduces each layer's partial outputs."""
    cfg = served["cfg"]["split"]
    L, E = cfg.n_layers, cfg.moe.n_experts
    for step in served["single"]["split"]["steps"]:
        assert step["expert_widths"] == [E] * L
    for r, res in enumerate(served["ranks"]):
        for i, step in enumerate(res["split"]["steps"]):
            assert step["expert_widths"] == [E // 2] * L, (r, i)
            coll = step["collectives"]
            assert coll["all-gather"]["bytes"] < _expert_bytes(cfg), coll
            # each layer's (B, 1, d_model) partial outputs, summed in fp32
            assert coll["all-reduce"]["bytes"] >= L * B * cfg.d_model * 4


def test_experts_that_do_not_divide_model_run_whole(served):
    """3 experts do not divide 'model': the placement keeps them whole on
    every rank (the reference's ``divisible_spec``), and each rank runs all
    three, gathering nothing (serving weights are not FSDP)."""
    cfg = served["cfg"]["gathered"]
    for r, res in enumerate(served["ranks"]):
        for step in res["gathered"]["steps"]:
            assert step["expert_widths"] == [3] * cfg.n_layers
            assert step["collectives"]["all-gather"]["bytes"] < \
                _expert_bytes(cfg)


def test_training_step_with_split_experts_matches_one_device(trained):
    """A batch of 3 rows on (2, 2): rows whole, the sequence over 'model',
    no all-to-all; each rank's step computes with its 2 experts a layer.
    The loss and every gradient equal one device's."""
    want = trained["single"]
    for r, res in enumerate(trained["ranks"]):
        assert res["axes"] == () and res["a2a_calls"] == 0, res["axes"]
        # the forward, then the remat recompute of each layer
        assert set(res["expert_widths"]) == {2}, res["expert_widths"]
        np.testing.assert_allclose(res["loss"], want["loss"], rtol=1e-5,
                                   atol=1e-6, err_msg=f"rank {r}")
        assert len(res["grads"]) == len(want["grads"])
        for i, (a, b) in enumerate(zip(res["grads"], want["grads"])):
            np.testing.assert_allclose(a, b, **GRAD_TOL,
                                       err_msg=f"rank {r} grad {i}")
