"""The port's mixture-of-experts FFN (``repro_torch.models.moe``), its
``utils.rank_within_run``, and the two MoE LMs (olmoe-1b-7b, llama4-scout)
through checkpoints and the launcher, held against the JAX package on the
CPU with the reference's parameters carried across and its inputs fed to
both. (The MoE LMs' forward, gradients, AdamW steps, prefill and decode
are cases of ``tests/test_torch_transformer.py``.)

Tolerances:

  * the dispatch (``expert_in``, and each pick's token ``st``, gate
    ``sg``, ``slot`` and ``keep``) bit for bit, capacity drops and tied
    router probabilities included; the combine to rtol 1e-6;
  * ``apply_moe``'s output and aux loss rtol 1e-5, atol 1e-6; every
    gradient rtol 1e-4, atol 1e-5 x the tensor's largest entry (as the
    transformer tests' ``_grad_close``), under a loss of the LM's scale
    (a mean over the outputs plus the aux loss);
  * parameters after 6 AdamW steps across the packages' checkpoints: atol
    1e-4 (as the dense LMs' crossing), the port's resume bit for bit.

The ``gpu`` test runs one olmoe layer at its full widths on the card
against the CPU. This file collects without JAX: the reference is
imported inside the tests that use it.
"""

from __future__ import annotations

import dataclasses
import re
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_arrays, to_arrays
from repro_torch.core.search import topk_stable
from repro_torch.launch import train as t_launch
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tf
from repro_torch.training import optimizer as t_opt
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.train_loop import TrainConfig, fit
from repro_torch.training.tree import leaves
from repro_torch.utils import rank_within_run

D = 32


def _grad_close(got: np.ndarray, want, what: str) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=what)


def _tensors(tree, grad: bool = False):
    if isinstance(tree, dict):
        return {k: _tensors(v, grad) for k, v in tree.items()}
    return torch.tensor(np.array(tree), requires_grad=grad)


# MoE configs by case: (kwargs of MoEConfig, act)
CASES = {
    "olmoe": (dict(n_experts=8, top_k=2, d_ff_expert=16), "swiglu"),
    "llama4": (dict(n_experts=4, top_k=1, d_ff_expert=16, n_shared=1),
               "swiglu"),
    "gelu_shared": (dict(n_experts=8, top_k=2, d_ff_expert=16, n_shared=1),
                    "gelu"),
    "tied_router": (dict(n_experts=8, top_k=2, d_ff_expert=16), "swiglu"),
}


def _moe_world(case: str, B: int = 3, S: int = 40):
    """The reference's MoE config, parameters (numpy), input x and a
    loss weight r for ``case``. ``tied_router`` copies router columns 2
    and 3 into 5 and 6, so those experts' probabilities tie exactly and
    the top-k's tie order decides which of them a token takes."""
    import jax
    import jax.numpy as jnp

    from repro.models import moe as j_moe
    kw, act = CASES[case]
    jcfg = j_moe.MoEConfig(**kw)
    params = jax.tree_util.tree_map(np.asarray, j_moe.moe_init(
        jax.random.PRNGKey(0), D, jcfg, act, jnp.float32))
    if case == "tied_router":
        params["router"] = params["router"].copy()
        params["router"][:, 5:7] = params["router"][:, 2:4]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    r = rng.standard_normal((B, S, D)).astype(np.float32)
    return jcfg, t_moe.MoEConfig(**kw), act, params, x, r


@pytest.mark.parametrize("keys", [[3], [0, 0, 0, 0], [0, 1, 2, 3],
                                  "random"])
def test_rank_within_run_matches_reference(keys):
    import jax.numpy as jnp

    from repro.utils import rank_within_run as j_rank
    if keys == "random":
        keys = np.sort(np.random.default_rng(4).integers(0, 12, 500))
    keys = np.asarray(keys, np.int32)
    np.testing.assert_array_equal(
        rank_within_run(torch.from_numpy(keys)).numpy(),
        np.asarray(j_rank(jnp.asarray(keys))))


def _routing(probs: np.ndarray, K: int):
    """The reference's top-k and renormalised gates of ``probs``, and the
    port's, which must pick the same experts in the same order."""
    import jax
    import jax.numpy as jnp
    gates, idx = jax.lax.top_k(jnp.asarray(probs), K)
    _, t_idx = topk_stable(torch.tensor(probs), K)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(idx))
    gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
    return gates, idx


@pytest.mark.parametrize("case", ["skewed", "tied", "top1"])
def test_dispatch_and_combine_match_reference(case):
    """``dispatch`` against the reference's per-group
    ``_dispatch_one_group`` (vmapped over the B sequences) at capacity
    factor 1.25, with drops: every output bit for bit; ``combine`` on
    random expert outputs to rtol 1e-6. ``skewed`` favours two experts so
    that many picks drop; ``tied`` quantises the probabilities so most
    rows hold ties, which the top-k must break by the lower id;
    ``top1`` is llama4's K = 1."""
    import jax
    import jax.numpy as jnp

    from repro.models import moe as j_moe
    E, K = (4, 1) if case == "top1" else (8, 2)
    B, S = 3, 32
    C = max(1, int(S * K / E * 1.25))
    rng = np.random.default_rng({"skewed": 0, "tied": 1, "top1": 2}[case])
    logits = rng.standard_normal((B, S, E)).astype(np.float32)
    if case == "skewed":
        logits[..., :2] += 1.5
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    if case == "tied":
        probs = (np.round(probs * 4) / 4).astype(np.float32)
    gates, idx = _routing(probs, K)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    want_in, want_info = jax.vmap(
        lambda xg, gg, ig: j_moe._dispatch_one_group(xg, gg, ig, E, C))(
        jnp.asarray(x), gates, idx)
    got_in, got_info = t_moe.dispatch(
        torch.from_numpy(x), torch.tensor(np.asarray(gates)),
        torch.tensor(np.asarray(idx)), E, C)
    np.testing.assert_array_equal(got_in.numpy(), np.asarray(want_in))
    for name, g, w in zip(("st", "sg", "slot", "keep"), got_info, want_info):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert not np.asarray(want_info[3]).all(), "no pick was dropped"

    eo = rng.standard_normal((B, E, C, D)).astype(np.float32)
    want = jax.vmap(lambda e, st, sg, slot, keep: j_moe._combine_one_group(
        e, (st, sg, slot, keep), S))(jnp.asarray(eo), *want_info)
    got = t_moe.combine(torch.from_numpy(eo), got_info, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_apply_moe_matches_reference(case):
    """``apply_moe`` at capacity factor 1.25 (drops happen): the routing
    (the experts each token takes, in order), the output and the aux loss,
    then the gradients of every parameter and of x under ``mean(y * r) +
    aux``."""
    import jax
    import jax.numpy as jnp

    from repro.models import moe as j_moe
    jcfg, tcfg, act, params, x, r = _moe_world(case)
    jp = jax.tree_util.tree_map(jnp.asarray, params)

    def j_loss(p, xx):
        y, aux = j_moe.apply_moe(p, xx, jcfg, act)
        return jnp.mean(y * r) + aux, (y, aux)

    (_, (want_y, want_aux)), (want_gp, want_gx) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    j_probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], -1)
    _, j_idx = jax.lax.top_k(j_probs, jcfg.top_k)

    tp = _tensors(params, grad=True)
    tx = torch.tensor(x, requires_grad=True)
    _, _, t_idx = t_moe.route(tp, tx, tcfg)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    if case == "tied_router":
        top = np.asarray(j_idx)
        assert ((top == 2) | (top == 5)).any(-1).sum() > 0
    y, aux = t_moe.apply_moe(tp, tx, tcfg, act)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-5,
                               atol=1e-6)
    (torch.mean(y * torch.from_numpy(r)) + aux).backward()
    _grad_close(tx.grad.numpy(), want_gx, "x")
    got_g = leaves(to_arrays(_grad_tree(tp)))
    want_flat = jax.tree_util.tree_leaves(want_gp)
    assert len(got_g) == len(want_flat) == len(leaves(params))
    for i, (g, w) in enumerate(zip(got_g, want_flat)):
        _grad_close(g, w, f"gradient leaf {i}")


def _grad_tree(tree):
    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    return tree.grad


def test_moe_routing_mass():
    """The reference's test on the port, on the reference's weights and
    input (olmoe's smoke MoE): the output has x's shape and is finite, the
    load-balance loss is nonnegative, the renormalised gates of every
    token sum to 1, and output and aux equal the reference's."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as j_get_arch
    from repro.models import moe as j_moe
    jcfg = j_get_arch("olmoe-1b-7b").smoke_config()
    cfg = get_arch("olmoe-1b-7b").smoke_config()
    p = j_moe.moe_init(jax.random.PRNGKey(0), jcfg.d_model, jcfg.moe,
                       jcfg.act, jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 8, jcfg.d_model))
    want_y, want_aux = j_moe.apply_moe(p, x, jcfg.moe, jcfg.act)
    tp = _tensors(jax.tree_util.tree_map(np.asarray, p))
    tx = torch.from_numpy(np.asarray(x))
    y, aux = t_moe.apply_moe(tp, tx, cfg.moe, cfg.act)
    assert y.shape == tx.shape
    assert bool(torch.isfinite(y).all())
    assert float(aux) >= 0.0
    _, gates, _ = t_moe.route(tp, tx, cfg.moe)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


def test_moe_init_matches_reference_layout():
    """moe_init: the reference's names, shapes and dtypes (the router
    float32 under a bf16 ``dtype``), at olmoe's and llama4's smoke
    configs."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as j_get_arch
    from repro.models import moe as j_moe
    for arch in ("olmoe-1b-7b", "llama4-scout-17b-a16e"):
        jcfg = j_get_arch(arch).smoke_config()
        cfg = get_arch(arch).smoke_config()
        want = j_moe.moe_init(jax.random.PRNGKey(0), jcfg.d_model, jcfg.moe,
                              jcfg.act, jnp.bfloat16)
        got = t_moe.moe_init(torch.Generator().manual_seed(0), cfg.d_model,
                             cfg.moe, cfg.act, torch.bfloat16)
        w_flat, g_flat = jax.tree_util.tree_leaves(want), leaves(got)
        assert sorted(got) == sorted(want)
        assert len(w_flat) == len(g_flat)
        for w, g in zip(w_flat, g_flat):
            assert tuple(g.shape) == w.shape
            assert str(g.dtype).split(".")[-1] == str(w.dtype)


# ---------------------------------------------------------------------------
# checkpoints across the packages and the launcher (olmoe)
# ---------------------------------------------------------------------------

def _olmoe_setup():
    import jax

    from repro.configs import get_arch as j_get_arch
    from repro.data import pipeline as j_pl
    from repro.models import transformer as j_tf
    jcfg = j_get_arch("olmoe-1b-7b").smoke_config()
    tree = jax.tree_util.tree_map(np.asarray, j_tf.init_params(
        jax.random.PRNGKey(0), jcfg))
    batches = []
    for s in range(6):
        b = j_pl.lm_batch(j_pl.LMDataSpec(jcfg.vocab, 17, 2), s)
        batches.append({k: np.array(v[:, :16]) for k, v in b.items()})
    return j_tf, jcfg, tree, batches


def _port_fit(tree, batches, steps, ckpt_dir):
    cfg = get_arch("olmoe-1b-7b").smoke_config()
    model = lm_params_from_arrays(tree, cfg, device="cpu")
    data = lambda s: {k: torch.from_numpy(v) if k == "mask"    # noqa: E731
                      else torch.from_numpy(v).long()
                      for k, v in batches[s].items()}
    model, _ = fit(params=model, optimizer=t_opt.adamw(
        t_opt.cosine_schedule(1e-3, warmup=2, total=6)),
        loss_fn=t_tf.loss_fn, data_fn=data,
        cfg=TrainConfig(steps=steps, log_every=50, checkpoint_every=3),
        ckpt_dir=ckpt_dir, log_fn=lambda s: None)
    return leaves(to_arrays(model))


def _ref_fit(j_tf, jcfg, tree, batches, steps, ckpt_dir):
    import jax
    import jax.numpy as jnp

    from repro.training import optimizer as j_opt
    from repro.training.train_loop import TrainConfig as JTrainConfig
    from repro.training.train_loop import fit as j_fit
    p, _ = j_fit(params=jax.tree_util.tree_map(jnp.asarray, tree),
                 optimizer=j_opt.adamw(j_opt.cosine_schedule(
                     1e-3, warmup=2, total=6)),
                 loss_fn=lambda p, b: j_tf.loss_fn(p, b, jcfg),
                 data_fn=lambda s: {k: jnp.asarray(v)
                                    for k, v in batches[s].items()},
                 cfg=JTrainConfig(steps=steps, log_every=50,
                                  checkpoint_every=3),
                 ckpt_dir=ckpt_dir, log_fn=lambda s: None)
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(p)]


def test_moe_checkpoints_cross_between_packages(tmp_path):
    """olmoe's smoke LM: the reference's fit stops at step 2 and the
    port's fit resumes its directory to step 5, and the other way round;
    both equal the reference's uninterrupted 6-step run (atol 1e-4), and
    the port's resumed run its uninterrupted one bit for bit. The experts
    cross stacked (L, E, ...) in the reference's leaf order (router,
    w_down, w_gate, w_up)."""
    j_tf, jcfg, tree, batches = _olmoe_setup()
    want = _ref_fit(j_tf, jcfg, tree, batches, 6, None)
    port_full = _port_fit(tree, batches, 6, None)
    a, b, c = (str(tmp_path / x) for x in "abc")
    _ref_fit(j_tf, jcfg, tree, batches, 3, a)
    got_a = _port_fit(tree, batches, 6, a)
    _port_fit(tree, batches, 3, b)
    got_b = _ref_fit(j_tf, jcfg, tree, batches, 6, b)
    _port_fit(tree, batches, 3, c)
    got_c = _port_fit(tree, batches, 6, c)
    assert len(want) == len(got_a) == len(got_b) == len(port_full) == 15
    assert [x.shape for x in port_full[10:14]] == [(2, 64, 8), (2, 8, 64, 64),
                                                  (2, 8, 64, 64),
                                                  (2, 8, 64, 64)]
    for i, (w, x, y, f, r) in enumerate(zip(want, got_a, got_b, port_full,
                                            got_c)):
        for what, v in (("ref -> port", x), ("port -> ref", y),
                        ("port uninterrupted", f)):
            np.testing.assert_allclose(v, w, rtol=1e-5, atol=1e-4,
                                       err_msg=f"{what}, leaf {i}")
        np.testing.assert_array_equal(r, f, err_msg=f"port resume, leaf {i}")
    assert CheckpointManager(b).steps() == [2, 5]


def _shape(line: str) -> str:
    return re.sub(r"-?\d+\.\d+", "X", line)


def test_moe_launcher_lines_match_reference(capsys, monkeypatch, tmp_path):
    """``--arch olmoe-1b-7b`` prints the JAX launcher's lines, numbers
    aside (the two draw different initial weights); its losses are finite
    and the metrics file carries the active parameter count."""
    import json
    import math

    from repro.launch import train as j_launch
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "olmoe-1b-7b",
                                      "--steps", "4", "--batch", "2"])
    j_launch.main()
    want = capsys.readouterr().out.splitlines()
    metrics = tmp_path / "m.json"
    t_launch.main(["--device", "cpu", "--arch", "olmoe-1b-7b", "--steps",
                   "4", "--batch", "2", "--metrics-json", str(metrics)])
    got = capsys.readouterr().out.splitlines()
    assert [_shape(x) for x in got] == [_shape(x) for x in want]
    assert got[-1].startswith("[train] done: loss") and len(got) == 5
    m = json.loads(metrics.read_text())
    cfg = get_arch("olmoe-1b-7b").smoke_config()
    assert all(math.isfinite(h["loss"]) for h in m["history"])
    assert m["active_param_count"] == cfg.active_param_count()
    assert m["param_count"] == cfg.param_count() > cfg.active_param_count()


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_full_width_layer_on_card_equals_cpu(monkeypatch):
    """One olmoe decoder layer at its full widths (d 2048, 16 heads, 64
    experts of d_ff 1024, top-8; fp32 compute, TF32 off) on 2 x 128
    random hidden states, on the card against the CPU: every token takes
    the same experts in the same order (or its K-th and K+1-th
    probabilities tie within 2e-5, and its sequence is left out of what
    follows), the output and aux loss to rtol 1e-4 (atol 1e-5 x the
    largest output), the gradients as ``_grad_close``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import norm_init
    cfg = dataclasses.replace(get_arch("olmoe-1b-7b").config(),
                              dtype="float32")
    g = torch.Generator().manual_seed(3)
    p = {"ln1": norm_init(cfg.norm, cfg.d_model),
         "ln2": norm_init(cfg.norm, cfg.d_model),
         "attn": attn.attn_init(g, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.head_dim, cfg.qk_norm),
         "moe": t_moe.moe_init(g, cfg.d_model, cfg.moe, cfg.act)}
    x = torch.randn((2, 128, cfg.d_model), generator=g)
    r = torch.randn((2, 128, cfg.d_model), generator=g)
    route = t_moe.route
    out = {}
    for dev in ("cpu", "cuda"):
        layer = t_tf.DecoderLayer(cfg, p).to(dev)
        routed = []
        monkeypatch.setattr(t_moe, "route", lambda *a: routed.append(
            route(*a)) or routed[-1])
        xd = x.to(dev).detach().requires_grad_(True)
        y, aux = layer(xd)
        (torch.mean(y * r.to(dev)) + aux).backward()
        probs, _, idx = routed[0]
        out[dev] = dict(y=y.detach().cpu(), aux=float(aux.detach()),
                        gx=xd.grad.cpu(), probs=probs.detach().cpu(),
                        idx=idx.cpu(), grads=[q.grad.cpu() for q in
                                              layer.parameters()])
    c, d = out["cpu"], out["cuda"]
    K = cfg.moe.top_k
    flipped = (c["idx"] != d["idx"]).any(-1)                   # (B, S)
    for b, s in flipped.nonzero().tolist():
        top = torch.sort(c["probs"][b, s], descending=True).values
        assert float(top[K - 1] - top[K]) <= 2e-5 * float(top[K]), (b, s)
    rows = ~flipped.any(-1)
    assert bool(rows.any())
    np.testing.assert_allclose(
        d["y"][rows].numpy(), c["y"][rows].numpy(), rtol=1e-4,
        atol=1e-5 * float(c["y"].abs().max()))
    if not bool(flipped.any()):
        np.testing.assert_allclose(d["aux"], c["aux"], rtol=1e-4)
        _grad_close(d["gx"].numpy(), c["gx"].numpy(), "x")
        for i, (a, w) in enumerate(zip(d["grads"], c["grads"])):
            _grad_close(a.numpy(), w.numpy(), f"parameter {i}")
