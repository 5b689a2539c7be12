"""Training the sparse encoder in the port, held against the JAX package on
the CPU: ``contrastive_loss``'s gradients by autograd against
``jax.value_and_grad`` of the reference's, three train steps, a
checkpoint of the reference's encoder restored into the port's, and the
example ``python -m repro_torch.examples.train_sparse_encoder --small``
run to its end beside the reference's ``examples/train_sparse_encoder.py
--small``.

The encoder is tests/test_torch_encoder.py's smoke config (V 512, d 64, 2
layers) on the reference's weights carried across. Tolerances: loss rtol
1e-5; each gradient rtol 1e-4, atol 1e-5 x its tensor's largest entry
(the two frameworks sum in other orders); after 3 AdamW steps at lr 1e-3
the moments to atol 1e-4 x their tensor's largest entry (three rounds of
that rounding, each scaled by its own clip factor) and the parameters to
atol 1e-4 (a first AdamW step moves a weight by about lr x sign(g), which
rounding can tip where g is near zero). The ``gpu``
test holds 2 steps at the published widths on the card against the CPU.
This file collects without JAX: the reference is imported inside the
tests that use it.
"""

from __future__ import annotations

import copy
import re
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.convert import (encoder_params_from_arrays,
                                 encoder_params_to_arrays, to_arrays)
from repro_torch.examples import train_sparse_encoder as t_example
from repro_torch.models import sparse_encoder as t_se
from repro_torch.training import optimizer as t_opt
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.train_loop import TrainConfig, make_train_step
from repro_torch.training.tree import leaves, module_tree, tree_map

ROOT = Path(__file__).resolve().parents[1]
SMOKE = dict(vocab=512, d_model=64, n_layers=2, n_heads=4, d_ff=128,
             max_seq=32)


def _grad_close(got: np.ndarray, want, what: str,
                of_max: float = 1e-5) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=of_max * float(np.abs(want).max()),
                               err_msg=what)


def _encoders():
    import jax

    from repro.models import sparse_encoder as j_se
    cfg = j_se.SparseEncConfig(**SMOKE)
    params = j_se.init_params(jax.random.PRNGKey(0), cfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = encoder_params_from_arrays(tree, t_se.SparseEncConfig(**SMOKE),
                                       device="cpu")
    return j_se, cfg, params, model


def _pairs(seed: int, B: int = 6, S: int = 32) -> dict:
    """Queries and docs with shared topical tokens, two rows of each cut
    short (one to a single token)."""
    rng = np.random.default_rng(seed)
    topic = rng.integers(0, SMOKE["vocab"] // 64, (B, 1))
    base = topic * 64 + rng.integers(0, 32, (B, S))
    out = {}
    for side in ("q", "d"):
        toks = np.where(np.arange(S) < S // 2, base,
                        rng.integers(0, SMOKE["vocab"], (B, S)))
        lens = np.full(B, S)
        lens[-2:] = (1, 11) if side == "q" else (20, 5)
        out[f"{side}_tokens"] = toks.astype(np.int32)
        out[f"{side}_mask"] = np.arange(S)[None, :] < lens[:, None]
    return out


def _jax(b: dict) -> dict:
    import jax.numpy as jnp
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b: dict) -> dict:
    return {k: torch.from_numpy(v).long() if k.endswith("tokens")
            else torch.from_numpy(v) for k, v in b.items()}


def test_contrastive_loss_grads_match_reference():
    import jax
    j_se, cfg, params, model = _encoders()
    b = _pairs(1)
    want, want_g = jax.value_and_grad(
        lambda p: j_se.contrastive_loss(p, _jax(b), cfg))(params)
    loss = t_se.contrastive_loss(model, _torch(b))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    got = leaves(to_arrays(tree_map(lambda p: p.grad, module_tree(model))))
    want_flat = jax.tree_util.tree_leaves(want_g)
    assert len(got) == len(want_flat) == 14
    for i, (g, w) in enumerate(zip(got, want_flat)):
        assert g.shape == w.shape
        _grad_close(g, w, f"gradient leaf {i}")
    # the tied MLM head gives every embedding row a gradient, the rows of
    # tokens no batch row holds included
    used = np.unique(np.concatenate([b["q_tokens"].ravel(),
                                     b["d_tokens"].ravel()]))
    unused = np.setdiff1d(np.arange(SMOKE["vocab"]), used)
    emb_g = model.embed.grad.numpy()
    assert np.abs(emb_g[unused]).max() > 0    # the tied MLM head reaches all
    assert model.mlm_bias.grad.abs().max() > 0


def test_train_steps_match_reference():
    """Three steps of make_train_step (AdamW at lr 1e-3, clip 1.0) on three
    pair batches: loss and grad norm each step, then the parameters and
    both moments."""
    import jax
    import jax.numpy as jnp

    from repro.training import optimizer as j_opt
    from repro.training.train_loop import TrainConfig as JTrainConfig
    from repro.training.train_loop import make_train_step as j_make
    j_se, cfg, params, model = _encoders()
    j_adam = j_opt.adamw(j_opt.constant_schedule(1e-3))
    j_step = jax.jit(j_make(lambda p, b: j_se.contrastive_loss(p, b, cfg),
                            j_adam, JTrainConfig()))
    t_adam = t_opt.adamw(t_opt.constant_schedule(1e-3))
    t_step = make_train_step(t_se.contrastive_loss, t_adam, TrainConfig())
    j_state, t_state = j_adam.init(params), t_adam.init(module_tree(model))
    for i in range(3):
        b = _pairs(10 + i)
        params, j_state, jm = j_step(params, j_state, _jax(b), jnp.int32(i))
        model, t_state, tm = t_step(model, t_state, _torch(b), i)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=f"step {i} {k}")
    for what, got, want in (("params", model, params),
                            ("mu", t_state["mu"], j_state["mu"]),
                            ("nu", t_state["nu"], j_state["nu"])):
        arrays = (encoder_params_to_arrays(got) if what == "params"
                  else to_arrays(got))
        for i, (g, w) in enumerate(zip(leaves(arrays),
                                       jax.tree_util.tree_leaves(want),
                                       strict=True)):
            if what == "params":
                np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5,
                                           atol=1e-4, err_msg=f"leaf {i}")
            else:
                _grad_close(g, w, f"{what} leaf {i}", of_max=1e-4)


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """A {"step", "params", "opt_state"} checkpoint of the reference's
    encoder (its CheckpointManager) restores into the port's fit template:
    the parameters and moments land in the port's modules and lists."""
    import jax
    import jax.numpy as jnp

    from repro.training import optimizer as j_opt
    from repro.training.checkpoint import CheckpointManager as JManager
    j_se, cfg, params, model = _encoders()
    state = j_opt.adamw(j_opt.constant_schedule(1e-3)).init(params)
    state["mu"] = jax.tree_util.tree_map(lambda x: x + 0.25, state["mu"])
    JManager(str(tmp_path)).save(9, {"step": 9, "params": params,
                                     "opt_state": state})
    fresh = t_se.init_params(torch.Generator().manual_seed(4),
                             t_se.SparseEncConfig(**SMOKE), device="cpu")
    t_state = t_opt.adamw(t_opt.constant_schedule(1e-3)).init(
        module_tree(fresh))
    mgr = CheckpointManager(str(tmp_path))
    got = mgr.restore_latest({"step": 0, "params": fresh,
                              "opt_state": t_state})
    assert int(got["step"]) == 9
    mgr.cast_like(got["params"], fresh)
    t_state = mgr.cast_like(got["opt_state"], t_state)
    for a, b in zip(fresh.parameters(), model.parameters()):
        assert torch.equal(a, b)
    assert all(bool((x == 0.25).all()) for x in leaves(t_state["mu"]))
    assert isinstance(t_state["mu"]["layers"], list)


def _shape(line: str) -> str:
    return re.sub(r"\d+(\.\d+)?", "N", line)


def test_example_runs_to_its_end(tmp_path, capsys, monkeypatch):
    """``--small --device cpu`` trains 40 steps, builds the learned index
    and serves 16 queries, printing the reference example's lines (numbers
    aside); the loss falls and ASC at mu 0.9 keeps most of the exact
    top 10. A rerun on the same directory resumes at the last step."""
    d = str(tmp_path / "port")
    t_example.main(["--small", "--device", "cpu", "--ckpt-dir", d])
    got = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["train_sparse_encoder.py", "--small",
                                      "--ckpt-dir", str(tmp_path / "ref")])
    runpy.run_path(str(ROOT / "examples" / "train_sparse_encoder.py"),
                   run_name="__main__")
    want = capsys.readouterr().out.splitlines()
    assert [_shape(x) for x in got] == [_shape(x) for x in want]
    trained = next(x for x in got if x.startswith("trained"))
    first, last = map(float, re.findall(r"loss (\S+) -> (\S+)", trained)[0])
    assert last < first
    recall = float(re.findall(r"recall@10 vs exact = (\S+),", got[-1])[0])
    assert recall >= 0.8
    assert CheckpointManager(d).steps() == [25, 38, 39]
    t_example.main(["--small", "--device", "cpu", "--ckpt-dir", d])
    again = capsys.readouterr().out.splitlines()
    assert "[fit] resumed from step 39" in again
    assert again[-1] == got[-1]


def test_synth_pairs_and_refusal(monkeypatch):
    """synth_pairs is a function of the step alone; queries and docs share
    their first half; without a card the example refuses ``cuda``."""
    a = t_example.synth_pairs(2048, 24, 16, 3)
    b = t_example.synth_pairs(2048, 24, 16, 3)
    c = t_example.synth_pairs(2048, 24, 16, 4)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["q_tokens"], c["q_tokens"])
    assert torch.equal(a["q_tokens"][:, :12], a["d_tokens"][:, :12])
    assert not torch.equal(a["q_tokens"][:, 12:], a["d_tokens"][:, 12:])
    assert int(a["q_tokens"].max()) < 2048 and bool(a["q_mask"].all())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        t_example.main(["--small"])


@pytest.mark.gpu
def test_two_steps_on_card_equal_cpu(monkeypatch):
    """SparseEncConfig() at its published widths, the example's optimizer
    and batch 8 of its synthetic pairs, 2 steps on the card and on the CPU
    (fp32, TF32 off): loss and grad norm each step rtol 1e-4, the first
    moment per tensor rtol 1e-3, atol 1e-3 x its largest entry (the
    embedding's gradient sums the gathered rows and the tied head in each
    device's order, by atomics on the card, and cancels near zero), the
    parameters atol 2 x (the two steps' learning rates summed), the most
    sign-tipped AdamW updates can move them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = t_se.SparseEncConfig()
    on_cpu = t_se.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    on_card = copy.deepcopy(on_cpu).to("cuda")
    opt = t_example.make_optimizer(300)
    out = {}
    for name, model in (("cpu", on_cpu), ("card", on_card)):
        step = make_train_step(t_se.contrastive_loss, opt,
                               t_example.train_config(300))
        state = opt.init(module_tree(model))
        ms = []
        for s in range(2):
            model, state, m = step(model, state,
                                   t_example.synth_pairs(cfg.vocab, 64, 8, s),
                                   s)
            ms.append({k: float(v) for k, v in m.items()})
        out[name] = (ms, state, model)
    (mc, sc, pc), (mg, sg, pg) = out["cpu"], out["card"]
    for a, c in zip(mg, mc):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[k], c[k], rtol=1e-4)
    for a, c in zip(leaves(sg["mu"]), leaves(sc["mu"])):
        np.testing.assert_allclose(a.cpu().numpy(), c.numpy(), rtol=1e-3,
                                   atol=1e-3 * float(c.abs().max()))
    sched = t_example.schedule(300)
    lr_sum = sum(float(sched(s)) for s in range(2))
    for a, c in zip(pg.parameters(), pc.parameters()):
        np.testing.assert_allclose(a.detach().cpu().numpy(),
                                   c.detach().numpy(), rtol=0,
                                   atol=2 * lr_sum + 1e-7)

