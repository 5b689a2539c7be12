"""The port's decoder-only LM (``repro_torch.models.transformer``), its
configs and the training launcher, held against the JAX package on the
CPU, with the reference's parameters carried across by
``convert.lm_params_from_arrays`` and the reference's batches fed to both.

The smoke configs of olmo-1b (non-parametric LN, tied head), stablelm-3b
(LN, untied) and qwen3-14b (RMS, qk-norm, GQA 8/2) at depth 2, fp32 on
both sides. Tolerances:

  * loss and logits rtol 1e-5, atol 1e-5 (sums in another order);
  * every gradient: rtol 1e-4, atol 1e-5 x the tensor's largest entry
    (small entries of a gradient carry the absolute rounding of the
    large ones);
  * parameters after 3 AdamW steps at lr 1e-3: atol 1e-4. AdamW's first
    steps move a weight by about lr x sign(g), so where a gradient entry
    is near zero the two frameworks' fp32 rounding can tip its update by
    a fraction of lr; everywhere else they agree to 1e-6;
  * prefill and decode logits and caches rtol 1e-5, atol 1e-5.

The ``gpu`` test runs one step of the olmo-1b config at depth 2 with its
full widths on the card against the CPU. This file collects without JAX
(the machine with the card has none): the reference is imported inside
the tests that use it.
"""

from __future__ import annotations

import dataclasses
import re
import shutil
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import (arch_kind, get_arch, list_archs,
                                 missing_module)
from repro_torch.convert import (lm_params_from_arrays, lm_params_to_arrays,
                                 to_arrays)
from repro_torch.launch import train as t_launch
from repro_torch.models import transformer as t_tf
from repro_torch.training import optimizer as t_opt
from repro_torch.training.train_loop import TrainConfig, make_train_step
from repro_torch.training.tree import leaves, module_tree, tree_map

DENSE = ["olmo-1b", "stablelm-3b", "qwen3-14b"]
TOL = dict(rtol=1e-5, atol=1e-5)
B, S = 2, 32


def _grad_close(got: np.ndarray, want, what: str) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=what)


def _reference(arch: str, **over):
    """The reference's config, initial parameters and the port's model
    carried across from them."""
    import jax

    from repro.configs import get_arch as j_get_arch
    from repro.models import transformer as j_tf
    jcfg = dataclasses.replace(j_get_arch(arch).smoke_config(), **over)
    tcfg = dataclasses.replace(get_arch(arch).smoke_config(), **over)
    params = j_tf.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return j_tf, jcfg, params, lm_params_from_arrays(tree, tcfg, device="cpu")


def _batch(vocab: int, step: int) -> dict:
    """The reference's LM batch of ``step``, cut to S as its launcher cuts
    it, as numpy."""
    from repro.data import pipeline as j_pl
    b = j_pl.lm_batch(j_pl.LMDataSpec(vocab, S + 1, B), step)
    return {k: np.array(v[:, :S]) for k, v in b.items()}


def _jax(b: dict) -> dict:
    import jax.numpy as jnp
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b: dict) -> dict:
    return {k: torch.from_numpy(v) if k == "mask"
            else torch.from_numpy(v).long() for k, v in b.items()}


@pytest.mark.parametrize("arch", DENSE)
def test_forward_loss_and_grads_match_reference(arch):
    import jax
    j_tf, jcfg, params, model = _reference(arch)
    b = _batch(jcfg.vocab, 0)
    want_logits, _ = j_tf.forward(params, _jax(b)["tokens"], jcfg)
    want_loss, want_g = jax.value_and_grad(
        lambda p: j_tf.loss_fn(p, _jax(b), jcfg))(params)
    with torch.no_grad():
        logits, aux = t_tf.forward(model, _torch(b)["tokens"])
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               **TOL)
    assert float(aux) == 0.0
    loss = t_tf.loss_fn(model, _torch(b))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    got_g = leaves(to_arrays(tree_map(lambda p: p.grad, module_tree(model))))
    want_flat = jax.tree_util.tree_leaves(want_g)
    assert len(got_g) == len(want_flat)
    for i, (g, w) in enumerate(zip(got_g, want_flat)):
        assert g.shape == w.shape and g.dtype == np.float32
        _grad_close(g, w, f"gradient leaf {i}")


@pytest.mark.parametrize("arch", DENSE)
def test_adamw_steps_match_reference(arch):
    """Three steps of make_train_step (AdamW at lr 1e-3, clip 1.0) on the
    reference's batches 0..2: loss and grad norm each step, the parameters
    and both moments after the third."""
    import jax
    import jax.numpy as jnp

    from repro.training import optimizer as j_opt
    from repro.training.train_loop import TrainConfig as JTrainConfig
    from repro.training.train_loop import make_train_step as j_make
    j_tf, jcfg, params, model = _reference(arch)
    j_adam = j_opt.adamw(j_opt.constant_schedule(1e-3))
    j_step = jax.jit(j_make(lambda p, b: j_tf.loss_fn(p, b, jcfg), j_adam,
                            JTrainConfig()))
    t_adam = t_opt.adamw(t_opt.constant_schedule(1e-3))
    t_step = make_train_step(t_tf.loss_fn, t_adam, TrainConfig())
    j_state, t_state = j_adam.init(params), t_adam.init(module_tree(model))
    for i in range(3):
        b = _batch(jcfg.vocab, i)
        params, j_state, jm = j_step(params, j_state, _jax(b), jnp.int32(i))
        model, t_state, tm = t_step(model, t_state, _torch(b), i)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=f"step {i} {k}")
    for what, got, want in (("params", model, params),
                            ("mu", t_state["mu"], j_state["mu"]),
                            ("nu", t_state["nu"], j_state["nu"])):
        got_flat = leaves(lm_params_to_arrays(got) if what == "params"
                          else to_arrays(got))
        want_flat = jax.tree_util.tree_leaves(want)
        assert len(got_flat) == len(want_flat)
        for i, (g, w) in enumerate(zip(got_flat, want_flat)):
            if what == "params":
                np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5,
                                           atol=1e-4, err_msg=f"leaf {i}")
            else:
                _grad_close(g, w, f"{what} leaf {i}")


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_reference(arch):
    """prefill's last-token logits and cache, then one decode step into a
    cache grown to S + 1 (the reference smoke test's protocol), both
    against the reference; the decoded logits also equal a full forward
    over S + 1 tokens."""
    import jax.numpy as jnp
    j_tf, jcfg, params, model = _reference(arch)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (B, 16))
    j_logits, j_cache = j_tf.prefill(params, jnp.asarray(toks), jcfg,
                                     cache_dtype=jnp.float32)
    with torch.no_grad():
        logits, cache = t_tf.prefill(model, torch.from_numpy(toks),
                                     cache_dtype=torch.float32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(j_cache[k]),
                                   err_msg=k, **TOL)
    assert int(cache["len"]) == int(j_cache["len"]) == 16

    nxt = np.array(jnp.argmax(j_logits[:, -1, :], -1))[:, None]
    j_full = j_tf.init_cache(jcfg, B, 17, jnp.float32)
    j_full["k"] = j_full["k"].at[:, :, :16].set(j_cache["k"])
    j_full["v"] = j_full["v"].at[:, :, :16].set(j_cache["v"])
    j_full["len"] = j_cache["len"]
    j_dec, j_cache2 = j_tf.decode_step(params, j_full, jnp.asarray(nxt), jcfg)
    full = t_tf.init_cache(model.cfg, B, 17, torch.float32, device="cpu")
    full["k"][:, :, :16] = cache["k"]
    full["v"][:, :, :16] = cache["v"]
    full["len"] = cache["len"]
    with torch.no_grad():
        dec, cache2 = t_tf.decode_step(model, full, torch.from_numpy(nxt))
        whole, _ = t_tf.forward(model, torch.cat(
            [torch.from_numpy(toks), torch.from_numpy(nxt)], 1))
    np.testing.assert_allclose(dec.numpy(), np.asarray(j_dec), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache2[k].numpy(),
                                   np.asarray(j_cache2[k]), err_msg=k, **TOL)
    assert int(cache2["len"]) == 17
    np.testing.assert_allclose(dec[:, 0].numpy(), whole[:, -1].numpy(),
                               rtol=1e-4, atol=1e-4)


def test_remat_changes_no_value():
    """Recomputing each layer in the backward pass gives the same loss and
    gradients, bit for bit, as keeping the activations."""
    _, jcfg, _, model = _reference("qwen3-14b")
    b = _torch(_batch(jcfg.vocab, 0))
    grads = {}
    for remat in (True, False):
        model.cfg = dataclasses.replace(model.cfg, remat=remat)
        for layer in model.layers:
            layer.cfg = model.cfg
        model.zero_grad()
        loss = t_tf.loss_fn(model, b)
        loss.backward()
        grads[remat] = (loss.item(), [p.grad.clone()
                                      for p in model.parameters()])
    assert grads[True][0] == grads[False][0]
    assert all(torch.equal(a, c) for a, c in zip(grads[True][1],
                                                 grads[False][1]))


def test_mixed_precision_keeps_float32_masters():
    """dtype bfloat16 (the full configs' compute dtype): the masters and
    their gradients stay float32, the logits come out bf16, and the loss
    stays within bf16's rounding (rtol 2e-2) of the reference's in bf16."""
    import jax
    j_tf, jcfg, params, model = _reference("olmo-1b", dtype="bfloat16")
    b = _batch(jcfg.vocab, 0)
    want = float(j_tf.loss_fn(params, _jax(b), jcfg))
    loss = t_tf.loss_fn(model, _torch(b))
    loss.backward()
    with torch.no_grad():
        logits, _ = t_tf.forward(model, _torch(b)["tokens"])
    assert logits.dtype == torch.bfloat16
    assert all(p.dtype == p.grad.dtype == torch.float32
               for p in model.parameters())
    np.testing.assert_allclose(loss.item(), want, rtol=2e-2)
    assert jax.tree_util.tree_leaves(params)[0].dtype == np.float32


def test_configs_and_registry_match_reference():
    """All eleven ids; the ported ones' configs field by field (the MoE
    field aside) and their parameter counts at full width; the others
    name the module still to port."""
    from repro.configs import arch_kind as j_kind
    from repro.configs import get_arch as j_get_arch
    from repro.configs import list_archs as j_list
    assert list_archs() == j_list() and len(list_archs()) == 11
    for arch in list_archs():
        assert arch_kind(arch) == j_kind(arch)
    for arch in DENSE:
        for preset in ("config", "smoke_config"):
            got = getattr(get_arch(arch), preset)()
            want = getattr(j_get_arch(arch), preset)()
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.param_count() == want.param_count()
    assert get_arch("olmo-1b").config().param_count() == 1_176_764_416
    for arch in ("olmoe-1b-7b", "llama4-scout-17b-a16e", "meshgraphnet",
                 "dlrm-mlperf", "din", "deepfm", "bert4rec"):
        with pytest.raises(NotImplementedError, match=re.escape(
                missing_module(arch))):
            get_arch(arch)
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("gpt-5")


def test_init_matches_reference_layout():
    """init_params: the reference's names and shapes, layers unstacked,
    and its parameter count."""
    import jax
    _, jcfg, params, ref_model = _reference("qwen3-14b")
    model = t_tf.init_params(torch.Generator().manual_seed(0),
                             get_arch("qwen3-14b").smoke_config(),
                             device="cpu")
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == {n: tuple(p.shape)
                   for n, p in ref_model.named_parameters()}
    assert model.n_params() == sum(x.size for x in
                                   jax.tree_util.tree_leaves(params))
    with pytest.raises(NotImplementedError, match="moe.py"):
        t_tf.init_params(torch.Generator(), dataclasses.replace(
            model.cfg, moe=object()), device="cpu")


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _shape(line: str) -> str:
    return re.sub(r"-?\d+\.\d+", "X", line)


def _port_lines(capsys, *argv) -> list[str]:
    t_launch.main(["--device", "cpu", *argv])
    return capsys.readouterr().out.splitlines()


def test_launcher_lines_match_reference(capsys, monkeypatch):
    """The same flags print the same lines as the JAX launcher, numbers
    aside (the two draw different initial weights and batches)."""
    from repro.launch import train as j_launch
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "olmo-1b",
                                      "--steps", "4", "--batch", "2"])
    j_launch.main()
    want = capsys.readouterr().out.splitlines()
    got = _port_lines(capsys, "--arch", "olmo-1b", "--steps", "4",
                      "--batch", "2", "--grad-compression")
    assert [_shape(x) for x in got] == [_shape(x) for x in want]
    assert got[-1].startswith("[train] done: loss")
    assert len(got) == 5


def test_launcher_resume_equals_uninterrupted(capsys, tmp_path):
    """--steps 10 saves at step 4 and at step 9; with step 9's checkpoint
    removed, a rerun resumes at step 4 and prints steps 5-9 as the
    uninterrupted run did, to the digit (its done line starts from step
    5's loss); the metrics file holds the history."""
    d = tmp_path / "ckpt"
    argv = ("--arch", "stablelm-3b", "--steps", "10", "--batch", "2",
            "--seq", "16", "--ckpt-dir", str(d))
    full = _port_lines(capsys, *argv)
    assert sorted(p.name for p in d.iterdir()) == ["step_0000000004",
                                                   "step_0000000009"]
    shutil.rmtree(d / "step_0000000009")
    metrics = tmp_path / "m.json"
    again = _port_lines(capsys, *argv, "--metrics-json", str(metrics))
    assert again[0] == "[fit] resumed from step 4"
    assert again[1:-1] == full[5:-1]
    import json
    m = json.loads(metrics.read_text())
    assert [h["step"] for h in m["history"]] == [5, 6, 7, 8, 9]
    assert m["param_count"] == get_arch("stablelm-3b").smoke_config(
        ).param_count() and m["tokens_per_step"] == 32


def test_launcher_refusals(capsys, monkeypatch):
    """asc-splade and the unported families exit 2, as the reference's
    retrieval kind does; --devices and a missing card exit with an
    error."""
    for arch, what in (("asc-splade", "has no train step"),
                       ("olmoe-1b-7b", "repro_torch/models/moe.py"),
                       ("meshgraphnet", "repro_torch/models/gnn.py"),
                       ("dlrm-mlperf", "repro_torch/models/recsys.py")):
        with pytest.raises(SystemExit) as e:
            t_launch.main(["--arch", arch, "--device", "cpu"])
        assert e.value.code == 2
        assert what in capsys.readouterr().err
    with pytest.raises(SystemExit, match="sharding.py"):
        t_launch.main(["--devices", "4", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        t_launch.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_tf.init_params(torch.Generator(),
                         get_arch("olmo-1b").smoke_config())


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_full_width_step_on_card_equals_cpu(monkeypatch):
    """olmo-1b's full widths at depth 2 (fp32 compute, TF32 off): one
    AdamW step at lr 3e-4 on the card against the CPU. Loss rtol 1e-5,
    grad norm rtol 1e-4; the first moment (0.1 x the clipped gradient)
    per tensor to rtol 1e-3, atol 1e-4 x its largest entry; parameters
    to atol 2 x lr (a first AdamW step moves each weight by about
    lr x sign(g), which rounding can tip where g is near zero)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(get_arch("olmo-1b").config(), n_layers=2,
                              dtype="float32")
    lr = 3e-4
    on_cpu = t_tf.init_params(torch.Generator().manual_seed(5), cfg,
                              device="cpu")
    import copy
    on_card = copy.deepcopy(on_cpu).to("cuda")
    from repro_torch.data.pipeline import LMDataSpec, lm_batch
    b = {k: v[:, :64] for k, v in lm_batch(LMDataSpec(cfg.vocab, 65, 2),
                                           0).items()}
    out = {}
    for name, model in (("cpu", on_cpu), ("card", on_card)):
        adam = t_opt.adamw(t_opt.constant_schedule(lr))
        step = make_train_step(t_tf.loss_fn, adam, TrainConfig())
        state = adam.init(module_tree(model))
        model, state, m = step(model, state, b, 0)
        out[name] = (m, state, model)
    (mc, sc, pc), (mg, sg, pg) = out["cpu"], out["card"]
    np.testing.assert_allclose(float(mg["loss"]), float(mc["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(mg["grad_norm"]),
                               float(mc["grad_norm"]), rtol=1e-4)
    for a, c in zip(leaves(sg["mu"]), leaves(sc["mu"])):
        np.testing.assert_allclose(a.cpu().numpy(), c.numpy(), rtol=1e-3,
                                   atol=1e-4 * float(c.abs().max()))
    for a, c in zip(pg.parameters(), pc.parameters()):
        np.testing.assert_allclose(a.detach().cpu().numpy(),
                                   c.detach().numpy(), rtol=0,
                                   atol=2 * lr)
