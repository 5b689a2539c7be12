"""The port's training stack (``repro_torch.training``: optimizers,
checkpoints, gradient compression, the train step and ``fit``; and
``data/pipeline.py``'s LM batches) held against the JAX package on the
CPU. Each test of tests/test_training.py has a paired counterpart here
that feeds both packages the same numpy inputs and asserts the
reference's own property on the port as well, plus:

  * a checkpoint directory written by the reference's ``fit`` resumed by
    the port's ``fit``, and the reverse, each equal to the reference's
    uninterrupted run (on the qwen3-14b smoke LM, whose stacked layers
    and nested qk-norm exercise the leaf order);
  * ``compressed_mean`` over 2 gloo ranks against the reference's under
    ``jax.vmap(axis_name=...)``.

Tolerances: schedules, clipping and int8 quantization are the same
float32 operations on both sides and agree to rtol 1e-6 (the int8
payloads exactly); optimizer trajectories on the least-squares toy to
rtol 1e-5, atol 1e-6 over 30 steps; LM parameters after AdamW steps to
atol 1e-4 (see tests/test_torch_transformer.py: a first step moves a
weight by about lr x sign(g), which rounding can tip where g is near
zero). A port run resumed from a port checkpoint equals its
uninterrupted run bit for bit (same device, same arithmetic).
"""

from __future__ import annotations

import os
import time

import numpy as np
import pytest
import torch
from torch import nn

from repro_torch.convert import lm_params_from_arrays, to_arrays
from repro_torch.data.pipeline import LMDataSpec, lm_batch
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.training import optimizer as t_opt
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.compression import (compressed_mean,
                                              dequantize_int8, quantize_int8)
from repro_torch.training.train_loop import TrainConfig, fit, make_train_step
from repro_torch.training.tree import leaves, module_tree

RANK_TIMEOUT_S = 120.0


def _toy_arrays():
    """Least squares with a known optimum, drawn with numpy."""
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=(8, 4)).astype(np.float32)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    return {"x": x, "y": x @ w_true}


def _port_toy():
    model = nn.ParameterDict({"w": nn.Parameter(torch.zeros(8, 4)),
                              "b": nn.Parameter(torch.zeros(4))})

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"] + params["b"]
        return torch.mean((pred - batch["y"]) ** 2)
    return loss_fn, model


def _ref_toy():
    import jax.numpy as jnp

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"] + params["b"]
        return jnp.mean((pred - batch["y"]) ** 2)
    return loss_fn, {"w": jnp.zeros((8, 4)), "b": jnp.zeros((4,))}


def _t(tree: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _j(tree: dict) -> dict:
    import jax.numpy as jnp
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _opts(name: str, lib):
    return {
        "adamw": lambda: lib.adamw(lib.constant_schedule(0.05)),
        "sgd": lambda: lib.sgd(lib.constant_schedule(0.05), momentum=0.9),
        "sgd_plain": lambda: lib.sgd(lib.constant_schedule(0.05)),
        "rowwise_adagrad": lambda: lib.rowwise_adagrad(
            lib.constant_schedule(0.5)),
        "mixed": lambda: lib.mixed([("w", lib.rowwise_adagrad(
            lib.constant_schedule(0.5)))],
            lib.adamw(lib.constant_schedule(0.05))),
    }[name]()


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["adamw", "sgd", "sgd_plain",
                                  "rowwise_adagrad", "mixed"])
def test_optimizer_descends_as_reference(name):
    """30 steps on the toy: each step's loss and the final parameters
    equal the reference's; the loss falls below a fifth of its start
    (the reference test's three optimizers) or at least falls (plain SGD
    and the mixed routing, which it does not test)."""
    import jax
    import jax.numpy as jnp

    from repro.training import optimizer as j_opt
    from repro.training.train_loop import TrainConfig as JTrainConfig
    from repro.training.train_loop import make_train_step as j_make
    batch = _toy_arrays()
    j_loss, j_params = _ref_toy()
    j_o = _opts(name, j_opt)
    j_step = jax.jit(j_make(j_loss, j_o, JTrainConfig()))
    j_state = j_o.init(j_params)
    t_loss, model = _port_toy()
    t_o = _opts(name, t_opt)
    t_step = make_train_step(t_loss, t_o, TrainConfig())
    t_state = t_o.init(module_tree(model))
    losses = []
    for i in range(30):
        j_params, j_state, jm = j_step(j_params, j_state, _j(batch),
                                       jnp.int32(i))
        model, t_state, tm = t_step(model, t_state, _t(batch), i)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, atol=1e-6, err_msg=f"step {i}")
        losses.append(float(tm["loss"]))
    drop = 0.2 if name in ("adamw", "sgd", "rowwise_adagrad") else 1.0
    assert losses[-1] < drop * losses[0]
    for k in ("w", "b"):
        np.testing.assert_allclose(model[k].detach().numpy(),
                                   np.asarray(j_params[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_cosine_schedule():
    from repro.training import optimizer as j_opt
    want = j_opt.cosine_schedule(1.0, warmup=10, total=100)
    sched = t_opt.cosine_schedule(1.0, warmup=10, total=100)
    vals = [float(sched(i)) for i in range(121)]
    np.testing.assert_allclose(vals, [float(want(np.int32(i)))
                                      for i in range(121)], rtol=1e-6,
                               atol=1e-7)
    assert vals[0] == pytest.approx(0.0, abs=1e-6)
    assert vals[10] == pytest.approx(1.0, rel=1e-3)
    assert vals[100] == pytest.approx(0.1, rel=1e-2)  # final_frac floor
    assert all(b >= a for a, b in zip(vals[:11], vals[1:11]))
    assert float(t_opt.constant_schedule(0.3)(7)) == np.float32(0.3)
    assert sched(3).dtype == torch.float32


def test_clip_by_global_norm():
    from repro.training import optimizer as j_opt
    g = {"a": np.full((4,), 10.0, np.float32),
         "b": np.full((3,), -10.0, np.float32)}
    clipped, norm = t_opt.clip_by_global_norm(_t(g), 1.0)
    j_clipped, j_norm = j_opt.clip_by_global_norm(_j(g), 1.0)
    assert float(t_opt.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    assert float(norm) == pytest.approx(np.sqrt(700.0), rel=1e-5)
    np.testing.assert_allclose(float(norm), float(j_norm), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(clipped[k].numpy(),
                                   np.asarray(j_clipped[k]), rtol=1e-6)
    # under the limit: untouched
    g2 = {"a": torch.full((4,), 1e-3)}
    same, _ = t_opt.clip_by_global_norm(g2, 1.0)
    assert torch.equal(same["a"], g2["a"])


def test_apply_updates_and_state_keys():
    """apply_updates adds in the parameter's dtype; the states carry the
    reference's keys and float32 moments."""
    p = {"a": torch.ones(3, dtype=torch.bfloat16), "b": [torch.zeros(2)]}
    u = {"a": torch.full((3,), 0.5), "b": [torch.ones(2)]}
    out = t_opt.apply_updates(p, u)
    assert out["a"].dtype == torch.bfloat16 and float(out["a"][0]) == 1.5
    assert torch.equal(out["b"][0], torch.ones(2))
    sched = t_opt.constant_schedule(0.1)
    assert set(t_opt.adamw(sched).init(p)) == {"mu", "nu"}
    assert t_opt.adamw(sched).init(p)["mu"]["a"].dtype == torch.float32
    assert set(t_opt.rowwise_adagrad(sched).init(p)) == {"acc"}
    assert set(t_opt.sgd(sched, momentum=0.9).init(p)) == {"mom"}
    assert t_opt.sgd(sched).init(p) == {}


def test_microbatch_accumulation_matches_full_batch():
    """4 microbatches equal the full batch (the reference's own check), and
    equal the reference's 4-microbatch step."""
    import jax.numpy as jnp

    from repro.training import optimizer as j_opt
    from repro.training.train_loop import TrainConfig as JTrainConfig
    from repro.training.train_loop import make_train_step as j_make
    batch = _toy_arrays()
    batch["w0"] = np.random.default_rng(3).normal(size=(8, 4)).astype(
        np.float32)
    out = {}
    for n in (1, 4):
        loss_fn, model = _port_toy()
        with torch.no_grad():
            model["w"].copy_(torch.from_numpy(batch["w0"]))
        o = t_opt.sgd(t_opt.constant_schedule(0.1))
        step = make_train_step(loss_fn, o, TrainConfig(microbatches=n))
        model, _, m = step(model, o.init(module_tree(model)),
                           _t({"x": batch["x"], "y": batch["y"]}), 0)
        out[n] = (float(m["loss"]), model["w"].detach().numpy().copy(),
                  model["b"].detach().numpy().copy())
    assert out[1][0] == pytest.approx(out[4][0], rel=1e-5)
    for a, b in zip(out[1][1:], out[4][1:]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    j_loss, _ = _ref_toy()
    j_params = {"w": jnp.asarray(batch["w0"]), "b": jnp.zeros((4,))}
    o = j_opt.sgd(j_opt.constant_schedule(0.1))
    p, _, m = j_make(j_loss, o, JTrainConfig(microbatches=4))(
        j_params, o.init(j_params), _j({"x": batch["x"], "y": batch["y"]}),
        jnp.int32(0))
    assert out[4][0] == pytest.approx(float(m["loss"]), rel=1e-6)
    np.testing.assert_allclose(out[4][1], np.asarray(p["w"]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(out[4][2], np.asarray(p["b"]), rtol=1e-6,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def test_int8_compression_roundtrip():
    """The same payload and scale as the reference (round half to even:
    values sitting on .5 steps included), and the reference's error
    bound."""
    import jax.numpy as jnp

    from repro.training import compression as j_comp
    g = (np.random.default_rng(0).normal(size=256) * 0.01).astype(np.float32)
    g[:5] = [0.5, 1.5, 2.5, -0.5, -2.5]        # halves after scaling
    g[5] = 127.0
    q, scale = quantize_int8(torch.from_numpy(g))
    jq, jscale = j_comp.quantize_int8(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)
    back = dequantize_int8(q, scale)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        j_comp.dequantize_int8(jq, jscale)))
    assert float((back - torch.from_numpy(g)).abs().max()) <= \
        float(scale) * 0.51 + 1e-9


def test_compression_error_feedback_converges():
    """Error feedback delivers the true mean of a constant gradient over 50
    rounds, each round's payload as the reference's."""
    import jax.numpy as jnp

    from repro.training import compression as j_comp
    g = torch.tensor([1e-4, 5e-3, -2e-3, 0.1])
    ef, acc = torch.zeros_like(g), torch.zeros_like(g)
    jg = jnp.asarray(g.numpy())
    jef = jnp.zeros_like(jg)
    for _ in range(50):
        q, scale = quantize_int8(g + ef)
        jq, jscale = j_comp.quantize_int8(jg + jef)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        sent = dequantize_int8(q, scale)
        ef = (g + ef) - sent
        jef = (jg + jef) - j_comp.dequantize_int8(jq, jscale)
        acc = acc + sent
    np.testing.assert_allclose((acc / 50).numpy(), g.numpy(), rtol=0.05,
                               atol=1e-5)
    np.testing.assert_allclose(ef.numpy(), np.asarray(jef), rtol=1e-6,
                               atol=1e-9)


def _grads_of_rank(rank: int, rnd: int) -> dict:
    rng = np.random.default_rng((rank, rnd))
    return {"a": (rng.normal(size=(5, 3)) * 10 ** -rank).astype(np.float32),
            "b": [rng.normal(size=7).astype(np.float32)]}


def _rank_compressed_mean(rank: int, rounds: int) -> list:
    ef, out = None, []
    for rnd in range(rounds):
        g = {"a": torch.from_numpy(_grads_of_rank(rank, rnd)["a"]),
             "b": [torch.from_numpy(_grads_of_rank(rank, rnd)["b"][0])]}
        mean, ef = compressed_mean(g, ef)
        out.append((to_arrays(mean), to_arrays(ef)))
    return out


def test_compressed_mean_on_two_ranks_matches_reference():
    """Three rounds on 2 gloo ranks (error feedback carried), each rank's
    mean and residual against the reference's ``compressed_mean`` under
    ``jax.vmap(axis_name="pod")`` on the same grads: the int8 payloads
    are the same, so the means agree to rtol 1e-6."""
    import jax
    import jax.numpy as jnp

    from repro.training.compression import compressed_mean as j_cm
    got = spawn_ranks(_rank_compressed_mean, 2, (3,),
                      timeout_s=RANK_TIMEOUT_S)
    f = jax.vmap(lambda g, ef: j_cm(g, ef, "pod"), axis_name="pod")
    ef = None
    for rnd in range(3):
        per = [_grads_of_rank(r, rnd) for r in range(2)]
        g = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *per)
        if ef is None:
            ef = jax.tree_util.tree_map(jnp.zeros_like, g)
        mean, ef = f(g, ef)
        for r in range(2):
            for what, want in (("mean", mean), ("ef", ef)):
                got_flat = leaves(got[r][rnd][0 if what == "mean" else 1])
                want_flat = [np.asarray(x[r])
                             for x in jax.tree_util.tree_leaves(want)]
                for a, b in zip(got_flat, want_flat, strict=True):
                    np.testing.assert_allclose(
                        a, b, rtol=1e-6, atol=1e-9,
                        err_msg=f"round {rnd} rank {r} {what}")
    # both ranks hold the same mean
    for rnd in range(3):
        for a, b in zip(leaves(got[0][rnd][0]), leaves(got[1][rnd][0])):
            np.testing.assert_array_equal(a, b)


def test_train_step_compresses_over_a_group_only_when_asked():
    """``grad_compression`` without a group changes nothing (the
    reference's ``fit`` passes none); with the default group of one rank
    the step returns the error-feedback state."""
    import torch.distributed as dist
    loss_fn, model = _port_toy()
    o = t_opt.sgd(t_opt.constant_schedule(0.1))
    cfg = TrainConfig(grad_compression=True)
    out = make_train_step(loss_fn, o, cfg)(model, {}, _t(_toy_arrays()), 0)
    assert len(out) == 3
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method="file://" + os.path.join(
            tmp, "rdv"), world_size=1, rank=0)
        try:
            out = make_train_step(loss_fn, o, cfg,
                                  compression_group=dist.group.WORLD)(
                model, {}, _t(_toy_arrays()), 0)
        finally:
            dist.destroy_process_group()
    assert len(out) == 4 and set(out[3]) == {"w", "b"}


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------

def _ckpt_tree():
    return {"step": 7, "params": {"w": torch.arange(6.0).reshape(2, 3)},
            "nested": [torch.ones(3), torch.zeros(2, dtype=torch.int32)]}


def test_checkpoint_roundtrip_and_format(tmp_path):
    """Save then restore_into gives the same leaves; the files hold the
    leaves in the reference's order, so the reference's manager restores
    the port's directory and the port restores the reference's."""
    import jax
    import jax.numpy as jnp

    from repro.training.checkpoint import CheckpointManager as JManager
    tree = _ckpt_tree()
    mgr = CheckpointManager(str(tmp_path / "port"), max_to_keep=2)
    mgr.save(7, tree)
    out = mgr.restore_into(7, tree)
    for a, b in zip(leaves(to_arrays(tree)), leaves(out), strict=True):
        np.testing.assert_array_equal(a, b)
    assert np.asarray(mgr.restore(7)["step"]) == 7
    j_tree = {"step": 7, "params": {"w": jnp.arange(6.0).reshape(2, 3)},
              "nested": [jnp.ones((3,)), jnp.zeros((2,), jnp.int32)]}
    j_out = JManager(str(tmp_path / "port")).restore_into(7, j_tree)
    for a, b in zip(jax.tree_util.tree_leaves(j_tree),
                    jax.tree_util.tree_leaves(j_out), strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    JManager(str(tmp_path / "ref")).save(7, j_tree)
    back = CheckpointManager(str(tmp_path / "ref")).restore_into(7, tree)
    for a, b in zip(leaves(to_arrays(tree)), leaves(back), strict=True):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_rotation(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    t = {"x": torch.zeros(2)}
    for s in (1, 2, 3, 4):
        mgr.save(s, t)
    assert mgr.steps() == [3, 4]


def test_checkpoint_async_and_atomic(tmp_path):
    """An async save copies the tensors before it returns (a later in-place
    update does not reach the file) and leaves no tmp litter."""
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
    t = {"x": torch.arange(4.0)}
    mgr.save(1, t, async_save=True)
    t["x"].add_(100.0)
    mgr.wait()
    assert mgr.steps() == [1]
    litter = [n for n in os.listdir(tmp_path) if n.startswith("tmp.")]
    assert not litter
    np.testing.assert_array_equal(mgr.restore(1)["x"], np.arange(4.0))


def test_checkpoint_restore_latest_template(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"step": 3, "params": {"w": torch.full((2, 2), 3.0)}})
    mgr2 = CheckpointManager(str(tmp_path))     # fresh manager (restart)
    out = mgr2.restore_latest({"step": 0,
                               "params": {"w": torch.zeros(2, 2)}})
    assert int(out["step"]) == 3
    np.testing.assert_allclose(out["params"]["w"], 3.0)
    free = mgr2.restore_latest()
    assert free["step"] == 3 and len(free["_flat"]) == 2
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest() is None


def test_elastic_cast_like(tmp_path):
    """Restore onto live tensors: the live device and dtype win; a module
    is overwritten in place, its per-layer list from the stacked arrays;
    the structure-free form unflattens against the live tree."""
    mgr = CheckpointManager(str(tmp_path))
    tree = {"w": torch.arange(8.0).reshape(2, 4)}
    mgr.save(5, tree)
    live = {"w": torch.zeros((2, 4), dtype=torch.float64)}
    out = CheckpointManager.cast_like(mgr.restore_into(5, tree), live)
    assert out["w"].dtype == torch.float64
    np.testing.assert_array_equal(out["w"].numpy(), tree["w"].numpy())
    out = CheckpointManager.cast_like(mgr.restore_latest(), live)
    np.testing.assert_array_equal(out["w"].numpy(), tree["w"].numpy())
    layers = nn.ModuleList(nn.ParameterDict({"a": nn.Parameter(
        torch.full((3,), float(i)))}) for i in range(4))
    mgr.save(6, {"m": layers, "opt": [{"a": torch.full((3,), 9.0 + i)}
                                      for i in range(4)]})
    saved = mgr.restore(6)
    assert saved["m"]["a"].shape == (4, 3)      # stacked as the reference
    fresh = nn.ModuleList(nn.ParameterDict({"a": nn.Parameter(
        torch.zeros(3))}) for _ in range(4))
    got = CheckpointManager.cast_like(saved, {
        "m": fresh, "opt": [{"a": torch.zeros(3)} for _ in range(4)]})
    assert got["m"] is fresh
    assert [x["a"][0].item() for x in fresh] == [0.0, 1.0, 2.0, 3.0]
    assert [float(x["a"][0]) for x in got["opt"]] == [9.0, 10.0, 11.0, 12.0]


# ---------------------------------------------------------------------------
# fit(): resume-from-checkpoint + deterministic data replay
# ---------------------------------------------------------------------------

def _fit_data(step: int) -> dict:
    rng = np.random.default_rng((42, step))
    x = rng.normal(size=(16, 8)).astype(np.float32)
    return {"x": x, "y": x @ np.ones((8, 4), np.float32)}


def test_fit_resume_reproduces_uninterrupted_run(tmp_path):
    """A 6-step run then a resumed run to 12 equals an uninterrupted
    12-step run bit for bit, and both equal the reference's 12-step run."""
    from repro.training import optimizer as j_opt
    from repro.training.train_loop import TrainConfig as JTrainConfig
    from repro.training.train_loop import fit as j_fit
    mk = lambda: t_opt.adamw(t_opt.constant_schedule(0.05))   # noqa: E731
    data = lambda s: _t(_fit_data(s))                          # noqa: E731
    loss_fn, model = _port_toy()
    p_full, _ = fit(params=model, optimizer=mk(), loss_fn=loss_fn,
                    data_fn=data, cfg=TrainConfig(steps=12, log_every=50,
                                                  checkpoint_every=100),
                    log_fn=lambda s: None)
    d = str(tmp_path / "ckpt")
    lines = []
    _, model = _port_toy()
    fit(params=model, optimizer=mk(), loss_fn=loss_fn, data_fn=data,
        cfg=TrainConfig(steps=6, log_every=50, checkpoint_every=6),
        ckpt_dir=d, log_fn=lines.append)
    _, model = _port_toy()
    p_b, hist = fit(params=model, optimizer=mk(), loss_fn=loss_fn,
                    data_fn=data, cfg=TrainConfig(steps=12, log_every=50,
                                                  checkpoint_every=100),
                    ckpt_dir=d, log_fn=lines.append)
    assert lines[0].startswith("[fit] step 0: loss=")
    assert "[fit] resumed from step 5" in lines
    assert [h["step"] for h in hist] == [11]
    assert set(hist[0]) == {"loss", "grad_norm", "step", "elapsed_s"}
    for k in ("w", "b"):
        assert torch.equal(p_full[k], p_b[k])
    j_loss, j_params = _ref_toy()
    j_p, _ = j_fit(params=j_params,
                   optimizer=j_opt.adamw(j_opt.constant_schedule(0.05)),
                   loss_fn=j_loss, data_fn=lambda s: _j(_fit_data(s)),
                   cfg=JTrainConfig(steps=12, log_every=50,
                                    checkpoint_every=100),
                   log_fn=lambda s: None)
    for k in ("w", "b"):
        np.testing.assert_allclose(p_b[k].detach().numpy(),
                                   np.asarray(j_p[k]), rtol=1e-5, atol=1e-6)


def _lm_setup():
    """The reference's qwen3-14b smoke LM, its initial parameters as numpy,
    and batches 0..5 (B 2, S 16) as numpy."""
    import jax

    from repro.configs import get_arch as j_get_arch
    from repro.data import pipeline as j_pl
    from repro.models import transformer as j_tf
    jcfg = j_get_arch("qwen3-14b").smoke_config()
    tree = jax.tree_util.tree_map(np.asarray, j_tf.init_params(
        jax.random.PRNGKey(0), jcfg))
    batches = []
    for s in range(6):
        b = j_pl.lm_batch(j_pl.LMDataSpec(jcfg.vocab, 17, 2), s)
        batches.append({k: np.array(v[:, :16]) for k, v in b.items()})
    return j_tf, jcfg, tree, batches


def _port_lm_fit(tree, batches, steps, ckpt_dir):
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as t_tf
    cfg = get_arch("qwen3-14b").smoke_config()
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


def _ref_lm_fit(j_tf, jcfg, tree, batches, steps, ckpt_dir):
    import jax
    import jax.numpy as jnp

    from repro.training import optimizer as j_opt
    from repro.training.train_loop import TrainConfig as JTrainConfig
    from repro.training.train_loop import fit as j_fit
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    p, _ = j_fit(params=params, optimizer=j_opt.adamw(
        j_opt.cosine_schedule(1e-3, warmup=2, total=6)),
        loss_fn=lambda p, b: j_tf.loss_fn(p, b, jcfg),
        data_fn=lambda s: {k: jnp.asarray(v) for k, v in batches[s].items()},
        cfg=JTrainConfig(steps=steps, log_every=50, checkpoint_every=3),
        ckpt_dir=ckpt_dir, log_fn=lambda s: None)
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(p)]


def test_checkpoints_cross_between_packages(tmp_path):
    """The reference's fit stops at step 2 and the port's fit resumes its
    directory to step 5; the port's fit stops at step 2 and the
    reference's resumes. Both equal the reference's uninterrupted 6-step
    run (atol 1e-4, as the AdamW steps of test_torch_transformer.py), and
    the port's uninterrupted run equals its own resumed one bit for
    bit."""
    j_tf, jcfg, tree, batches = _lm_setup()
    want = _ref_lm_fit(j_tf, jcfg, tree, batches, 6, None)
    port_full = _port_lm_fit(tree, batches, 6, None)
    ref_then_port = str(tmp_path / "a")
    _ref_lm_fit(j_tf, jcfg, tree, batches, 3, ref_then_port)
    got_a = _port_lm_fit(tree, batches, 6, ref_then_port)
    port_then_ref = str(tmp_path / "b")
    _port_lm_fit(tree, batches, 3, port_then_ref)
    got_b = _ref_lm_fit(j_tf, jcfg, tree, batches, 6, port_then_ref)
    port_again = str(tmp_path / "c")
    _port_lm_fit(tree, batches, 3, port_again)
    got_c = _port_lm_fit(tree, batches, 6, port_again)
    assert len(want) == len(got_a) == len(got_b) == len(port_full) > 10
    for i, (w, a, b, f, c) in enumerate(zip(want, got_a, got_b, port_full,
                                            got_c)):
        for what, x in (("ref -> port", a), ("port -> ref", b),
                        ("port uninterrupted", f)):
            np.testing.assert_allclose(x, w, rtol=1e-5, atol=1e-4,
                                       err_msg=f"{what}, leaf {i}")
        np.testing.assert_array_equal(c, f, err_msg=f"port resume, leaf {i}")
    assert CheckpointManager(port_then_ref).steps() == [2, 5]


def test_data_pipeline_deterministic():
    """lm_batch is a function of (spec, step): the reference's shapes,
    tokens in range, and the reference's rule: a label follows
    ``(token * 31 + 7) % V`` on about a quarter of the positions (the rule
    picks half, and reads the stream's base token, which the position
    itself kept in half of them)."""
    from repro.data.pipeline import LMDataSpec as JSpec
    from repro.data.pipeline import lm_batch as j_lm_batch
    spec = LMDataSpec(vocab=100, seq_len=16, batch=4)
    a, b, c = lm_batch(spec, 3), lm_batch(spec, 3), lm_batch(spec, 4)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    want = j_lm_batch(JSpec(vocab=100, seq_len=16, batch=4), 3)
    for k in ("tokens", "labels", "mask"):
        assert tuple(a[k].shape) == want[k].shape
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    big = lm_batch(LMDataSpec(vocab=1000, seq_len=512, batch=8), 0)
    rule = (big["tokens"] * 31 + 7) % 1000 == big["labels"]
    assert 0.22 < float(rule.float().mean()) < 0.28
    assert int(big["tokens"].min()) >= 0 and int(big["tokens"].max()) < 1000
    assert not torch.equal(lm_batch(LMDataSpec(100, 16, 4, seed=1), 3)[
        "tokens"], a["tokens"])


def test_fit_saves_async_during_the_run(tmp_path):
    """checkpoint_every 4 over 10 steps: saves at steps 3 and 7 (async)
    and 9 (final), rotation keeps the last three; the history keys are
    the reference's."""
    loss_fn, model = _port_toy()
    t0 = time.perf_counter()
    _, hist = fit(params=model, optimizer=t_opt.sgd(
        t_opt.constant_schedule(0.01)), loss_fn=loss_fn,
        data_fn=lambda s: _t(_fit_data(s)),
        cfg=TrainConfig(steps=10, log_every=3, checkpoint_every=4),
        ckpt_dir=str(tmp_path), log_fn=lambda s: None)
    assert CheckpointManager(str(tmp_path)).steps() == [3, 7, 9]
    assert [h["step"] for h in hist] == [0, 3, 6, 9]
    assert all(0 <= h["elapsed_s"] <= time.perf_counter() - t0
               for h in hist)
