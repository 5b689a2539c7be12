"""The port's recsys family (``repro_torch.models.recsys`` and
``models/embedding.py``), its configs, batches and the training
launcher's recsys branch, held against the JAX package on the CPU.

Every recsys test of tests/test_arch_smoke.py has its pair here, on the
reference's smoke configs with the reference's initial parameters carried
across by ``convert.recsys_params_from_arrays`` and the reference's
batches fed to both. Tolerances: forward outputs and losses rtol 1e-5,
atol 1e-6; gradients rtol 1e-4, atol 1e-6 (sums in another order); the
losses of 5 AdamW steps at lr 1e-2 rtol 1e-4 (a step can tip a weight
whose gradient is near zero by lr, which moves the next losses in their
fifth digit). The ``gpu`` test runs each arch on the card against the
CPU. This file collects without JAX: the reference is imported inside
the tests that use it.
"""

from __future__ import annotations

import dataclasses
import re
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.convert import recsys_params_from_arrays, to_arrays
from repro_torch.data import pipeline as t_pl
from repro_torch.launch import train as t_launch
from repro_torch.models import embedding as t_emb
from repro_torch.models import recsys as t_rs
from repro_torch.training import optimizer as t_opt
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.train_loop import TrainConfig, fit, make_train_step
from repro_torch.training.tree import leaves, module_tree, tree_map

ARCHS = ["dlrm-mlperf", "din", "deepfm", "bert4rec"]
TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
BATCH_FNS = {"dlrm-mlperf": "dlrm_batch", "din": "din_batch",
             "deepfm": "deepfm_batch", "bert4rec": "bert4rec_batch"}
REF_FNS = {"dlrm-mlperf": "dlrm", "din": "din", "deepfm": "deepfm",
           "bert4rec": "bert4rec"}


def _ref_fns(arch: str):
    """The reference's (init, forward, loss, retrieval) of ``arch``."""
    from repro.models import recsys as j_rs
    p = REF_FNS[arch]
    fwd = "bert4rec_encode" if arch == "bert4rec" else f"{p}_forward"
    return (getattr(j_rs, f"{p}_init"), getattr(j_rs, fwd),
            getattr(j_rs, f"{p}_loss"), getattr(j_rs, f"{p}_retrieval"))


def _reference(arch: str):
    """(reference config, its initial parameters, the port's model
    carried across from them)."""
    import jax

    from repro.configs import get_arch as j_get_arch
    jcfg = j_get_arch(arch).smoke_config()
    params = _ref_fns(arch)[0](jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = recsys_params_from_arrays(tree, arch,
                                      get_arch(arch).smoke_config(),
                                      device="cpu")
    return jcfg, params, model


def _batch(arch: str, cfg, B: int, step: int) -> dict:
    """The reference's batch as numpy."""
    from repro.data import pipeline as j_pl
    return {k: np.asarray(v)
            for k, v in getattr(j_pl, BATCH_FNS[arch])(cfg, B, step).items()}


def _jax(b: dict) -> dict:
    import jax.numpy as jnp
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)).long()
            if np.issubdtype(v.dtype, np.integer)
            else torch.from_numpy(np.array(v)) for k, v in b.items()}


def _grads(model) -> list[np.ndarray]:
    return leaves(to_arrays(tree_map(lambda p: p.grad, module_tree(model))))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_reference(arch):
    """The smoke tests of each arch (dlrm/din/deepfm/bert4rec_smoke):
    forward (BERT4Rec: the encoder's hidden states), loss and every
    gradient on the reference's weights and batch 0 of 8."""
    import jax
    jcfg, params, model = _reference(arch)
    _, j_fwd, j_loss, _ = _ref_fns(arch)
    _, t_fwd, t_loss, _ = t_rs.RECSYS[arch]
    b = _batch(arch, jcfg, 8, 0)
    want_out = jax.jit(lambda p: j_fwd(p, _jax(b), jcfg))(params)
    want_loss, want_g = jax.jit(jax.value_and_grad(
        lambda p: j_loss(p, _jax(b), jcfg)))(params)
    with torch.no_grad():
        out = t_fwd(model, _torch(b))
    assert out.shape == want_out.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
    loss = t_loss(model, _torch(b))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    got_g = _grads(model)
    want_flat = jax.tree_util.tree_leaves(want_g)
    assert len(got_g) == len(want_flat)
    for i, (g, w) in enumerate(zip(got_g, want_flat)):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL,
                                   err_msg=f"gradient leaf {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_recsys_training_descends(arch):
    """5 AdamW steps at lr 1e-2 on the reference's batch of 16 (its
    test_recsys_training_descends): each step's loss and grad norm against
    the reference's, and the loss falls."""
    import jax
    import jax.numpy as jnp

    from repro.training import optimizer as j_opt
    from repro.training.train_loop import TrainConfig as JTrainConfig
    from repro.training.train_loop import make_train_step as j_make
    jcfg, params, model = _reference(arch)
    _, _, j_loss, _ = _ref_fns(arch)
    b = _batch(arch, jcfg, 16, 0)
    j_adam = j_opt.adamw(j_opt.constant_schedule(1e-2))
    j_step = jax.jit(j_make(lambda p, bb: j_loss(p, bb, jcfg), j_adam,
                            JTrainConfig()))
    t_adam = t_opt.adamw(t_opt.constant_schedule(1e-2))
    t_step = make_train_step(t_rs.RECSYS[arch][2], t_adam, TrainConfig())
    j_state, t_state = j_adam.init(params), t_adam.init(module_tree(model))
    losses = []
    for i in range(5):
        params, j_state, jm = j_step(params, j_state, _jax(b), jnp.int32(i))
        model, t_state, tm = t_step(model, t_state, _torch(b), i)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {i} {k}")
        losses.append(float(tm["loss"]))
    assert losses[-1] < losses[0]


def _retrieval_batch(arch: str, cfg) -> dict:
    """One user and a block of 256 candidates, as numpy."""
    rng = np.random.default_rng(3)
    C = 256
    if arch == "dlrm-mlperf":
        return {"dense": rng.standard_normal((1, cfg.n_dense), np.float32),
                "sparse": rng.integers(0, cfg.vocab_per_table,
                                       (1, cfg.n_sparse)),
                "cand_ids": np.arange(C)}
    if arch == "din":
        L = cfg.seq_len
        return {"hist_items": rng.integers(0, cfg.n_items, (1, L)),
                "hist_cates": rng.integers(0, cfg.n_cates, (1, L)),
                "hist_mask": np.arange(L)[None, :] < 13,
                "cand_items": np.arange(C),
                "cand_cates": np.arange(C) % cfg.n_cates}
    if arch == "deepfm":
        return {"fields": rng.integers(0, cfg.vocab_per_field,
                                       (1, cfg.n_fields)),
                "cand_ids": np.arange(C)}
    return {"items": rng.integers(0, cfg.n_items, (1, cfg.seq_len)),
            "mask": np.ones((1, cfg.seq_len), bool),
            "cand_ids": np.arange(C)}


@pytest.mark.parametrize("arch", ARCHS)
def test_retrieval_scoring_candidates(arch):
    """The retrieval_cand path, one user against 256 candidates, for
    each arch (the reference tests BERT4Rec's)."""
    jcfg, params, model = _reference(arch)
    b = _retrieval_batch(arch, jcfg)
    jb = {k: v.astype(np.int32) if np.issubdtype(v.dtype, np.integer)
          else v for k, v in b.items()}
    want = _ref_fns(arch)[3](params, _jax(jb), jcfg)
    with torch.no_grad():
        got = t_rs.RECSYS[arch][3](model, _torch(b))
    assert got.shape == (256,) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_modes(mode, weighted):
    """embedding_bag against the reference's in every mode, with two empty
    bags (sum and mean give 0, max -inf), with and without per-sample
    weights; the gradient of a weighted sum of the finite outputs too."""
    import jax
    import jax.numpy as jnp

    from repro.models.embedding import embedding_bag as j_bag
    from repro.models.embedding import embedding_init as j_init
    table = np.asarray(j_init(jax.random.PRNGKey(0), 100, 8))
    flat = np.array([1, 5, 7, 2, 2, 99], np.int32)
    seg = np.array([0, 0, 1, 1, 3, 3], np.int32)
    w = (np.random.default_rng(0).random(6).astype(np.float32) + 0.5
         if weighted else None)
    ct = np.random.default_rng(1).standard_normal((5, 8)).astype(np.float32)

    def j_fn(t):
        out = j_bag(t, jnp.asarray(flat), jnp.asarray(seg), 5, mode=mode,
                    weights=None if w is None else jnp.asarray(w))
        return out, jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0) * ct)

    want, _ = j_fn(jnp.asarray(table))
    want_g = jax.grad(lambda t: j_fn(t)[1])(jnp.asarray(table))
    tt = torch.from_numpy(table.copy()).requires_grad_()
    got = t_emb.embedding_bag(tt, torch.from_numpy(flat),
                              torch.from_numpy(seg), 5, mode=mode,
                              weights=None if w is None
                              else torch.from_numpy(w))
    assert got.shape == (5, 8)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    empty = got[[2, 4]].detach()
    assert bool((empty == (float("-inf") if mode == "max" else 0.0)).all())
    torch.sum(torch.where(torch.isfinite(got), got, 0.0)
              * torch.from_numpy(ct)).backward()
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want_g),
                               **GRAD_TOL)
    if mode == "sum" and not weighted:
        np.testing.assert_allclose(got[0].detach().numpy(),
                                   table[1] + table[5], rtol=1e-6)
    with pytest.raises(ValueError, match="unknown bag mode"):
        t_emb.embedding_bag(tt, torch.from_numpy(flat),
                            torch.from_numpy(seg), 5, mode="min")


def test_embedding_init_pads_rows():
    """pad_rows_to rounds the rows up (BERT4Rec: n_items + 1 -> a multiple
    of 2048); the draw is the scale's normal on the generator's device."""
    t = t_emb.embedding_init(torch.Generator().manual_seed(0), 501, 16,
                             0.02, pad_rows_to=2048)
    assert t.shape == (2048, 16) and t.device.type == "cpu"
    assert 0.015 < float(t.std()) < 0.025
    again = t_emb.embedding_init(torch.Generator().manual_seed(0), 501, 16,
                                 0.02, pad_rows_to=2048)
    assert torch.equal(t, again)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_configs_match_reference(arch):
    """Both presets field by field; the port's init has the reference's
    leaves in its leaf order with the same shapes (BERT4Rec's blocks
    stacked by to_arrays), and the reference's parameter count."""
    import jax

    from repro.configs import get_arch as j_get_arch
    for preset in ("config", "smoke_config"):
        got = getattr(get_arch(arch), preset)()
        want = getattr(j_get_arch(arch), preset)()
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    jcfg, params, _ = _reference(arch)
    model = t_rs.RECSYS[arch][0](torch.Generator().manual_seed(0),
                                 get_arch(arch).smoke_config(), device="cpu")
    got = [a.shape for a in leaves(to_arrays(model))]
    want = [x.shape for x in jax.tree_util.tree_leaves(params)]
    assert got == want
    assert model.n_params() == sum(x.size for x in
                                   jax.tree_util.tree_leaves(params))


@pytest.mark.parametrize("arch", ARCHS)
def test_batches_have_the_reference_shapes(arch):
    """Each batch maker gives the reference's keys, shapes and value
    ranges (the draws are the port's own), and is a function of the step
    alone."""
    from repro.configs import get_arch as j_get_arch
    cfg = get_arch(arch).smoke_config()
    make = getattr(t_pl, BATCH_FNS[arch])
    got, again, other = make(cfg, 16, 3), make(cfg, 16, 3), make(cfg, 16, 4)
    want = _batch(arch, j_get_arch(arch).smoke_config(), 16, 3)
    assert set(got) == set(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k
        assert v.dtype == (torch.bool if want[k].dtype == bool
                           else torch.float32 if want[k].dtype == np.float32
                           else torch.int64), k
        assert torch.equal(v, again[k])
        if v.dtype == torch.int64:
            assert int(v.min()) >= 0 and int(v.max()) <= int(want[k].max()
                                                             .max() * 2 + 1)
    assert any(not torch.equal(v, other[k]) for k, v in got.items())
    if arch == "bert4rec":
        masked = got["items"] == cfg.n_items
        assert torch.equal(masked, got["label_mask"])
        assert bool((got["labels"] < cfg.n_items).all())
    if arch == "din":
        assert bool(got["hist_mask"][:, 0].all())


# ---------------------------------------------------------------------------
# checkpoints across the packages (BERT4Rec: stacked blocks)
# ---------------------------------------------------------------------------

def _b4r_batches(jcfg) -> list[dict]:
    return [_batch("bert4rec", jcfg, 4, s) for s in range(6)]


def _port_fit(tree, batches, steps, ckpt_dir):
    cfg = get_arch("bert4rec").smoke_config()
    model = recsys_params_from_arrays(tree, "bert4rec", cfg, device="cpu")
    model, _ = fit(params=model, optimizer=t_opt.adamw(
        t_opt.cosine_schedule(1e-3, warmup=2, total=6)),
        loss_fn=t_rs.bert4rec_loss, data_fn=lambda s: _torch(batches[s]),
        cfg=TrainConfig(steps=steps, log_every=50, checkpoint_every=3),
        ckpt_dir=ckpt_dir, log_fn=lambda s: None)
    return leaves(to_arrays(model))


def _ref_fit(jcfg, tree, batches, steps, ckpt_dir):
    import jax
    import jax.numpy as jnp

    from repro.models import recsys as j_rs
    from repro.training import optimizer as j_opt
    from repro.training.train_loop import TrainConfig as JTrainConfig
    from repro.training.train_loop import fit as j_fit
    p, _ = j_fit(params=jax.tree_util.tree_map(jnp.asarray, tree),
                 optimizer=j_opt.adamw(j_opt.cosine_schedule(
                     1e-3, warmup=2, total=6)),
                 loss_fn=lambda p, b: j_rs.bert4rec_loss(p, b, jcfg),
                 data_fn=lambda s: _jax(batches[s]),
                 cfg=JTrainConfig(steps=steps, log_every=50,
                                  checkpoint_every=3),
                 ckpt_dir=ckpt_dir, log_fn=lambda s: None)
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(p)]


def test_bert4rec_checkpoints_cross_between_packages(tmp_path):
    """The reference's fit stops at step 2 and the port's fit resumes its
    directory to step 5, and the other way round; both equal the
    reference's uninterrupted 6-step run (atol 1e-4), and the port's
    resumed run its uninterrupted one bit for bit. The blocks cross
    stacked."""
    import jax
    jcfg, params, _ = _reference("bert4rec")
    tree = jax.tree_util.tree_map(np.asarray, params)
    batches = _b4r_batches(jcfg)
    want = _ref_fit(jcfg, tree, batches, 6, None)
    port_full = _port_fit(tree, batches, 6, None)
    a, b, c = (str(tmp_path / x) for x in "abc")
    _ref_fit(jcfg, tree, batches, 3, a)
    got_a = _port_fit(tree, batches, 6, a)
    _port_fit(tree, batches, 3, b)
    got_b = _ref_fit(jcfg, tree, batches, 6, b)
    _port_fit(tree, batches, 3, c)
    got_c = _port_fit(tree, batches, 6, c)
    assert len(want) == len(got_a) == len(got_b) == len(port_full) == 16
    for i, (w, x, y, f, r) in enumerate(zip(want, got_a, got_b, port_full,
                                            got_c)):
        for what, v in (("ref -> port", x), ("port -> ref", y),
                        ("port uninterrupted", f)):
            np.testing.assert_allclose(v, w, rtol=1e-5, atol=1e-4,
                                       err_msg=f"{what}, leaf {i}")
        np.testing.assert_array_equal(r, f, err_msg=f"port resume, leaf {i}")
    assert CheckpointManager(b).steps() == [2, 5]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _shape(line: str) -> str:
    return re.sub(r"-?\d+\.\d+", "X", line)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_lines_match_reference(arch, capsys, monkeypatch, tmp_path):
    """The recsys branch: the same flags print the same lines as the JAX
    launcher, numbers aside; finite losses; the metrics file counts the
    examples a step."""
    from repro.launch import train as j_launch
    argv = ["--arch", arch, "--steps", "4", "--batch", "4"]
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    j_launch.main()
    want = capsys.readouterr().out.splitlines()
    metrics = tmp_path / "m.json"
    t_launch.main(["--device", "cpu", *argv, "--metrics-json",
                   str(metrics)])
    got = capsys.readouterr().out.splitlines()
    assert [_shape(x) for x in got] == [_shape(x) for x in want]
    assert len(got) == 5 and got[-1].startswith("[train] done: loss")
    import json
    m = json.loads(metrics.read_text())
    assert m["kind"] == "recsys" and m["examples_per_step"] == 4
    assert all(np.isfinite(h["loss"]) for h in m["history"])


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_card_equals_cpu(arch, monkeypatch):
    """Each arch at its smoke config on the same weights and batch: the
    forward output, loss and gradients on the card against the CPU
    (fp32, TF32 off; rtol 1e-4, atol 1e-5 x each gradient's largest
    entry: the card's embedding backward accumulates in its own order).
    A gradient that is zero in exact arithmetic (DIN's attention MLP's
    output bias: the softmax ignores a shift of its logits) is rounding
    noise on both devices (7.3e-12 on the CPU, 0 on the card, was seen);
    it must stay within 1e-6 of the model's largest gradient entry of
    zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import copy
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_arch(arch).smoke_config()
    init, fwd, loss_fn, _ = t_rs.RECSYS[arch]
    on_cpu = init(torch.Generator().manual_seed(2), cfg, device="cpu")
    on_card = copy.deepcopy(on_cpu).to("cuda")
    b = getattr(t_pl, BATCH_FNS[arch])(cfg, 16, 0)
    out = {}
    for name, model in (("cpu", on_cpu), ("card", on_card)):
        loss = loss_fn(model, b)
        loss.backward()
        with torch.no_grad():
            out[name] = (fwd(model, b).cpu(), loss.item(),
                         [p.grad.cpu() for p in model.parameters()])
    (fc, lc, gc), (fg, lg, gg) = out["cpu"], out["card"]
    np.testing.assert_allclose(fg.numpy(), fc.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    floor = 1e-6 * max(float(c.abs().max()) for c in gc)
    for a, c in zip(gg, gc):
        if float(c.abs().max()) < floor:      # zero in exact arithmetic
            assert float(a.abs().max()) <= floor
            continue
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-4,
                                   atol=1e-5 * float(c.abs().max()))
