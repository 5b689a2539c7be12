"""Sharded training in the port (``repro_torch.distributed.parallelize``,
the sharded ``make_train_step``/``fit``, the expert-parallel MoE and the
row-sharded embedding lookup) on gloo CPU ranks.

The reference's FSDP and all-to-all tests fail on this box's jax (its
meshes default to Explicit axes), so the sharded paths are held against
the port's own single-device paths, which tests/test_torch_transformer.py
and tests/test_torch_moe.py hold against the JAX package; the row-sharded
lookup is held against the JAX package's ``embedding_lookup`` under its
own (4, 2) mesh as well, as tests/test_distributed.py runs it.

One module fixture spawns each world once (4 ranks for the (2, 2) mesh,
2 for (2, 1) and (1, 2), 8 for (4, 2); 120 s limit a spawn) and every
test reads its results:

  * olmo-1b smoke, batch 8 x 32 with a mask that gives each data rank a
    different token count (on (2, 2) each rank also takes its half of the
    sequence, which ``lm_rules`` split over 'model'): the step-0 loss and every gradient, then 3
    AdamW steps (loss, grad norm, every parameter and moment), against
    ``make_train_step`` on one device: rtol 1e-5 / atol 1e-6 on the
    loss, 1e-4 / 1e-6 on gradients, parameters and moments (float32; the
    sums over the batch and the reduce-scatters add in other orders);
  * olmo-1b smoke in bf16 compute on (2, 1) (16-bit gathers and
    reduce-scatters): step 0's loss to rtol 1e-2, every gradient within
    2e-2 of its largest entry;
  * a checkpoint written on (2, 2) resumed on one device, then on (2, 1):
    every step's loss and the final parameters against an uninterrupted
    one-device run, rtol 1e-4 / atol 1e-6;
  * olmoe smoke (no-drop capacity) on (2, 2) through the transformer
    (FSDP, the a2a, the aux loss over the whole batch), its backward and remat recompute run
    outside the rules' context as the card's autograd threads run them:
    loss rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-6;
  * the a2a MoE on (1, 2) and (2, 2) at no-drop capacity (cf = E / K),
    each rank on its rows and chunk of the sequence (``lm_rules`` split
    it over 'model', and so does ``local_batch``), against
    ``apply_moe``: output rtol 1e-5 / atol 1e-6, aux 1e-6
    absolute, gradients of every weight and of the input rtol 1e-4 /
    atol 1e-6; the path must have made its all-to-alls;
  * the row-sharded lookup on (4, 2): rows and table gradient against
    ``table[ids]`` exactly (each row is one rank's, the others add
    zeros), the non-dividing batch of 6 included, and the rows against
    the JAX package's output exactly.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn_ranks

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 120.0
B, S = 8, 32
LR = 1e-3
STEPS = 3
RESUME = (3, 5, 7)          # (2, 2) to step 2, one device to 4, (2, 1) to 6
MOE = dict(n_experts=8, top_k=2, d_ff_expert=32, capacity_factor=4.0)
MOE_D = 16

REFERENCE = """
import sys
import numpy as np
import jax
assert jax.device_count() == 8, jax.devices()
from repro.distributed import sharding as sh
from repro.models.embedding import embedding_lookup, embedding_init

table = embedding_init(jax.random.PRNGKey(0), 64, 16)
ids = jax.random.randint(jax.random.PRNGKey(1), (8, 5), 0, 64)
mesh = jax.make_mesh((4, 2), ("data", "model"))
rules = sh.recsys_rules(mesh)
with mesh, sh.use_rules(rules):
    out = jax.jit(embedding_lookup)(table, ids)
    out6 = jax.jit(embedding_lookup)(table, ids[:6])
np.savez(sys.argv[1], table=np.asarray(table), ids=np.asarray(ids),
         out=np.asarray(out), out6=np.asarray(out6))
"""


# ---------------------------------------------------------------------------
# shared by the ranks and the single-device side
# ---------------------------------------------------------------------------

def _lm_cfg(dtype: str = "float32"):
    import dataclasses

    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch("olmo-1b").smoke_config(),
                               dtype=dtype)


def _batch(step: int) -> dict:
    """Batch ``step`` with rows masked unevenly: the first half of the
    batch (data rank 0's rows on a 2-way split) keeps fewer tokens."""
    from repro_torch.data.pipeline import LMDataSpec, lm_batch
    cfg = _lm_cfg()
    b = {k: v[:, :S] for k, v in
         lm_batch(LMDataSpec(cfg.vocab, S + 1, B), step).items()}
    for r in range(B // 2):
        b["mask"][r, : 3 * (r + 1)] = 0.0
    return b


def _lm_model(dtype: str = "float32"):
    from repro_torch.models import transformer as tf
    return tf.init_params(torch.Generator().manual_seed(0), _lm_cfg(dtype),
                          device="cpu")


def _optimizer():
    from repro_torch.training import optimizer as opt_lib
    return opt_lib.adamw(opt_lib.constant_schedule(LR))


def _arrays(tree) -> list[np.ndarray]:
    from repro_torch.convert import to_arrays
    from repro_torch.training.tree import leaves
    return [np.asarray(a) for a in leaves(to_arrays(tree))]


def _lm_steps(layout=None) -> dict:
    """Step-0 loss and gradients, then STEPS AdamW steps."""
    from repro_torch.distributed import parallelize as par
    from repro_torch.models import transformer as tf
    from repro_torch.training.train_loop import TrainConfig, make_train_step
    from repro_torch.training.tree import leaves, module_tree
    cfg = _lm_cfg()
    model = _lm_model()
    if layout is not None:
        par.shard_module(model, layout.rules, tf.param_axes(cfg))
        rows, axes = par.local_batch(_batch(0), layout)
        with par.use_layout(par.Layout(layout.rules, axes)):
            local = tf.loss_fn(model, rows)
            loss = par.batch_sum(local.detach())
        # the backward (and the remat recompute in it) outside the rules'
        # context, as the autograd engine runs it for a CUDA tensor: on a
        # thread of its own
        grads = torch.autograd.grad(local, leaves(module_tree(model)))
    else:
        loss = tf.loss_fn(model, _batch(0))
        grads = torch.autograd.grad(loss, leaves(module_tree(model)))
    out = {"loss0": float(loss.detach()),
           "grads0": [par.full(g).numpy() for g in grads]}
    opt = _optimizer()
    state = opt.init(module_tree(model))
    step = make_train_step(tf.loss_fn, opt, TrainConfig(), layout=layout)
    out["losses"], out["gnorms"] = [], []
    for i in range(STEPS):
        model, state, m = step(model, state, _batch(i), i)
        out["losses"].append(float(m["loss"]))
        out["gnorms"].append(float(m["grad_norm"]))
    out["params"] = _arrays(model)
    out["moments"] = _arrays(state)
    return out


def _moe_lm(layout=None) -> dict:
    """olmoe smoke (fp32, capacity E / K): step 0's loss and gradients;
    sharded, the
    backward runs outside the rules' context (the remat recompute must
    take the all-to-all path again)."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed import parallelize as par
    from repro_torch.models import transformer as tf
    from repro_torch.training.tree import leaves, module_tree
    import dataclasses
    cfg = get_arch("olmoe-1b-7b").smoke_config()
    # no-drop capacity: the all-to-all caps each source shard, the
    # one-device path each sequence, so drops would differ by design
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    model = tf.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    batch = _batch(0)
    if layout is not None:
        par.shard_module(model, layout.rules, tf.param_axes(cfg))
        batch, axes = par.local_batch(batch, layout)
        layout = par.Layout(layout.rules, axes)
    with par.use_layout(layout):
        local = tf.loss_fn(model, batch)
        loss = par.batch_sum(local.detach())
    grads = torch.autograd.grad(local, leaves(module_tree(model)))
    return {"loss": float(loss), "grads": [par.full(g).numpy()
                                           for g in grads]}


def _bf16_loss_and_grads(layout=None) -> dict:
    """Step 0 in bf16 compute (16-bit gathers, their reduce-scatters in
    float32): the loss and the gradients of the float32 masters."""
    from repro_torch.distributed import parallelize as par
    from repro_torch.models import transformer as tf
    from repro_torch.training.tree import leaves, module_tree
    model = _lm_model("bfloat16")
    batch = _batch(0)
    if layout is not None:
        par.shard_module(model, layout.rules, tf.param_axes(model.cfg))
        batch, axes = par.local_batch(batch, layout)
        layout = par.Layout(layout.rules, axes)
    with par.use_layout(layout):
        loss = tf.loss_fn(model, batch)
        grads = torch.autograd.grad(loss, leaves(module_tree(model)))
        loss = par.batch_sum(loss.detach())
    return {"loss": float(loss), "grads": [par.full(g).numpy()
                                           for g in grads]}


def _fit(steps: int, ckpt: str, layout=None) -> dict:
    from repro_torch.distributed import parallelize as par
    from repro_torch.models import transformer as tf
    from repro_torch.training.train_loop import TrainConfig, fit
    model = _lm_model()
    if layout is not None:
        par.shard_module(model, layout.rules, tf.param_axes(_lm_cfg()))
    model, hist = fit(params=model, optimizer=_optimizer(),
                      loss_fn=tf.loss_fn, data_fn=_batch,
                      cfg=TrainConfig(steps=steps, log_every=1,
                                      checkpoint_every=100),
                      ckpt_dir=ckpt, log_fn=lambda _: None, layout=layout)
    return {"losses": {h["step"]: h["loss"] for h in hist},
            "params": _arrays(model)}


def _moe_inputs():
    from repro_torch.models import moe
    cfg = moe.MoEConfig(**MOE)
    gen = torch.Generator().manual_seed(3)
    p = moe.moe_init(gen, MOE_D, cfg, "swiglu")
    x = torch.randn((4, 16, MOE_D), generator=gen)
    return cfg, p, x


def _moe_grads(params: dict, x: torch.Tensor, cfg):
    """(out, aux, grads of the weights in key order, grad of x) of
    ``sum(out ** 2) + aux``."""
    from repro_torch.models import moe
    x = x.detach().requires_grad_()
    out, aux = moe.apply_moe(params, x, cfg, "swiglu")
    keys = sorted(params)
    loss = torch.sum(out.float() ** 2) + aux
    grads = torch.autograd.grad(loss, [params[k] for k in keys] + [x])
    return out.detach(), aux.detach(), keys, grads


def _a2a(mesh) -> dict:
    from repro_torch.distributed import parallelize as par
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import moe
    from repro_torch.models.layers import ParamTree
    cfg, p, x = _moe_inputs()
    tree = ParamTree(p)
    rules = sh.lm_rules(mesh)
    par.shard_module(tree, rules, moe.moe_axes(cfg, "swiglu"))
    layout = par.Layout(rules, par.batch_axes_of(rules))
    rows, axes = par.local_batch({"x": x}, layout)
    calls = []
    real = par.all_to_all

    def counted(t, g):
        calls.append(t.shape)
        return real(t, g)

    par.all_to_all = counted
    try:
        with par.use_layout(par.Layout(rules, axes)):
            assert moe._a2a_path_available(cfg, x.shape[0], x.shape[1])
            assert moe._moe_weight_dims_divide(p, mesh)
            out, aux, keys, grads = _moe_grads(dict(tree.items()), rows["x"],
                                               cfg)
    finally:
        par.all_to_all = real
    return {"out": out.numpy(), "aux": float(aux), "a2a_calls": len(calls),
            "keys": keys,
            "grads": [par.full(g).numpy() for g in grads[:-1]],
            "grad_x": grads[-1].numpy(), "axes": axes}


def _lookup(mesh, table: np.ndarray, ids: np.ndarray) -> dict:
    from repro_torch.distributed import parallelize as par
    from repro_torch.distributed import sharding as sh
    from repro_torch.models.embedding import embedding_lookup
    from repro_torch.models.layers import ParamTree
    rules = sh.recsys_rules(mesh)
    tree = ParamTree({"t": torch.from_numpy(table)})
    par.shard_module(tree, rules, {"t": ("table_rows", "embed")})
    layout = par.Layout(rules, par.batch_axes_of(rules))
    out = {}
    for name, n in (("full", 8), ("ragged", 6)):
        rows, axes = par.local_batch({"ids": torch.from_numpy(ids[:n])},
                                     layout)
        with par.use_layout(par.Layout(rules, axes)):
            emb = embedding_lookup(tree["t"], rows["ids"])
            w = torch.arange(emb.numel(), dtype=torch.float32).reshape(
                emb.shape)
            (g,) = torch.autograd.grad(torch.sum(emb * w), [tree["t"]])
        out[name] = {"rows": emb.detach().numpy(), "axes": axes,
                     "grad": par.full(g).numpy()}
    return out


# ---------------------------------------------------------------------------
# rank functions (spawned ranks import them by name)
# ---------------------------------------------------------------------------

def _layout(mesh):
    from repro_torch.distributed import parallelize as par
    from repro_torch.distributed import sharding as sh
    rules = sh.lm_rules(mesh)
    return par.Layout(rules, par.batch_axes_of(rules))


def _rank_4(rank: int, ckpt: str) -> dict:
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    mesh = make_host_mesh((2, 2), ("data", "model"))
    return {"coord": mesh.get_coordinate(),
            "lm": _lm_steps(_layout(mesh)),
            "a2a": _a2a(mesh),
            "moe_lm": _moe_lm(_layout(mesh)),
            "resume": _fit(RESUME[0], ckpt, _layout(mesh))}


def _rank_2(rank: int, ckpt: str) -> dict:
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(2)
    mesh = make_host_mesh((2, 1), ("data", "model"))
    out = {"lm": _lm_steps(_layout(mesh)),
           "bf16": _bf16_loss_and_grads(_layout(mesh)),
           "resume": _fit(RESUME[2], ckpt, _layout(mesh))}
    # the same two ranks as a (1, 2) mesh: a2a over 'model' alone
    out["a2a"] = _a2a(make_host_mesh((1, 2), ("data", "model")))
    return out


def _rank_8(rank: int, table: np.ndarray, ids: np.ndarray) -> dict:
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    mesh = make_host_mesh((4, 2), ("data", "model"))
    return {"coord": mesh.get_coordinate(),
            "lookup": _lookup(mesh, table, ids)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory) -> dict:
    tmp = tmp_path_factory.mktemp("sharded")
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8")
    env["PYTHONPATH"] = str(ROOT / "src")
    ref_path = tmp / "lookup.npz"
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, str(ref_path)],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    ckpt = str(tmp / "ckpt")
    out = {"r4": spawn_ranks(_rank_4, 4, (ckpt,),
                             timeout_s=RANK_TIMEOUT_S)}
    # one device resumes the (2, 2) checkpoint
    out["resume_1"] = _fit(RESUME[1], ckpt)
    out["r2"] = spawn_ranks(_rank_2, 2, (ckpt,), timeout_s=RANK_TIMEOUT_S)
    out["single"] = _lm_steps()
    out["single_bf16"] = _bf16_loss_and_grads()
    out["single_moe_lm"] = _moe_lm()
    out["uninterrupted"] = _fit(RESUME[2], str(tmp / "whole"))
    cfg, p, x = _moe_inputs()
    for t in p.values():
        t.requires_grad_()
    out["moe"] = _moe_grads(p, x, cfg)
    _, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-3000:]
    with np.load(ref_path) as z:
        out["jax"] = {k: z[k] for k in z.files}
    out["r8"] = spawn_ranks(_rank_8, 8, (out["jax"]["table"],
                                         out["jax"]["ids"]),
                            timeout_s=RANK_TIMEOUT_S)
    return out


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("world", ["r2", "r4"])
def test_fsdp_step_matches_single_device(runs, world):
    """olmo-1b smoke on (2, 1) and (2, 2): the step-0 loss and every
    gradient, then 3 AdamW steps, equal the one-device step."""
    want = runs["single"]
    for r, res in enumerate(runs[world]):
        got = res["lm"]
        _close(got["loss0"], want["loss0"], 1e-5, 1e-6, f"rank {r} loss0")
        assert len(got["grads0"]) == len(want["grads0"])
        for i, (a, b) in enumerate(zip(got["grads0"], want["grads0"])):
            _close(a, b, 1e-4, 1e-6, f"rank {r} grad {i}")
        _close(got["losses"], want["losses"], 1e-5, 1e-6, f"rank {r} losses")
        _close(got["gnorms"], want["gnorms"], 1e-5, 1e-6, f"rank {r} gnorm")
        for i, (a, b) in enumerate(zip(got["params"], want["params"])):
            _close(a, b, 1e-4, 1e-6, f"rank {r} param {i}")
        for i, (a, b) in enumerate(zip(got["moments"], want["moments"])):
            _close(a, b, 1e-4, 1e-6, f"rank {r} moment {i}")


def test_moe_lm_step_matches_single_device(runs):
    """olmoe smoke on (2, 2): FSDP over "data", the experts' all-to-all
    over "model", the aux loss over the whole batch; the backward (with
    the layers' remat recompute) runs outside the rules' context. Loss
    rtol 1e-5, every gradient rtol 1e-4 / atol 1e-6 of one device's."""
    want = runs["single_moe_lm"]
    for r, res in enumerate(runs["r4"]):
        got = res["moe_lm"]
        _close(got["loss"], want["loss"], 1e-5, 1e-6, f"rank {r} loss")
        for i, (a, b) in enumerate(zip(got["grads"], want["grads"])):
            _close(a, b, 1e-4, 1e-6, f"rank {r} grad {i}")


def test_bf16_step_matches_single_device(runs):
    """bf16 compute on (2, 1): the gathers move 16-bit bytes and the
    gradients' reduce-scatters sum in float32; loss to rtol 1e-2 and
    every gradient within 2e-2 of its largest entry (bf16 rounding of
    sums in other orders) of the one-device step's."""
    want = runs["single_bf16"]
    for r, res in enumerate(runs["r2"]):
        got = res["bf16"]
        _close(got["loss"], want["loss"], 1e-2, 0, f"rank {r} loss")
        for i, (a, b) in enumerate(zip(got["grads"], want["grads"])):
            scale = float(np.abs(b).max()) or 1.0
            assert float(np.abs(a - b).max()) <= 2e-2 * scale, (r, i)


def test_checkpoint_resumes_across_meshes(runs):
    """(2, 2) writes step 2, one device resumes to step 4, (2, 1) resumes
    to step 6: every step's loss and the last parameters equal an
    uninterrupted one-device run."""
    want = runs["uninterrupted"]
    got = dict(runs["r4"][0]["resume"]["losses"])
    assert sorted(got) == [0, 1, 2]
    got.update(runs["resume_1"]["losses"])
    assert sorted(runs["resume_1"]["losses"]) == [3, 4]
    got.update(runs["r2"][0]["resume"]["losses"])
    assert sorted(runs["r2"][0]["resume"]["losses"]) == [5, 6]
    assert sorted(got) == sorted(want["losses"])
    for s in sorted(got):
        _close(got[s], want["losses"][s], 1e-4, 1e-6, f"step {s}")
    for res in runs["r2"]:
        for i, (a, b) in enumerate(zip(res["resume"]["params"],
                                       want["params"])):
            _close(a, b, 1e-4, 1e-6, f"param {i}")


@pytest.mark.parametrize("world", ["r2", "r4"])
def test_a2a_moe_matches_apply_moe(runs, world):
    """The expert-parallel MoE on (1, 2) and (2, 2) at no-drop capacity,
    the sequence split over 'model' as ``lm_rules`` split it: output and
    the input's gradient (each rank's rows and chunk of the sequence),
    aux (every rank's share, summed, is the whole batch's) and every
    weight's gradient equal the one-device ``apply_moe``."""
    out, aux, keys, grads = runs["moe"]
    ranks = runs[world]
    n_data = 2 if world == "r4" else 1
    rows, cols = out.shape[0] // n_data, out.shape[1] // 2
    shares = []
    for r, res in enumerate(ranks):
        got = res["a2a"]
        assert got["a2a_calls"] >= 2, "the all-to-all path was not taken"
        assert got["keys"] == keys
        d, m = (r // 2, r % 2) if world == "r4" else (0, r)
        blk = (slice(d * rows, (d + 1) * rows), slice(m * cols,
                                                      (m + 1) * cols))
        _close(got["out"], out[blk], 1e-5, 1e-6, f"rank {r} out")
        _close(got["grad_x"], grads[-1][blk], 1e-4, 1e-6,
               f"rank {r} grad x")
        for k, a, b in zip(keys, got["grads"], grads[:-1]):
            _close(a, b, 1e-4, 1e-6, f"rank {r} grad {k}")
        shares.append(got["aux"])
    assert abs(sum(shares) - float(aux)) < 1e-6, (shares, float(aux))


def test_row_sharded_lookup_matches_table_and_reference(runs):
    """(4, 2): each data rank's rows of the lookup equal ``table[ids]``
    and the JAX package's output; a batch of 6 (not divisible by 4) runs
    whole on every rank; the table's gradient equals the scatter-add of
    the upstream gradient (the whole batch's once, where it ran whole on
    every rank)."""
    jx = runs["jax"]
    table, ids = torch.from_numpy(jx["table"]), torch.from_numpy(jx["ids"])
    for r, res in enumerate(runs["r8"]):
        d = res["coord"][0]
        full = res["lookup"]["full"]
        assert full["axes"] == ("data",)
        np.testing.assert_array_equal(full["rows"],
                                      table[ids][2 * d: 2 * d + 2].numpy())
        np.testing.assert_array_equal(full["rows"],
                                      jx["out"][2 * d: 2 * d + 2])
        ragged = res["lookup"]["ragged"]
        assert ragged["axes"] == ()
        np.testing.assert_array_equal(ragged["rows"], table[ids[:6]].numpy())
        np.testing.assert_array_equal(ragged["rows"], jx["out6"])
        for name, n in (("full", 8), ("ragged", 6)):
            w = torch.arange(n * 5 * 16, dtype=torch.float32).reshape(
                n, 5, 16)
            if name == "full":
                # every data rank weighs its own rows from 0
                w = torch.cat([torch.arange(2 * 5 * 16, dtype=torch.float32
                                            ).reshape(2, 5, 16)] * 4)
            want = torch.zeros_like(table).index_add(
                0, ids[:n].reshape(-1), w.reshape(-1, 16))
            np.testing.assert_allclose(res["lookup"][name]["grad"],
                                       want.numpy(), rtol=1e-6,
                                       err_msg=f"rank {r} {name} grad")
