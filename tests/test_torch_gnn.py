"""The port's MeshGraphNet (``repro_torch.models.gnn``), its graph makers
and neighbour sampler, and the training launcher's gnn branch, held
against the JAX package on the CPU.

Every GNN test of tests/test_arch_smoke.py has its pair here, on the
reference's smoke config with its initial parameters carried across by
``convert.gnn_params_from_arrays`` and the reference's graphs fed to
both. Tolerances: forward outputs and losses rtol 1e-5, atol 1e-6;
gradients rtol 1e-4, atol 1e-6 (the segment sums add in another order).
The sampler is numpy in both packages and must give the same arrays bit
for bit. The ``gpu`` test runs a step on the card against the CPU and a
resumed fit against an uninterrupted one under deterministic algorithms.
This file collects without JAX: the reference is imported inside the
tests that use it.
"""

from __future__ import annotations

import dataclasses
import re
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.convert import gnn_params_from_arrays, to_arrays
from repro_torch.data import pipeline as t_pl
from repro_torch.launch import train as t_launch
from repro_torch.models import gnn as t_gnn
from repro_torch.training.tree import leaves, module_tree, tree_map

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _reference(**over):
    """(reference config, its initial parameters, the port's model carried
    across from them)."""
    import jax

    from repro.configs import get_arch as j_get_arch
    from repro.models import gnn as j_gnn
    jcfg = dataclasses.replace(j_get_arch("meshgraphnet").smoke_config(),
                               **over)
    tcfg = dataclasses.replace(get_arch("meshgraphnet").smoke_config(),
                               **over)
    params = j_gnn.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, params, gnn_params_from_arrays(tree, tcfg, device="cpu")


def _np(g: dict) -> dict:
    return {k: np.asarray(v) for k, v in g.items()}


def _torch(g: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)).long()
            if np.issubdtype(v.dtype, np.integer)
            else torch.from_numpy(np.array(v)) for k, v in g.items()}


def _check(jcfg, params, model, g: dict, grads: bool = True) -> None:
    """Forward and loss (and every gradient) of the port against the
    reference's on graph ``g`` (numpy)."""
    import jax
    import jax.numpy as jnp

    from repro.models import gnn as j_gnn
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    want = jax.jit(lambda p: j_gnn.forward(p, jg, jcfg))(params)
    with torch.no_grad():
        out = t_gnn.forward(model, _torch(g))
    assert out.shape == want.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    if not grads:
        return
    want_loss, want_g = jax.jit(jax.value_and_grad(
        lambda p: j_gnn.loss_fn(p, jg, jcfg)))(params)
    loss = t_gnn.loss_fn(model, _torch(g))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    got = leaves(to_arrays(tree_map(lambda p: p.grad, module_tree(model))))
    want_flat = jax.tree_util.tree_leaves(want_g)
    assert len(got) == len(want_flat)
    for i, (a, w) in enumerate(zip(got, want_flat)):
        assert a.shape == w.shape
        np.testing.assert_allclose(a, np.asarray(w), **GRAD_TOL,
                                   err_msg=f"gradient leaf {i}")


@pytest.mark.parametrize("aggregator", ["sum", "mean"])
def test_meshgraphnet_smoke(aggregator):
    """A 64-node, 256-edge random graph (its test_meshgraphnet_smoke):
    forward, loss and gradients; the mean aggregator too, and a graph
    whose masks leave edges and nodes out."""
    from repro.data import pipeline as j_pl
    jcfg, params, model = _reference(aggregator=aggregator)
    spec = j_pl.GraphSpec(n_nodes=64, n_edges=256, d_node=jcfg.node_in,
                          d_edge=jcfg.edge_in, node_out=jcfg.node_out)
    g = _np(j_pl.random_graph(spec))
    _check(jcfg, params, model, g)
    rng = np.random.default_rng(0)
    g["edge_mask"] = rng.random(256) < 0.7
    g["node_mask"] = rng.random(64) < 0.8
    model.zero_grad()
    _check(jcfg, params, model, g)


def test_meshgraphnet_molecule_union():
    """disjoint_union of four 10-node graphs: the port's union of the
    same graphs equals the reference's, and the forward on it."""
    from repro.data import pipeline as j_pl
    jcfg, params, model = _reference()
    spec = j_pl.GraphSpec(n_nodes=10, n_edges=20, d_node=jcfg.node_in,
                          d_edge=jcfg.edge_in, node_out=jcfg.node_out)
    graphs = [_np(j_pl.random_graph(dataclasses.replace(spec, seed=s)))
              for s in range(4)]
    want = _np(j_pl.disjoint_union(graphs))
    got = t_pl.disjoint_union([_torch(g) for g in graphs])
    assert set(got) == set(want) and got["node_feat"].shape[0] == 40
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    assert int(got["senders"].max()) < 40
    _check(jcfg, params, model, want, grads=False)


def test_neighbor_sampler_bit_equal():
    """random_csr and sample (its test_neighbor_sampler_geometry): every
    array equals the reference's bit for bit, over steps and fanouts,
    with isolated nodes in the graph; the slot geometry and replay."""
    from repro.data import pipeline as j_pl
    for n, deg, fanout, seeds in ((500, 8, (5, 3), 16),
                                  (300, 1, (4, 2, 2), 9)):
        want_csr = j_pl.NeighborSampler.random_csr(n, avg_degree=deg, seed=3)
        got_csr = t_pl.NeighborSampler.random_csr(n, avg_degree=deg, seed=3)
        for a, b in zip(got_csr, want_csr, strict=True):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        if deg == 1:                # isolated nodes: a masked fanout
            assert (np.diff(got_csr[0]) == 0).any()
        ref = j_pl.NeighborSampler(*want_csr, fanout=fanout, seed=1)
        port = t_pl.NeighborSampler(*got_csr, fanout=fanout, seed=1)
        for step in range(3):
            want, got = ref.sample(seeds, step), port.sample(seeds, step)
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    port = t_pl.NeighborSampler(*t_pl.NeighborSampler.random_csr(500, 8),
                                fanout=(5, 3))
    sub = port.sample(batch_nodes=16, step=0)
    assert len(sub["node_ids"]) == 16 + 80 + 240
    assert len(sub["senders"]) == 80 + 240
    assert not np.array_equal(sub["node_ids"],
                              port.sample(16, 1)["node_ids"])


def test_gnn_on_sampled_subgraph():
    """A sampled subgraph (its test_gnn_on_sampled_subgraph): the port's
    batch has the reference's graph arrays and shapes (features drawn by
    the port), and the forward on the reference's batch matches."""
    from repro.data import pipeline as j_pl
    jcfg, params, model = _reference()
    indptr, indices = j_pl.NeighborSampler.random_csr(200, avg_degree=6)
    ref = j_pl.NeighborSampler(indptr, indices, fanout=(4, 3))
    port = t_pl.NeighborSampler(indptr, indices, fanout=(4, 3))
    want = _np(j_pl.sampled_subgraph_batch(ref, 8, jcfg.node_in,
                                           jcfg.edge_in, jcfg.node_out, 0))
    got = t_pl.sampled_subgraph_batch(port, 8, jcfg.node_in, jcfg.edge_in,
                                      jcfg.node_out, 0)
    for k in ("senders", "receivers", "edge_mask", "node_mask"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k in ("node_feat", "edge_feat", "target"):
        assert tuple(got[k].shape) == want[k].shape
    _check(jcfg, params, model, want)


def test_random_graph_shapes_and_replay():
    """random_graph: the reference's keys, shapes and dtypes; a function of
    (seed, step)."""
    from repro.data import pipeline as j_pl
    spec = t_pl.GraphSpec(256, 1024, 8, 4, 3)
    got, again = t_pl.random_graph(spec, 5), t_pl.random_graph(spec, 5)
    want = _np(j_pl.random_graph(j_pl.GraphSpec(256, 1024, 8, 4, 3), 5))
    assert set(got) == set(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape
        assert torch.equal(v, again[k])
    assert int(got["senders"].max()) < 256
    assert not torch.equal(got["node_feat"],
                           t_pl.random_graph(spec, 6)["node_feat"])


def test_init_and_configs_match_reference():
    """Both presets field by field; the port's init has the reference's
    leaves, in order, with its shapes (layers stacked by to_arrays)."""
    import jax

    from repro.configs import get_arch as j_get_arch
    for preset in ("config", "smoke_config"):
        got = getattr(get_arch("meshgraphnet"), preset)()
        want = getattr(j_get_arch("meshgraphnet"), preset)()
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    _, params, _ = _reference()
    model = t_gnn.init_params(torch.Generator().manual_seed(0),
                              get_arch("meshgraphnet").smoke_config(),
                              device="cpu")
    assert ([a.shape for a in leaves(to_arrays(model))]
            == [x.shape for x in jax.tree_util.tree_leaves(params)])


def _shape(line: str) -> str:
    return re.sub(r"-?\d+\.\d+", "X", line)


def test_launcher_lines_match_reference(capsys, monkeypatch, tmp_path):
    """The gnn branch: the same flags print the same lines as the JAX
    launcher, numbers aside, with finite losses; a rerun on the same
    checkpoint directory resumes."""
    from repro.launch import train as j_launch
    argv = ["--arch", "meshgraphnet", "--steps", "4"]
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    j_launch.main()
    want = capsys.readouterr().out.splitlines()
    d = str(tmp_path / "ckpt")
    metrics = tmp_path / "m.json"
    t_launch.main(["--device", "cpu", *argv, "--ckpt-dir", d,
                   "--metrics-json", str(metrics)])
    got = capsys.readouterr().out.splitlines()
    assert [_shape(x) for x in got] == [_shape(x) for x in want]
    import json
    m = json.loads(metrics.read_text())
    assert m["kind"] == "gnn" and m["nodes_per_step"] == 256
    assert all(np.isfinite(h["loss"]) for h in m["history"])
    t_launch.main(["--device", "cpu", *argv, "--ckpt-dir", d])
    assert "[train] done: resumed at step 3" in capsys.readouterr().out


@pytest.mark.gpu
def test_card_step_and_deterministic_resume(monkeypatch, tmp_path):
    """The smoke config on a 256-node random graph: forward, loss and
    gradients on the card against the CPU (rtol 1e-4, atol 1e-5 x each
    gradient's largest entry); under deterministic algorithms a fit of 6
    steps stopped at 3 and resumed equals the uninterrupted one bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import copy

    from repro_torch.training import optimizer as t_opt
    from repro_torch.training.train_loop import TrainConfig, fit
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_arch("meshgraphnet").smoke_config()
    on_cpu = t_gnn.init_params(torch.Generator().manual_seed(1), cfg,
                               device="cpu")
    on_card = copy.deepcopy(on_cpu).to("cuda")
    spec = t_pl.GraphSpec(256, 1024, cfg.node_in, cfg.edge_in, cfg.node_out)
    g = t_pl.random_graph(spec, 0)
    out = {}
    for name, model in (("cpu", on_cpu), ("card", on_card)):
        loss = t_gnn.loss_fn(model, g)
        loss.backward()
        out[name] = (loss.item(), [p.grad.cpu() for p in model.parameters()])
    np.testing.assert_allclose(out["card"][0], out["cpu"][0], rtol=1e-5)
    for a, c in zip(out["card"][1], out["cpu"][1]):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-4,
                                   atol=1e-5 * float(c.abs().max()))

    def run(steps, d):
        model = t_gnn.init_params(torch.Generator().manual_seed(1), cfg,
                                  device="cuda")
        model, _ = fit(params=model, optimizer=t_opt.adamw(
            t_opt.constant_schedule(1e-3)), loss_fn=t_gnn.loss_fn,
            data_fn=lambda s: t_pl.random_graph(spec, s),
            cfg=TrainConfig(steps=steps, log_every=50, checkpoint_every=3),
            ckpt_dir=d, log_fn=lambda s: None)
        return [p.detach().clone() for p in model.parameters()]

    torch.use_deterministic_algorithms(True)
    try:
        full = run(6, None)
        d = str(tmp_path / "ckpt")
        run(3, d)
        resumed = run(6, d)
    finally:
        torch.use_deterministic_algorithms(False)
    assert all(torch.equal(a, b) for a, b in zip(full, resumed))
