"""MeshGraphNet partitioned over the mesh in the port, as ``gnn_rules`` lay
it (``models/gnn.py``, ``distributed/parallelize.py``): each rank holds its
block of node rows and of edge rows, the edges keeping the whole graph's
node ids; each layer all-gathers the node states and reduce-scatters the
aggregate.

The smoke MeshGraphNet (3 layers, d 32) starts from the JAX package's
initialisation, carried across (``convert.gnn_params_from_arrays``). One
module fixture spawns 4 gloo ranks on a ("data" 2, "model" 2) mesh once;
every test reads their results against the port's single device and the
JAX package's ``loss_fn`` on one device (its ``constrain`` is the
identity without rules; its sharded path cannot run under this box's
jax), computed in this process. Cases:

  * ``sum``: a 256-node, 1,024-edge random graph, the sum aggregator;
  * ``sum_padded`` and ``mean_padded``: 250 nodes and 1,001 edges with
    masks that leave nodes and edges out, padded (``gnn.pad_graph``) to
    252 and 1,004 with masked rows, under both aggregators.

Each rank holds N / 4 node rows and E / 4 edge rows; the ranks' outputs
gathered in rank order equal one device's forward (rtol 1e-5, atol
1e-6), their losses add up to one device's and to the reference's (rtol
1e-5), every gradient (gathered whole) equals one device's within 1e-4 of
its leaf's largest entry; then one AdamW step through the sharded
``make_train_step`` on the padded whole graph (the launcher's path), and
the loss and gradients at the updated parameters, as above. On the padded
graphs no tensor the forward keeps for the backward has the whole graph's
node rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn_ranks

RANK_TIMEOUT_S = 120.0
MESH = (2, 2)
PARTS = MESH[0] * MESH[1]
LR = 1e-3
TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_REL = 1e-4
# name: (aggregator, nodes, edges, masked)
CASES = {"sum": ("sum", 256, 1024, False),
         "sum_padded": ("sum", 250, 1001, True),
         "mean_padded": ("mean", 250, 1001, True)}


def _cfg(aggregator: str):
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch("meshgraphnet").smoke_config(),
                               aggregator=aggregator)


def _graph(cfg, n: int, e: int, masked: bool, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    g = {"node_feat": rng.standard_normal((n, cfg.node_in), np.float32),
         "edge_feat": rng.standard_normal((e, cfg.edge_in), np.float32),
         "senders": rng.integers(0, n, e).astype(np.int32),
         "receivers": rng.integers(0, n, e).astype(np.int32),
         "node_mask": np.ones(n, bool), "edge_mask": np.ones(e, bool),
         "target": rng.standard_normal((n, cfg.node_out), np.float32)}
    if masked:
        g["node_mask"] = rng.random(n) < 0.8
        g["edge_mask"] = rng.random(e) < 0.7
    return g


def _torch(g: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in g.items()}


def _model(cfg, tree):
    from repro_torch.convert import gnn_params_from_arrays
    return gnn_params_from_arrays(tree, cfg, device="cpu")


# ---------------------------------------------------------------------------
# shared by the ranks and the single-device side
# ---------------------------------------------------------------------------

def _saved_rows(fn) -> tuple:
    """The leading dims of every tensor autograd keeps while ``fn`` runs,
    and ``fn``'s result."""
    rows = set()

    def pack(t):
        rows.add(t.shape[0] if t.dim() else 0)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return rows, out


def _loss_grads(model, graph: dict, layout=None) -> dict:
    """The whole graph's loss and every gradient (whole tensors), and the
    leading dims of the tensors the forward keeps."""
    from repro_torch.distributed import parallelize as par
    from repro_torch.models import gnn
    from repro_torch.training.tree import leaves, module_tree
    with par.use_layout(layout):
        rows, local = _saved_rows(lambda: gnn.loss_fn(model, graph))
        loss = par.batch_sum(local.detach())
    grads = torch.autograd.grad(local, leaves(module_tree(model)))
    return {"loss": float(loss), "grads": [par.full(g).numpy()
                                           for g in grads],
            "saved_rows": rows}


def _run(cfg, tree, g: dict, layout=None) -> dict:
    """Forward (this rank's rows), the loss and gradients, one AdamW step
    on the padded whole graph, the loss and gradients after it."""
    from repro_torch.distributed import parallelize as par
    from repro_torch.models import gnn
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.train_loop import TrainConfig, make_train_step
    from repro_torch.training.tree import module_tree
    model = _model(cfg, tree)
    whole = _torch(g)
    graph = whole
    if layout is not None:
        par.shard_module(model, layout.rules, gnn.param_axes(cfg))
        whole = gnn.pad_graph(whole, PARTS)
        graph, _ = par.local_batch(whole, layout)
    with torch.no_grad(), par.use_layout(layout):
        fwd = gnn.forward(model, graph).numpy()
    out = {"rows": {k: tuple(v.shape) for k, v in graph.items()},
           "forward": fwd, "step0": _loss_grads(model, graph, layout)}
    opt = opt_lib.adamw(opt_lib.constant_schedule(LR))
    state = opt.init(module_tree(model))
    step = make_train_step(gnn.loss_fn, opt, TrainConfig(), layout=layout)
    model, state, m = step(model, state, whole, 0)
    out["step_loss"] = float(m["loss"])
    out["step1"] = _loss_grads(model, graph, layout)
    return out


def _rank(rank: int, cases: dict) -> dict:
    from repro_torch.distributed import parallelize as par
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    mesh = make_host_mesh(MESH, ("data", "model"))
    rules = sh.gnn_rules(mesh)
    layout = par.Layout(rules, par.batch_axes_of(rules))
    out = {"coord": mesh.get_coordinate(), "axes": layout.batch_axes}
    for name, (cfg, tree, g) in cases.items():
        out[name] = _run(cfg, tree, g, layout)
    return out


@pytest.fixture(scope="module")
def runs() -> dict:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as j_get_arch
    from repro.models import gnn as j_gnn
    cases, jax_loss = {}, {}
    for name, (agg, n, e, masked) in CASES.items():
        cfg = _cfg(agg)
        jcfg = dataclasses.replace(j_get_arch("meshgraphnet").smoke_config(),
                                   aggregator=agg)
        params = j_gnn.init_params(jax.random.PRNGKey(0), jcfg)
        tree = jax.tree_util.tree_map(np.asarray, params)
        g = _graph(cfg, n, e, masked)
        cases[name] = (cfg, tree, g)
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        jax_loss[name] = float(j_gnn.loss_fn(params, jg, jcfg))
    return {"jax_loss": jax_loss,
            "ranks": spawn_ranks(_rank, PARTS, (cases,),
                                 timeout_s=RANK_TIMEOUT_S),
            "single": {name: _run(cfg, tree, g)
                       for name, (cfg, tree, g) in cases.items()}}


def _grads_close(got: list, want: list, what: str) -> None:
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (what, i)
        err = float(np.abs(a - b).max()) / (float(np.abs(b).max()) or 1.0)
        assert err <= GRAD_REL, f"{what} gradient {i}: {err}"


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_its_block_of_nodes_and_edges(runs, case):
    """Every mesh axis splits the graph: each rank N / 4 node rows and
    E / 4 edge rows of the padded graph."""
    _, n, e, _ = CASES[case]
    n_pad, e_pad = -(-n // PARTS) * PARTS, -(-e // PARTS) * PARTS
    for res in runs["ranks"]:
        assert res["axes"] == ("data", "model")
        rows = res[case]["rows"]
        for k in ("node_feat", "node_mask", "target"):
            assert rows[k][0] == n_pad // PARTS, (k, rows)
        for k in ("edge_feat", "edge_mask", "senders", "receivers"):
            assert rows[k][0] == e_pad // PARTS, (k, rows)


@pytest.mark.parametrize("case", list(CASES))
def test_partitioned_forward_and_loss_match_one_device(runs, case):
    """The ranks' outputs in rank order are one device's forward (the
    padding rows zero); each rank's loss is the whole graph's, equal to
    one device's and to the reference's."""
    _, n, _, _ = CASES[case]
    want = runs["single"][case]
    got = np.concatenate([r[case]["forward"] for r in runs["ranks"]])
    np.testing.assert_allclose(got[:n], want["forward"], **TOL)
    assert not got[n:].any()
    for r, res in enumerate(runs["ranks"]):
        loss = res[case]["step0"]["loss"]
        np.testing.assert_allclose(loss, want["step0"]["loss"], **TOL,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(loss, runs["jax_loss"][case], rtol=1e-5,
                                   err_msg=f"rank {r} vs the reference")


@pytest.mark.parametrize("case", list(CASES))
def test_partitioned_gradients_and_adamw_step_match_one_device(runs, case):
    """Every gradient (whole) at step 0, the sharded step's loss, then the
    loss and every gradient at the parameters one AdamW step left."""
    want = runs["single"][case]
    for r, res in enumerate(runs["ranks"]):
        got = res[case]
        _grads_close(got["step0"]["grads"], want["step0"]["grads"],
                     f"rank {r} step 0")
        np.testing.assert_allclose(got["step_loss"], want["step_loss"],
                                   **TOL)
        np.testing.assert_allclose(got["step1"]["loss"],
                                   want["step1"]["loss"], **TOL)
        _grads_close(got["step1"]["grads"], want["step1"]["grads"],
                     f"rank {r} step 1")


@pytest.mark.parametrize("case", ["sum_padded", "mean_padded"])
def test_no_whole_graph_buffer_is_kept_for_the_backward(runs, case):
    """The gathered node states and the whole aggregate die with their
    layer: autograd keeps only the rank's rows (and the indices), never a
    tensor of the whole graph's 250 node rows (one device keeps many) or
    of its 252 padded ones."""
    _, n, e, _ = CASES[case]
    n_pad, e_pad = 252, 1004
    assert n in runs["single"][case]["step0"]["saved_rows"]
    for r, res in enumerate(runs["ranks"]):
        rows = res[case]["step0"]["saved_rows"]
        assert not {n, n_pad} & rows, (r, sorted(rows))
        assert {n_pad // PARTS, e_pad // PARTS} <= rows


def test_a_graph_the_ranks_do_not_divide_is_refused_or_padded():
    """Under ``gnn_rules`` a graph whose rows do not divide the ranks keeps
    them whole in ``local_batch`` (the rows' fallback), and the forward
    refuses to run it whole; ``pad_graph`` adds masked rows with id 0."""
    from repro_torch.distributed import parallelize as par
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import fake_world, make_host_mesh
    from repro_torch.models import gnn
    cfg = _cfg("sum")
    g = _torch(_graph(cfg, 10, 21, False))
    padded = gnn.pad_graph(g, 4)
    assert padded["node_feat"].shape[0] == 12
    assert padded["senders"].shape[0] == 24
    assert not padded["node_mask"][10:].any()
    assert not padded["edge_mask"][21:].any()
    assert not padded["receivers"][21:].any()
    torch.testing.assert_close(padded["edge_feat"][:21], g["edge_feat"])
    model = gnn.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    with fake_world(4):
        mesh = make_host_mesh(MESH, ("data", "model"))
        layout = par.Layout(sh.gnn_rules(mesh), ("data", "model"))
        rows, axes = par.local_batch(g, layout)
        assert axes == () and rows["node_feat"].shape[0] == 10
        with par.use_layout(par.Layout(layout.rules, axes)), \
                pytest.raises(ValueError, match="pad it"):
            gnn.forward(model, rows)
        block, axes = par.local_batch(padded, layout)
        assert axes == ("data", "model")
        assert block["node_feat"].shape[0] == 3
        assert block["senders"].shape[0] == 6
