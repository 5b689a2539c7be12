"""The port's sharding rules (``repro_torch.distributed.sharding``) held
against the JAX package's, with no collective.

The JAX side runs once, in a subprocess with eight host devices (as
tests/test_distributed.py runs it). It builds ``shard_with_shapes`` of
every parameter leaf of the eleven archs' smoke configs (shapes from
``jax.eval_shape``) on a (4, 2) ("data", "model") and a (2, 2, 2)
("pod", "data", "model") mesh, the LM rules' serving variants over the
parameters and the KV cache, and ``index_shard_specs`` for the retrieval
index, and writes each leaf's ``PartitionSpec`` as lists of mesh axes. It
compiles nothing.

The port side builds the same meshes as ``DeviceMesh``es of a fake
process group of eight ranks in this process (``torch``'s ``fake``
backend: no rank, no collective), initialises each smoke model, and
requires, leaf by leaf, the same mesh axes on every dim and the
``DTensor`` placements they give (``Shard(d)`` on each mesh dim a dim is
split over, ``Replicate()`` elsewhere). Exact equality: these are names.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.distributed import parallelize as par
from repro_torch.distributed import sharding as sh

ROOT = Path(__file__).resolve().parents[1]

ARCHS = ("stablelm-3b", "qwen3-14b", "olmo-1b", "llama4-scout-17b-a16e",
         "olmoe-1b-7b", "meshgraphnet", "dlrm-mlperf", "din", "deepfm",
         "bert4rec", "asc-splade")
MESHES = {"data4_model2": ((4, 2), ("data", "model")),
          "pod2_data2_model2": ((2, 2, 2), ("pod", "data", "model"))}
# the LM rules' variants beside training (kwargs of lm_rules)
SERVING = {"serve": dict(training=False),
           "decode": dict(training=False, decode=True),
           "long_context": dict(training=False, decode=True,
                                long_context=True)}
CACHE = dict(batch=8, max_seq=64)

REFERENCE = """
import json, sys
import numpy as np
import jax
assert jax.device_count() == 8, jax.devices()
from jax.sharding import PartitionSpec as P
from repro.configs import arch_kind, get_arch
from repro.distributed import sharding as sh

MESHES = json.loads(sys.argv[2])
SERVING = json.loads(sys.argv[3])
CACHE = json.loads(sys.argv[4])

def entry(e):
    return [] if e is None else ([e] if isinstance(e, str) else list(e))

def specs(axes, shapes, rules):
    shard = sh.shard_with_shapes(rules, axes, shapes)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        shard, is_leaf=lambda x: hasattr(x, "spec"))
    out = {}
    for path, s in flat:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = [entry(e) for e in s.spec]
    return out

def family(arch):
    kind = arch_kind(arch)
    cfg = get_arch(arch).smoke_config()
    key = jax.random.PRNGKey(0)
    if kind == "lm":
        from repro.models import transformer as tf
        return kind, tf.param_axes(cfg), jax.eval_shape(
            lambda: tf.init_params(key, cfg)), cfg
    if kind == "gnn":
        from repro.models import gnn
        return kind, gnn.param_axes(cfg), jax.eval_shape(
            lambda: gnn.init_params(key, cfg)), cfg
    from repro.models import recsys as rs
    name = {"dlrm-mlperf": "dlrm"}.get(arch, arch)
    init, axes = getattr(rs, name + "_init"), getattr(rs, name + "_axes")
    return kind, axes(cfg), jax.eval_shape(lambda: init(key, cfg)), cfg

out = {}
for mname, (shape, names) in MESHES.items():
    mesh = jax.make_mesh(tuple(shape), tuple(names))
    for arch in %(archs)r:
        if arch_kind(arch) == "retrieval":
            from repro.serving.engine import index_shard_specs
            from repro.core.types import ClusterIndex
            multi = "pod" in names
            ispecs = index_shard_specs(
                ClusterIndex(**{f: None for f in ClusterIndex.__dataclass_fields__
                                if f not in ("vocab", "n_seg")},
                             vocab=0, n_seg=0), multi)
            out[f"{mname}/{arch}"] = {
                f: [entry(e) for e in getattr(ispecs, f)]
                for f in ClusterIndex.__dataclass_fields__
                if f not in ("vocab", "n_seg")}
            continue
        kind, axes, shapes, cfg = family(arch)
        rules = {"lm": sh.lm_rules, "gnn": sh.gnn_rules,
                 "recsys": sh.recsys_rules}[kind](mesh)
        out[f"{mname}/{arch}"] = specs(axes, shapes, rules)
        if kind == "lm":
            from repro.models import transformer as tf
            cshapes = jax.eval_shape(
                lambda: tf.init_cache(cfg, CACHE["batch"], CACHE["max_seq"]))
            for v, kw in SERVING.items():
                r = sh.lm_rules(mesh, **kw)
                out[f"{mname}/{arch}/{v}"] = specs(tf.param_axes(cfg),
                                                   shapes, r)
                out[f"{mname}/{arch}/{v}/cache"] = specs(tf.cache_axes(),
                                                         cshapes, r)
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory) -> dict:
    """Every leaf's spec from the JAX package, one subprocess."""
    path = tmp_path_factory.mktemp("ref") / "specs.json"
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8")
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run(
        [sys.executable, "-c", REFERENCE % {"archs": ARCHS}, str(path),
         json.dumps(MESHES), json.dumps(SERVING), json.dumps(CACHE)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def meshes():
    """The two meshes over a fake process group of eight ranks."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=8)
    try:
        yield {k: make_host_mesh(shape, names)
               for k, (shape, names) in MESHES.items()}
    finally:
        dist.destroy_process_group()


def _model_and_axes(arch: str):
    """(kind, the smoke model in the reference's layout, its axes tree,
    its config) for a trainable arch."""
    from repro_torch.configs import arch_kind, get_arch
    from repro_torch.convert import reference_view
    kind = arch_kind(arch)
    cfg = get_arch(arch).smoke_config()
    gen = torch.Generator().manual_seed(0)
    if kind == "lm":
        from repro_torch.models import transformer as tf
        model, axes = tf.init_params(gen, cfg, device="cpu"), \
            tf.param_axes(cfg)
    elif kind == "gnn":
        from repro_torch.models import gnn
        model, axes = gnn.init_params(gen, cfg, device="cpu"), \
            gnn.param_axes(cfg)
    else:
        from repro_torch.models.recsys import RECSYS, RECSYS_AXES
        model = RECSYS[arch][0](gen, cfg, device="cpu")
        axes = RECSYS_AXES[arch](cfg)
    return kind, reference_view(model), axes, cfg


def _port_specs(rules, axes, shapes) -> dict:
    """Leaf path -> (per-dim mesh axes, placements) of the port."""
    shard = sh.shard_with_shapes(rules, axes, shapes)
    out: dict = {}

    def walk(node, s, prefix):
        if sh.is_axes_leaf(node):
            ndim = len(tuple(shapes_at(prefix).shape))
            axes_per_dim = [list(sh.entry_axes(e)) for e in s.spec]
            axes_per_dim += [[]] * (ndim - len(axes_per_dim))
            out["/".join(prefix)] = (axes_per_dim, s.placements)
            return
        for k in node:
            walk(node[k], s[k], prefix + [str(k)])

    def shapes_at(prefix):
        node = shapes
        for k in prefix:
            node = node[k]
        return node

    walk(axes, shard, [])
    return out


def _normalise(spec: list, ndim: int) -> list:
    return spec + [[]] * (ndim - len(spec))


def _check(port: dict, ref: dict, mesh, what: str) -> None:
    assert sorted(port) == sorted(ref), what
    for key, (axes_per_dim, pl) in port.items():
        want = _normalise(ref[key], len(axes_per_dim))
        assert axes_per_dim == want, (what, key, axes_per_dim, want)
        assert pl == sh.placements(mesh, [tuple(a) or None for a in want])


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "asc-splade"])
def test_param_placements_match_reference(reference, meshes, arch,
                                          mesh_name):
    """Every parameter leaf names the reference's mesh axes, dim by dim,
    under the family's training rules."""
    mesh = meshes[mesh_name]
    kind, view, axes, _ = _model_and_axes(arch)
    rules = {"lm": sh.lm_rules, "gnn": sh.gnn_rules,
             "recsys": sh.recsys_rules}[kind](mesh)
    _check(_port_specs(rules, axes, view), reference[f"{mesh_name}/{arch}"],
           mesh, f"{mesh_name}/{arch}")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("variant", sorted(SERVING))
def test_lm_serving_rules_match_reference(reference, meshes, variant,
                                          mesh_name):
    """``lm_rules``' serving variants over every LM's parameters and KV
    cache (``cache_axes``)."""
    from repro_torch.models import transformer as tf
    mesh = meshes[mesh_name]
    rules = sh.lm_rules(mesh, **SERVING[variant])
    for arch in ("stablelm-3b", "qwen3-14b", "olmo-1b",
                 "llama4-scout-17b-a16e", "olmoe-1b-7b"):
        _, view, axes, cfg = _model_and_axes(arch)
        key = f"{mesh_name}/{arch}/{variant}"
        _check(_port_specs(rules, axes, view), reference[key], mesh, key)
        cache = tf.init_cache(cfg, CACHE["batch"], CACHE["max_seq"],
                              device="cpu")
        _check(_port_specs(rules, tf.cache_axes(), cache),
               reference[key + "/cache"], mesh, key + "/cache")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_retrieval_rules_match_index_shard_specs(reference, meshes,
                                                 mesh_name):
    """``retrieval_rules`` over the index's logical axes
    (``serving.engine.index_axes``) give the reference's
    ``index_shard_specs`` (``multi_pod`` on the pod mesh)."""
    from repro_torch.serving.engine import index_axes, index_shard_specs
    from repro_torch.tools.golden_world import golden_world
    mesh = meshes[mesh_name]
    index, _ = golden_world("cpu")
    fields = {f: getattr(index, f) for f in index_axes(index)}
    port = _port_specs(sh.retrieval_rules(mesh), index_axes(index), fields)
    _check(port, reference[f"{mesh_name}/asc-splade"], mesh, mesh_name)
    # the port's own leading-axis table agrees
    multi = "pod" in mesh.mesh_dim_names
    for f, lead in index_shard_specs(index, multi).items():
        dims = port[f][0]
        assert tuple(dims[0] if dims else ()) == tuple(lead), f


def test_spec_drops_absent_and_repeated_axes(meshes):
    """``spec`` drops mesh axes the mesh lacks ('pod' on (4, 2)) and a
    mesh axis already used by an earlier dim; ``divisible_spec`` drops
    the innermost axis that does not divide, first."""
    mesh = meshes["data4_model2"]
    rules = sh.lm_rules(mesh)
    assert rules.spec("batch", "seq", "embed") == sh.P(("data",), "model",
                                                       None)
    # 'experts' takes 'model'; 'w_mlp' then finds it used
    assert rules.spec("experts", "w_fsdp", "w_mlp") == sh.P(
        "model", ("data",), None)
    pod = meshes["pod2_data2_model2"]
    g = sh.gnn_rules(pod)
    assert sh.divisible_spec(g, ("nodes", "feat"), (12, 3)) == sh.P(
        ("pod", "data"), None)
    assert sh.divisible_spec(g, ("nodes", "feat"), (6, 3)) == sh.P(
        "pod", None)
    assert sh.divisible_spec(g, ("nodes", "feat"), (7, 3)) == sh.P(
        None, None)
    assert sh.spec_for("batch") == sh.P()
    with sh.use_rules(rules):
        assert sh.current_rules() is rules
        assert sh.spec_for("batch", "vocab") == sh.P(("data",), "model")
        x = torch.ones(2, 3)
        assert sh.constrain(x, "batch", "embed") is x
    assert sh.current_rules() is None
    ms = sh.make_sharding({"a": ("w_fsdp", "w_mlp")}, rules)
    assert ms["a"].spec == sh.P(("data",), "model")


def test_block_splits_in_mesh_order(meshes):
    """A dim split over (pod, data) is pod-major, as
    ``jax.sharding.PartitionSpec(("pod", "data"))`` splits it: the block
    of the fake rank 0 is the first of the four."""
    pod = meshes["pod2_data2_model2"]
    full = torch.arange(16.0).reshape(8, 2)
    pl = sh.placements(pod, sh.P(("pod", "data"), "model"))
    assert torch.equal(par.block(full, pod, pl), full[:2, :1])
