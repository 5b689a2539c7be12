"""The port's dry-run cells (``repro_torch.launch.cells``) and production
mesh held against the JAX package's.

Tables, ``all_cells``, ``shapes_for`` and ``layer_count`` must be the
reference's. For the 40 cells the reference can build (its retrieval
cells raise: ``_build_retrieval`` predates the index's superblock
fields), each cell's mode, every argument leaf's shape and dtype and its
MODEL_FLOPS (relative 1e-12) must match the reference's ``build_cell`` on
a (1, 1) host mesh; the port builds on the meta device as the one rank of
a fake process group, where rank 0's blocks are the global shapes.
Parameters and optimizer state are compared in the reference's stacked
layout (``convert.reference_view``). ``make_production_mesh`` must put
rank r at the coordinate ``jax.make_mesh`` gives device r, read from a
subprocess with 512 host devices.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch
from torch import nn

import repro.launch.cells as ref_cells
from repro.launch.mesh import make_host_mesh as ref_host_mesh
from repro_torch.convert import LayerStack, reference_view
from repro_torch.launch import cells
from repro_torch.launch.mesh import (fake_world, make_host_mesh,
                                     make_production_mesh)

ROOT = Path(__file__).resolve().parents[1]


def test_tables_and_cell_list_are_the_references():
    for name in ("LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES",
                 "RETRIEVAL_SHAPES"):
        assert getattr(cells, name) == getattr(ref_cells, name), name
    assert cells.SHAPES_BY_KIND == ref_cells.SHAPES_BY_KIND
    assert cells.all_cells() == ref_cells.all_cells()
    assert len(cells.all_cells()) == 42
    for arch, _ in cells.all_cells():
        assert cells.shapes_for(arch) == ref_cells.shapes_for(arch)
        assert cells.layer_count(arch) == ref_cells.layer_count(arch)
    for spec in cells.GNN_SHAPES.values():
        assert cells._gnn_geometry(spec) == ref_cells._gnn_geometry(spec)
    assert cells._mlp_flops([13, 512, 256, 128]) == \
        ref_cells._mlp_flops([13, 512, 256, 128])


# ---------------------------------------------------------------------------
# every argument leaf against the reference's build_cell
# ---------------------------------------------------------------------------

def _dtype(dt) -> str:
    return str(dt).replace("torch.", "")


def _ref_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): (tuple(x.shape), _dtype(x.dtype))
            for path, x in flat}


def _port_leaves(tree) -> dict:
    out = {}

    def walk(x, path):
        if isinstance(x, nn.Module):
            x = reference_view(x)
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, path + (str(k),))
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, path + (str(i),))
        elif isinstance(x, LayerStack):
            out["/".join(path)] = (tuple(x.shape), _dtype(x.items[0].dtype))
        elif isinstance(x, torch.Tensor):
            out["/".join(path)] = (tuple(x.shape), _dtype(x.dtype))
    walk(reference_view(tree) if isinstance(tree, (dict, list)) else tree,
         ())
    return out


@pytest.fixture(scope="module")
def ref_mesh():
    return ref_host_mesh((1, 1))


@pytest.fixture
def port_mesh():
    with fake_world(1):
        yield make_host_mesh((1, 1))


_REF_CELLS = [c for c in cells.all_cells() if c[0] != "asc-splade"]


@pytest.mark.parametrize("arch,shape", _REF_CELLS)
def test_cell_arguments_and_flops_match_reference(arch, shape, ref_mesh,
                                                  port_mesh):
    ref = ref_cells.build_cell(arch, shape, ref_mesh, False)
    plan = cells.build_cell(arch, shape, port_mesh, False)
    assert plan.mode == ref.mode
    assert math.isclose(plan.model_flops, ref.model_flops, rel_tol=1e-12)
    prog = plan.build("meta")
    ref_args = list(ref.args)
    port_args = list(prog.args)
    if plan.mode == "train":
        # the step number: the reference's int32 scalar, the port's int
        assert ref_args.pop().shape == () and port_args.pop() == 0
    assert len(port_args) == len(ref_args)
    for i, (p, r) in enumerate(zip(port_args, ref_args)):
        assert _port_leaves(p) == _ref_leaves(r), (arch, shape, i)


def test_retrieval_cells_flops_are_the_references_formula(port_mesh):
    from repro.configs import get_arch as ref_arch
    icfg = ref_arch("asc-splade").config()
    for shape, spec in ref_cells.RETRIEVAL_SHAPES.items():
        B = spec["batch"]
        want = B * (2.0 * icfg.m * icfg.n_seg * icfg.q_pad
                    + 2.0 * icfg.n_docs * icfg.t_pad)
        plan = cells.build_cell("asc-splade", shape, port_mesh, False)
        assert plan.mode == "retrieve"
        assert math.isclose(plan.model_flops, want, rel_tol=1e-12)
        # the reference's own builder predates the superblock fields
        with pytest.raises(TypeError, match="super"):
            ref_cells.build_cell("asc-splade", shape, ref_host_mesh((1, 1)))


# ---------------------------------------------------------------------------
# the production meshes
# ---------------------------------------------------------------------------

REF_MESH = """
import json
from repro.launch.mesh import make_production_mesh
out = {}
for multi in (False, True):
    m = make_production_mesh(multi_pod=multi)
    out[str(multi)] = {"shape": list(m.devices.shape),
                       "names": list(m.axis_names),
                       "ids": [d.id for d in m.devices.flat]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_production_meshes():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", REF_MESH], env=env,
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("multi", [False, True])
def test_production_mesh_matches_reference(multi, ref_production_meshes):
    ref = ref_production_meshes[str(multi)]
    n = 512 if multi else 256
    with fake_world(n):
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        assert list(mesh.shape) == ref["shape"]
        assert list(mesh.mesh_dim_names) == ref["names"]
        # device id at each coordinate, row-major: the mesh's rank there
        assert mesh.mesh.flatten().tolist() == ref["ids"]
        assert list(mesh.get_coordinate()) == [0] * mesh.ndim
    ids = torch.tensor(ref["ids"]).reshape(ref["shape"])
    for r in (1, 17, 255, n - 1):
        with fake_world(n, rank=r):
            mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
            want = [int(c) for c in (ids == r).nonzero()[0]]
            assert list(mesh.get_coordinate()) == want, r
