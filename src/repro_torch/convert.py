"""Carry the reference package's state across as numpy arrays.

The retrieval state is the index and the query batch; the model state is
a parameter tree (the sparse encoder's, the LM's) and the optimizer state
beside it. These converters build the port's :class:`ClusterIndex` /
:class:`QueryBatch` from the numpy arrays of the JAX package's
``ClusterIndex`` / ``QueryBatch`` (``np.asarray`` of each field), and the
port's models from the JAX package's parameter trees, so the parity tests
can feed both packages the same state without this package importing JAX.

The reference stacks a model's layers on a leading axis (``jax.vmap`` of
the layer init); the port holds one module a layer. :func:`to_arrays`
turns any tree of the port's (modules, trees with a list of per-layer
dicts, tensors, Python scalars) into the reference's layout, stacking
each list of per-layer dicts leaf by leaf, and :func:`load_arrays` goes
back. ``training/checkpoint.py`` saves and restores through them, in
``jax.tree_util.tree_flatten``'s leaf order, so a checkpoint either
package writes restores in the other. A sharded tree (``DTensor``
leaves, ``distributed/parallelize.py``) goes out as whole tensors (every
rank gathers them, in leaf order) and comes back as each rank's blocks of
the live placements, so a checkpoint from one mesh restores on another
mesh or on one device.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.core.types import INDEX_FIELDS, ClusterIndex, QueryBatch
from repro_torch.device import resolve_device
from repro_torch.training.tree import (leaves, module_tree, structure,
                                       tree_map, unflatten)


def _tensor(a, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C")).to(device)


def index_from_arrays(fields: dict[str, np.ndarray], *, vocab: int,
                      n_seg: int,
                      device: str | torch.device | None = None
                      ) -> ClusterIndex:
    """``fields`` maps each of the 14 ClusterIndex data fields to its
    array; dtypes are kept as given (uint16/int32 tids, uint8 weights)."""
    missing = set(INDEX_FIELDS) - set(fields)
    if missing:
        raise KeyError(f"missing index fields: {sorted(missing)}")
    dev = resolve_device(device)
    return ClusterIndex(**{f: _tensor(fields[f], dev) for f in INDEX_FIELDS},
                        vocab=vocab, n_seg=n_seg)


def queries_from_arrays(tids: np.ndarray, tw: np.ndarray, mask: np.ndarray,
                        *, vocab: int,
                        device: str | torch.device | None = None
                        ) -> QueryBatch:
    dev = resolve_device(device)
    return QueryBatch(tids=_tensor(np.asarray(tids, np.int32), dev),
                      tw=_tensor(np.asarray(tw, np.float32), dev),
                      mask=_tensor(np.asarray(mask, bool), dev),
                      vocab=vocab)


class LayerStack:
    """One leaf of the reference's layout held as the port's per-layer
    tensors: the reference keeps them as one array, layers first."""

    def __init__(self, items):
        self.items = list(items)

    @property
    def shape(self) -> tuple:
        return (len(self.items), *self.items[0].shape)


def reference_view(tree):
    """``tree`` in the reference's layout without copying: each module
    becomes its :func:`module_tree`, each list of per-layer dicts one dict
    of :class:`LayerStack` leaves."""
    if isinstance(tree, nn.Module):
        tree = module_tree(tree)
    if isinstance(tree, dict):
        return {k: reference_view(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [reference_view(v) for v in tree]
        if items and all(isinstance(v, dict) for v in items):
            per_layer = [leaves(v) for v in items]
            return unflatten(structure(items[0]),
                             [LayerStack(col) for col in zip(*per_layer)])
        return type(tree)(items)
    return tree


def host_copy(x) -> np.ndarray:
    """A numpy copy that owns its memory (the caller may go on updating
    the tensor in place); a ``DTensor`` is gathered whole first (a
    collective: every rank calls it)."""
    if isinstance(x, LayerStack):
        return np.stack([host_copy(t) for t in x.items])
    if isinstance(x, torch.Tensor):
        from repro_torch.distributed.parallelize import full
        x = full(x.detach())
        return (x.cpu() if x.device.type != "cpu" else x.clone()).numpy()
    return np.asarray(x)


def to_arrays(tree):
    """``tree`` as numpy arrays in the reference's layout (layers
    stacked)."""
    view = reference_view(tree)
    return unflatten(structure(view), [host_copy(x) for x in leaves(view)])


def _like(a, live: torch.Tensor) -> torch.Tensor:
    """``a`` on ``live``'s device and dtype, as this rank's block of
    ``live``'s placements if it is a ``DTensor``."""
    from repro_torch.distributed.parallelize import like
    return like(torch.from_numpy(np.array(a, order="C")).to(
        device=live.device, dtype=live.dtype), live)


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def load_arrays(arrays, live):
    """``arrays`` (the reference's layout, as :func:`to_arrays` gives it)
    into ``live``'s structure: a module's parameters are overwritten in
    place and the module returned; tensors come back as new tensors on
    the live ones' devices and dtypes; other leaves as the arrays."""
    if isinstance(live, nn.Module):
        with torch.no_grad():
            for x, a in zip(leaves(reference_view(live)), leaves(arrays),
                            strict=True):
                for i, t in (enumerate(x.items) if isinstance(x, LayerStack)
                             else [(None, x)]):
                    _local(t).copy_(_local(_like(a if i is None else a[i],
                                                 t)))
        return live
    if isinstance(live, dict):
        return {k: load_arrays(arrays[k], v) for k, v in live.items()}
    if isinstance(live, (list, tuple)):
        if live and all(isinstance(v, dict) for v in live):
            return type(live)(load_arrays(tree_map(lambda a: a[i], arrays), v)
                              for i, v in enumerate(live))
        return type(live)(load_arrays(a, v) for a, v in zip(arrays, live))
    if isinstance(live, torch.Tensor):
        return _like(arrays, live)
    return arrays


# the inverses of encoder_params_from_arrays and lm_params_from_arrays:
# both models keep their layers under "layers", so one function serves
# (to_arrays stacks any list of per-layer trees: the recsys and GNN
# models' too)
encoder_params_to_arrays = lm_params_to_arrays = to_arrays


def _tensors(tree):
    """The reference's tree as float32 CPU tensors."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32, order="C"))


def _unstacked(tree: dict, n_layers: int, key: str = "layers") -> dict:
    """The reference's tree as float32 CPU tensors, its stacked ``key``
    subtree split into a list of ``n_layers`` per-layer trees."""
    params = _tensors(tree)
    stacked = params[key]
    n_stacked = leaves(stacked)[0].shape[0]
    if n_stacked != n_layers:
        raise ValueError(f"the tree stacks {n_stacked} layers, the config "
                         f"has {n_layers}")
    params[key] = [tree_map(lambda a: a[i].clone(), stacked)
                   for i in range(n_layers)]
    return params


def encoder_params_from_arrays(tree: dict, cfg,
                               device: str | torch.device | None = None):
    """The port's ``SparseEncoder`` from the JAX package's encoder
    parameters as numpy arrays (``jax.tree_util.tree_map(np.asarray,
    params)``): the same names and layouts, with the ``jax.vmap``-stacked
    leading layer axis of ``tree["layers"]`` unstacked into one module a
    layer."""
    from repro_torch.models.sparse_encoder import SparseEncoder
    return SparseEncoder(cfg, _unstacked(tree, cfg.n_layers)).to(
        resolve_device(device))


def lm_params_from_arrays(tree: dict, cfg,
                          device: str | torch.device | None = None):
    """The port's ``TransformerLM`` from the JAX package's LM parameters
    as numpy arrays, layers unstacked as for the encoder."""
    from repro_torch.models.transformer import TransformerLM
    return TransformerLM(cfg, _unstacked(tree, cfg.n_layers)).to(
        resolve_device(device))


def recsys_params_from_arrays(tree: dict, arch: str, cfg,
                              device: str | torch.device | None = None):
    """The port's recsys model (a ``TreeModel``) for ``arch`` (one of
    ``dlrm-mlperf``, ``din``, ``deepfm``, ``bert4rec``) from the JAX
    package's parameters as numpy arrays; BERT4Rec's stacked ``blocks``
    are unstacked into one module a block."""
    from repro_torch.models.recsys import RECSYS
    if arch not in RECSYS:
        raise KeyError(f"{arch!r} is not a recsys arch: {sorted(RECSYS)}")
    from repro_torch.models.layers import TreeModel
    params = (_unstacked(tree, cfg.n_blocks, "blocks") if arch == "bert4rec"
              else _tensors(tree))
    return TreeModel(cfg, params).to(resolve_device(device))


def gnn_params_from_arrays(tree: dict, cfg,
                           device: str | torch.device | None = None):
    """The port's MeshGraphNet (a ``TreeModel``) from the JAX package's
    GNN parameters as numpy arrays, the processor layers unstacked."""
    from repro_torch.models.layers import TreeModel
    return TreeModel(cfg, _unstacked(tree, cfg.n_layers)).to(
        resolve_device(device))
