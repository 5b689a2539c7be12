"""Carry the reference package's state across as numpy arrays.

The retrieval state is the index and the query batch; the model state is
the sparse encoder's parameters. These converters build the port's
:class:`ClusterIndex` / :class:`QueryBatch` from the numpy arrays of the
JAX package's ``ClusterIndex`` / ``QueryBatch`` (``np.asarray`` of each
field), and the port's :class:`SparseEncoder` from the JAX package's
encoder parameter tree, so the parity tests can feed both packages the
same state without this package importing JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import INDEX_FIELDS, ClusterIndex, QueryBatch
from repro_torch.device import resolve_device


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


def encoder_params_from_arrays(tree: dict, cfg,
                               device: str | torch.device | None = None):
    """The port's ``SparseEncoder`` from the JAX package's encoder
    parameters as numpy arrays (``jax.tree_util.tree_map(np.asarray,
    params)``): the same names and layouts, with the ``jax.vmap``-stacked
    leading layer axis of ``tree["layers"]`` unstacked into one module a
    layer."""
    from repro_torch.models.sparse_encoder import SparseEncoder

    def tensors(node):
        if isinstance(node, dict):
            return {k: tensors(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, dtype=np.float32,
                                         order="C"))

    params = tensors(tree)
    stacked = params["layers"]
    n_stacked = stacked["ln1"]["scale"].shape[0]
    if n_stacked != cfg.n_layers:
        raise ValueError(f"the tree stacks {n_stacked} layers, the config "
                         f"has {cfg.n_layers}")

    def layer(i, node):
        return ({k: layer(i, v) for k, v in node.items()}
                if isinstance(node, dict) else node[i].clone())

    params["layers"] = [layer(i, stacked) for i in range(cfg.n_layers)]
    return SparseEncoder(cfg, params).to(resolve_device(device))
