"""Fault-tolerant checkpointing (PyTorch port of
``repro/training/checkpoint.py``).

Guarantees, as the reference's:
  * atomicity — write to ``<dir>/tmp.<step>.<pid>``, then rename to
    ``step_<n>``; a crash mid-save never corrupts the latest checkpoint;
  * async — saves run on a background thread off the training critical
    path (the tensors are copied to host memory first);
  * rotation — the ``max_to_keep`` newest checkpoints are retained;
  * restore onto the live state — arrays are stored host-global
    (``arrays.npz`` with ``a0..aN`` and ``manifest.json``); ``cast_like``
    puts them on the live tensors' devices and dtypes, and reshards them
    onto the live placements of a sharded tree.

A sharded tree (``DTensor`` leaves) is saved by every rank of its mesh:
each gathers the whole tensors, in leaf order, and rank 0 alone writes
them (``fit`` then waits for every rank on a barrier).

The on-disk format and leaf order are the reference's: a tree is saved in
its reference layout (``convert.to_arrays``: a module as its parameter
tree, layers stacked) and flattened in ``jax.tree_util.tree_flatten``'s
order (dict keys sorted). A directory either package's ``fit`` wrote
restores in the other.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np

from repro_torch.convert import (LayerStack, host_copy, load_arrays,
                                 reference_view)
from repro_torch.training.tree import leaves, structure, unflatten


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _sharded(flat) -> bool:
    from torch.distributed.tensor import DTensor
    return any(isinstance(t, DTensor)
               for x in flat
               for t in (x.items if isinstance(x, LayerStack) else [x]))


def _load_flat(d: str) -> list[np.ndarray]:
    with np.load(os.path.join(d, "arrays.npz")) as z:
        return [z[f"a{i}"] for i in range(len(z.files))]


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.dir = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._last_treedef = None

    # -- paths ------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    # -- save -------------------------------------------------------------
    def save(self, step: int, tree, async_save: bool = False) -> None:
        # copy to host synchronously (the caller goes on updating the
        # live tensors), then optionally write on a background thread
        view = reference_view(tree)
        flat = leaves(view)
        treedef = structure(view)
        if _sharded(flat) and _rank() != 0:
            # the gathers are collectives: take part, keep nothing
            from repro_torch.distributed.parallelize import full
            for x in flat:
                for t in (x.items if isinstance(x, LayerStack) else [x]):
                    full(t)
            self._last_treedef = treedef
            return
        host = [host_copy(x) for x in flat]

        def write():
            tmp = os.path.join(self.dir, f"tmp.{step}.{os.getpid()}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"),
                     **{f"a{i}": a for i, a in enumerate(host)})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump({"step": step, "n_arrays": len(host),
                           "treedef": repr(treedef),
                           "time": time.time()}, f)
            final = self._step_dir(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._rotate()

        self.wait()
        if async_save:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
        # keep the structure for a restore of the same tree
        self._last_treedef = treedef

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _rotate(self) -> None:
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.max_to_keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore ----------------------------------------------------------
    def restore(self, step: int, treedef=None):
        """The arrays of ``step`` in ``treedef``'s structure (default: the
        last saved tree's), in the reference's layout."""
        flat = _load_flat(self._step_dir(step))
        treedef = treedef or self._last_treedef
        if treedef is None:
            raise ValueError(
                "restore needs a treedef (pass one, or restore into a "
                "template with restore_into)")
        return unflatten(treedef, flat)

    def restore_into(self, step: int, template):
        """Restore using the *template's* structure."""
        return self.restore(step, structure(reference_view(template)))

    def restore_latest(self, template=None):
        steps = self.steps()
        if not steps:
            return None
        d = self._step_dir(steps[-1])
        flat = _load_flat(d)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        if template is not None:
            return unflatten(structure(reference_view(template)), flat)
        # structure-free latest: callers use cast_like against live trees
        return {"step": manifest["step"], "_flat": flat}

    @staticmethod
    def cast_like(restored, live):
        """Restored host arrays onto the live tree: a module's parameters
        are overwritten in place, tensors land on the live ones' devices
        and dtypes (a checkpoint written on any device restores onto
        any other)."""
        if isinstance(restored, dict) and "_flat" in restored:
            treedef = structure(reference_view(live))
            n = len(leaves(treedef))
            restored = unflatten(treedef, restored["_flat"][:n])
        return load_arrays(restored, live)
