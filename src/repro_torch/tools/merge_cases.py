"""Cases of the wave's merge (``kernels/merge_topk``), made with numpy from
fixed seeds.

Each case is one wave's merge inputs: the running (n_q, k) top-k (scores
and ids), the wave's (n_q, G, d_pad) scores, theta (n_q,) and the wave's
(G * d_pad,) ids. Together they reach what the order depends on: ties
inside the wave and with the running top-k, +0.0 beside -0.0, rows with
fewer than k survivors, all-NEG rows, the first wave (theta and the
running top-k at NEG), a later wave (a full running top-k near the top of
the scores, so few pass theta), a wave narrower than k, and a row width
that is not a multiple of four (the kernel's scalar loads).

The CPU tests hold the plain version to a numpy oracle on these cases; the
``gpu`` tests and ``chip_smoke.py`` hold the kernel to the plain version
on them.
"""

from __future__ import annotations

import numpy as np
import torch

NEG = np.finfo(np.float32).min

CASES = ("random", "steady", "quantiles", "ties", "signed_zero", "all_neg",
         "first_wave", "narrow", "unaligned")
KS = (1, 10, 100)
N_QS = (1, 64, 256)
# (G, d_pad) of a case: the narrow wave holds fewer scores than most k
WIDTH = {"narrow": (1, 3), "unaligned": (3, 33)}
DEFAULT_WIDTH = (4, 100)


def _running(rng, n_q: int, k: int, values) -> tuple[np.ndarray, np.ndarray]:
    """A running top-k: each row's first r entries drawn from ``values``
    (sorted descending, distinct ids), the rest NEG with id -1."""
    top = np.full((n_q, k), NEG, np.float32)
    ids = np.full((n_q, k), -1, np.int32)
    for q in range(n_q):
        r = int(rng.integers(0, k + 1))
        top[q, :r] = np.sort(values(r))[::-1]
        ids[q, :r] = rng.choice(10 ** 6, r, replace=False) + 10 ** 6
    return top, ids


def merge_case(name: str, n_q: int, k: int, seed: int = 0,
               width: tuple[int, int] | None = None) -> dict:
    """One case as numpy arrays: top_scores, top_ids, scores, theta,
    ids_flat. ``width`` overrides the case's (G, d_pad)."""
    rng = np.random.default_rng([seed, CASES.index(name), n_q, k])
    G, d_pad = width or WIDTH.get(name, DEFAULT_WIDTH)
    shape = (n_q, G, d_pad)
    ids_flat = rng.permutation(G * d_pad).astype(np.int32)

    def uniform(n):
        return rng.uniform(0.0, 10.0, n).astype(np.float32)

    def pick(choices, n, p=None):
        return rng.choice(np.asarray(choices, np.float32), n, p=p)

    if name == "ties":
        scores = pick([NEG, 1.0, 2.0, 3.0], shape, [0.4, 0.2, 0.2, 0.2])
        top, tids = _running(rng, n_q, k, lambda r: pick([1.0, 2.0, 3.0], r))
        theta = pick([NEG, 1.0, 2.0], n_q)
    elif name == "signed_zero":
        scores = pick([NEG, 0.0, -0.0, 1.0], shape, [0.2, 0.35, 0.35, 0.1])
        top, tids = _running(rng, n_q, k,
                             lambda r: pick([0.0, -0.0, 1.0], r))
        theta = pick([NEG, -1.0], n_q)
    elif name == "all_neg":
        scores = np.full(shape, NEG, np.float32)
        top, tids = _running(rng, n_q, k, uniform)
        theta = top[:, k - 1].copy()
    elif name == "steady":
        scores = np.where(rng.random(shape) < 0.6, uniform(shape),
                          NEG).astype(np.float32)
        top = np.sort(rng.uniform(9.9, 10.0, (n_q, k)).astype(np.float32),
                      axis=1)[:, ::-1].copy()
        tids = rng.choice(10 ** 6, (n_q, k), replace=False).astype(np.int32)
        theta = top[:, k - 1].copy()
    elif name == "first_wave":
        scores = np.where(rng.random(shape) < 0.5, uniform(shape),
                          NEG).astype(np.float32)
        top = np.full((n_q, k), NEG, np.float32)
        tids = np.full((n_q, k), -1, np.int32)
        theta = np.full(n_q, NEG, np.float32)
    else:
        scores = np.where(rng.random(shape) < 0.6, uniform(shape),
                          NEG).astype(np.float32)
        top, tids = _running(rng, n_q, k, uniform)
        theta = top[:, k - 1].copy()
        if name == "quantiles":
            # theta at a quantile of the row's scores, whatever the running
            # top-k holds: from every score a candidate to none
            qs = np.array([0.0, 0.5, 0.9, 0.99, 0.999, 1.0])[np.arange(n_q)
                                                             % 6]
            flat = scores.reshape(n_q, -1)
            theta = np.array([np.quantile(flat[q], qs[q], method="lower")
                              for q in range(n_q)], np.float32)
    return dict(top_scores=top, top_ids=tids, scores=scores.astype(np.float32),
                theta=theta.astype(np.float32), ids_flat=ids_flat)


def case_args(case: dict, device, k: int) -> tuple:
    """The case as ``_merge_wave``'s arguments on ``device``; theta is the
    strided column view the walks pass where it is the running k-th."""
    t = {n: torch.from_numpy(np.ascontiguousarray(v)).to(device)
         for n, v in case.items()}
    theta = t["theta"]
    if torch.equal(theta, t["top_scores"][:, k - 1]):
        theta = t["top_scores"][:, k - 1]
    return (t["top_scores"], t["top_ids"], t["scores"], theta,
            t["ids_flat"], k)
