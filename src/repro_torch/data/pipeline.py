"""Deterministic synthetic batch generators (PyTorch port of the LM part
of ``repro/data/pipeline.py``).

Every generator is a pure function of (spec, step): any process can
(re)produce batch ``step`` after a restart with no pipeline state to
checkpoint beyond the step counter. The draws come from a CPU
``torch.Generator`` seeded from ``(seed, step)``; they are not
``jax.random``'s numbers, the distributions are the same. The graph and
recsys batch makers come with their model families.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def step_generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator seeded from ``(seed, step)`` (numpy's SeedSequence
    mixes the pair, so nearby steps draw unrelated streams)."""
    mixed = np.random.SeedSequence([seed, step]).generate_state(2,
                                                                np.uint32)
    return torch.Generator().manual_seed(int(mixed[0]) << 32
                                         | int(mixed[1]))


# ---------------------------------------------------------------------------
# LM token batches (uniform stream with induced bigram structure so the
# loss has signal to descend)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LMDataSpec:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0


def lm_batch(spec: LMDataSpec, step: int) -> dict:
    """tokens and labels (batch, seq_len) int64, mask (batch, seq_len - 1)
    float32 (the reference's shapes), on the CPU."""
    g = step_generator(spec.seed, step)
    base = torch.randint(0, spec.vocab, (spec.batch, spec.seq_len + 1),
                         generator=g)
    # markov-ish stream: next token = f(prev) or noise -> learnable
    shifted = (base[:, :-1] * 31 + 7) % spec.vocab
    use_rule = torch.rand((spec.batch, spec.seq_len), generator=g) < 0.5
    toks = torch.where(use_rule, shifted, base[:, 1:])
    tokens = torch.cat([base[:, :1], toks], dim=1)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
            "mask": torch.ones((spec.batch, spec.seq_len - 1),
                               dtype=torch.float32)}
