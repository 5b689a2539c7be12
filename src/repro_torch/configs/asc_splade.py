"""The paper's own architecture: ASC retrieval over a SPLADE-scale
cluster-skipping index (MS MARCO geometry: 8.8M passages, 30522-dim
WordPiece vocab, 4096 clusters x 8 segments — paper §3.2/§4)."""

import dataclasses

KIND = "retrieval"


@dataclasses.dataclass(frozen=True)
class ASCIndexConfig:
    name: str = "asc-splade"
    n_docs: int = 8_800_000
    vocab: int = 30522
    m: int = 4096                 # clusters
    n_seg: int = 8                # segments per cluster
    # padded docs/cluster: mean is 8.8M/4096 = 2148; 2560 = 1.19x overcap
    # (balanced_assign caps at capacity, so it suffices) — was 3072
    # (1.43x), whose padding inflated every admitted cluster's scoring
    # reads by ~20% (EXPERIMENTS.md asc iteration 2)
    d_pad: int = 2560
    t_pad: int = 128              # padded terms per doc (SPLADE ~67 mean)
    q_pad: int = 32               # padded query terms (SPLADE dev >23 mean)
    k: int = 10
    mu: float = 0.9
    eta: float = 1.0
    group_size: int = 32


def config() -> ASCIndexConfig:
    return ASCIndexConfig()


def smoke_config() -> ASCIndexConfig:
    return ASCIndexConfig(
        name="asc-splade-smoke", n_docs=2048, vocab=512, m=32, n_seg=4,
        d_pad=128, t_pad=32, q_pad=12, k=10, group_size=8)
