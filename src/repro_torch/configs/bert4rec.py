"""bert4rec [recsys] embed_dim=64 n_blocks=2 n_heads=2 seq_len=200
interaction=bidir-seq — [arXiv:1904.06690; paper]. Catalog sized to the
retrieval_cand shape (10^6 items); masked-item training uses sampled
softmax at this catalog size."""

from repro_torch.models.recsys import Bert4RecConfig

KIND = "recsys"


def config() -> Bert4RecConfig:
    return Bert4RecConfig(
        name="bert4rec", n_items=1_000_000, embed_dim=64, n_blocks=2,
        n_heads=2, seq_len=200, n_negatives=1024)


def smoke_config() -> Bert4RecConfig:
    return Bert4RecConfig(
        name="bert4rec-smoke", n_items=500, embed_dim=16, n_blocks=2,
        n_heads=2, seq_len=20, n_negatives=32)
