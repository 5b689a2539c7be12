"""din [recsys] embed_dim=18 seq_len=100 attn_mlp=80-40 mlp=200-80
interaction=target-attn — [arXiv:1706.06978; paper]."""

from repro_torch.models.recsys import DINConfig

KIND = "recsys"


def config() -> DINConfig:
    return DINConfig(
        name="din", embed_dim=18, seq_len=100, attn_mlp=(80, 40),
        mlp=(200, 80), n_items=1_000_000, n_cates=10_000)


def smoke_config() -> DINConfig:
    return DINConfig(
        name="din-smoke", embed_dim=8, seq_len=20, attn_mlp=(16, 8),
        mlp=(32, 16), n_items=1000, n_cates=50)
