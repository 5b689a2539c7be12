"""deepfm [recsys] n_sparse=39 embed_dim=10 mlp=400-400-400
interaction=fm — [arXiv:1703.04247; paper]."""

from repro_torch.models.recsys import DeepFMConfig

KIND = "recsys"


def config() -> DeepFMConfig:
    return DeepFMConfig(
        name="deepfm", n_fields=39, embed_dim=10,
        vocab_per_field=1_000_000, mlp=(400, 400, 400))


def smoke_config() -> DeepFMConfig:
    return DeepFMConfig(
        name="deepfm-smoke", n_fields=39, embed_dim=4,
        vocab_per_field=500, mlp=(32, 32))
