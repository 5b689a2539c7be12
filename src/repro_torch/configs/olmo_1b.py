"""olmo-1b [dense] 16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304
— non-parametric LN [arXiv:2402.00838; hf]."""

from repro_torch.models.transformer import LMConfig

KIND = "lm"


def config() -> LMConfig:
    return LMConfig(
        name="olmo-1b", n_layers=16, d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=8192, vocab=50304, norm="nonparam_ln",
        act="swiglu", rope_theta=1e4, dtype="bfloat16",
        tie_embeddings=True)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="olmo-1b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=256, vocab=256, norm="nonparam_ln",
        act="swiglu", rope_theta=1e4, dtype="float32",
        tie_embeddings=True, attn_chunk=16)
