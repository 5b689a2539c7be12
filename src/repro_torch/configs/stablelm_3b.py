"""stablelm-3b [dense] 32L d_model=2560 32H (GQA kv=32) d_ff=6912
vocab=50304 — [hf:stabilityai/stablelm-2-1_6b; unverified]."""

from repro_torch.models.transformer import LMConfig

KIND = "lm"


def config() -> LMConfig:
    return LMConfig(
        name="stablelm-3b", n_layers=32, d_model=2560, n_heads=32,
        n_kv_heads=32, d_ff=6912, vocab=50304, norm="ln", act="swiglu",
        rope_theta=1e4, dtype="bfloat16")


def smoke_config() -> LMConfig:
    return LMConfig(
        name="stablelm-3b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=176, vocab=256, norm="ln", act="swiglu",
        rope_theta=1e4, dtype="float32", attn_chunk=16)
