"""qwen3-14b [dense] 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936 — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]."""

from repro_torch.models.transformer import LMConfig

KIND = "lm"


def config() -> LMConfig:
    return LMConfig(
        name="qwen3-14b", n_layers=40, d_model=5120, n_heads=40,
        n_kv_heads=8, d_ff=17408, vocab=151936, norm="rms", qk_norm=True,
        act="swiglu", rope_theta=1e6, dtype="bfloat16", d_head=128)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="qwen3-14b-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, d_ff=176, vocab=256, norm="rms", qk_norm=True,
        act="swiglu", rope_theta=1e6, dtype="float32", d_head=16,
        attn_chunk=16)
