"""olmoe-1b-7b [moe] 16L d_model=2048 16H (GQA kv=16) d_ff=1024
vocab=50304, MoE 64e top-8 — [arXiv:2409.02060; hf]."""

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

KIND = "lm"


def config() -> LMConfig:
    return LMConfig(
        name="olmoe-1b-7b", n_layers=16, d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=1024, vocab=50304, norm="rms", qk_norm=True,
        act="swiglu", rope_theta=1e4, dtype="bfloat16",
        moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024))


def smoke_config() -> LMConfig:
    return LMConfig(
        name="olmoe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=64, vocab=256, norm="rms", qk_norm=True,
        act="swiglu", rope_theta=1e4, dtype="float32", attn_chunk=16,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64))
