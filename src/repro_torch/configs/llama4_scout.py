"""llama4-scout-17b-a16e [moe] 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16e top-1 — MoE + shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

The modality frontend of Llama-4's early fusion is a stub, as in the
reference: the backbone here is the full MoE transformer over token
embeddings."""

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

KIND = "lm"


def config() -> LMConfig:
    return LMConfig(
        name="llama4-scout-17b-a16e", n_layers=48, d_model=5120,
        n_heads=40, n_kv_heads=8, d_ff=8192, vocab=202048, norm="rms",
        act="swiglu", rope_theta=5e5, dtype="bfloat16", d_head=128,
        moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192, n_shared=1))


def smoke_config() -> LMConfig:
    return LMConfig(
        name="llama4-scout-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, d_ff=128, vocab=256, norm="rms", act="swiglu",
        rope_theta=5e5, dtype="float32", d_head=16, attn_chunk=16,
        moe=MoEConfig(n_experts=4, top_k=1, d_ff_expert=128, n_shared=1))
