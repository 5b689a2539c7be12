"""SPLADE-like learned sparse encoder, forward pass (PyTorch port of
``repro/models/sparse_encoder.py``).

A bidirectional transformer encoder with a tied MLM head; the sparse
document/query representation is ``max over live positions of
log1p(relu(mlm_logits))`` (SPLADE's activation). The same pass emits the
max-pooled dense token embeddings the paper clusters with ("Dense-SPLADE-
Max"), so one encoder feeds both the inverted index and k-means.

The encoder is a tree of ``nn.Module``s whose parameters keep the
reference's names and layouts (``convert.encoder_params_from_arrays``
carries a JAX parameter tree across). The MLM head ``x @ embed.T`` is a
plain large product, left to ``torch.matmul`` as the reference leaves it
to XLA; run it in fp32 with TF32 off for the card to agree with the CPU.
Training (the optimizer and the fault-tolerant loop) is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.core.search import topk_stable
from repro_torch.core.types import SparseDocs
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_mlp, apply_norm, mlp_init,
                                       norm_init, truncated_normal_init)

DEAD = -1e30          # dense_max at positions the mask leaves out


@dataclasses.dataclass(frozen=True)
class SparseEncConfig:
    name: str = "splade-encoder"
    vocab: int = 30522
    d_model: int = 256
    n_layers: int = 4
    n_heads: int = 4
    d_ff: int = 1024
    max_seq: int = 128
    flops_reg: float = 1e-3
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _params(tree: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in tree.items()})


class EncoderLayer(nn.Module):
    """Pre-norm block: LN -> bidirectional attention -> residual, LN ->
    GELU MLP -> residual."""

    def __init__(self, p: dict):
        super().__init__()
        self.ln1, self.ln2 = _params(p["ln1"]), _params(p["ln2"])
        self.attn, self.mlp = _params(p["attn"]), _params(p["mlp"])

    def forward(self, x: torch.Tensor, chunk: int) -> torch.Tensor:
        h = apply_norm(self.ln1, x, "ln")
        x = x + attn.attend_train(self.attn, h, qk_norm=False,
                                  rope_theta=1e4, chunk=chunk, causal=False)
        h = apply_norm(self.ln2, x, "ln")
        return x + apply_mlp(self.mlp, h, "gelu")


class SparseEncoder(nn.Module):
    """The encoder; ``params`` is the reference's tree with the layer
    axis unstacked into a list of per-layer trees."""

    def __init__(self, cfg: SparseEncConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(params["embed"])
        self.layers = nn.ModuleList(EncoderLayer(p)
                                    for p in params["layers"])
        self.final_ln = _params(params["final_ln"])
        self.mlm_bias = nn.Parameter(params["mlm_bias"])

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor) -> dict:
        x = self.embed[tokens]
        for layer in self.layers:
            x = layer(x, self.cfg.max_seq)
        x = apply_norm(self.final_ln, x, "ln")
        logits = x @ self.embed.T + self.mlm_bias               # (B, S, V)
        act = torch.log1p(torch.relu(logits))
        live = mask[..., None]
        sparse = torch.where(live, act, 0.0).amax(dim=1)         # (B, V)
        dense_max = torch.where(live, x, DEAD).amax(dim=1)       # (B, D)
        return {"sparse": sparse, "dense_max": dense_max, "token_emb": x}


def init_params(gen: torch.Generator, cfg: SparseEncConfig,
                device: str | torch.device | None = None) -> SparseEncoder:
    """Random init at the reference's scales, drawn on the CPU from
    ``gen`` and moved to ``device`` (None: the CUDA card)."""
    dev = resolve_device(device)
    layers = [{"ln1": norm_init("ln", cfg.d_model),
               "ln2": norm_init("ln", cfg.d_model),
               "attn": attn.attn_init(gen, cfg.d_model, cfg.n_heads,
                                      cfg.n_heads, cfg.head_dim, False),
               "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, "gelu")}
              for _ in range(cfg.n_layers)]
    return SparseEncoder(cfg, {
        "embed": truncated_normal_init(gen, (cfg.vocab, cfg.d_model), 1.0),
        "layers": layers,
        "final_ln": norm_init("ln", cfg.d_model),
        "mlm_bias": torch.zeros((cfg.vocab,), dtype=torch.float32),
    }).to(dev)


def encode(model: SparseEncoder, tokens: torch.Tensor,
           mask: torch.Tensor) -> dict:
    """tokens/mask (B, S) -> {sparse (B, V), dense_max (B, D),
    token_emb (B, S, D)} on the model's device."""
    return model(tokens.to(model.device), mask.to(model.device))


def contrastive_loss(model: SparseEncoder, batch: dict) -> torch.Tensor:
    """In-batch InfoNCE + FLOPS regularizer (the forward value). batch:
    q_tokens/q_mask (B, S), d_tokens/d_mask (B, S); doc i is the positive
    of query i."""
    q = encode(model, batch["q_tokens"], batch["q_mask"])["sparse"]
    d = encode(model, batch["d_tokens"], batch["d_mask"])["sparse"]
    scores = q @ d.T                                          # (B, B)
    labels = torch.arange(q.shape[0], device=q.device)
    nll = torch.logsumexp(scores, -1) - scores.gather(
        1, labels[:, None])[:, 0]
    flops = torch.sum(torch.mean(q, dim=0) ** 2) + torch.sum(
        torch.mean(d, dim=0) ** 2)
    return torch.mean(nll) + model.cfg.flops_reg * flops


def to_sparse_docs(sparse_mat: torch.Tensor, t_pad: int,
                   vocab: int) -> SparseDocs:
    """Dense (B, V) activations -> padded SparseDocs of each row's top
    ``t_pad`` terms, the lower id first on ties (``jax.lax.top_k``'s
    order); slots past a row's nonzeros are masked."""
    w, ids = topk_stable(sparse_mat, t_pad)
    mask = w > 0.0
    return SparseDocs(tids=ids.to(torch.int32),
                      tw=torch.where(mask, w, 0.0), mask=mask, vocab=vocab)
