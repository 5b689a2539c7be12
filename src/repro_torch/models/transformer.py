"""Decoder-only LM: GQA + RoPE + (optional) qk-norm / non-parametric LN,
dense path (PyTorch port of ``repro/models/transformer.py``). Covers
stablelm-3b, qwen3-14b and olmo-1b; a config with ``moe`` raises until
``models/moe.py`` is ported.

The model is a tree of modules whose parameters keep the reference's
names and layouts, one module a layer where the reference stacks the
layers on a scanned axis (``convert.lm_params_from_arrays`` carries a JAX
tree across). Mixed precision is the reference's ``_cast_params``: the
master weights stay float32 and each is cast to ``cfg.dtype`` where a
layer uses it, inside autograd, so the gradients land on the float32
masters. ``cfg.remat`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``, non-reentrant), the reference's
``nothing_saveable`` policy: only the layer inputs are kept. The
products (attention, MLP, the LM head) are plain matrix products, as the
reference leaves them to XLA. ``unroll`` and the sharding tables
(``layer_axes``, ``param_axes``, ``cache_axes``) have no meaning without
a scanned layer axis and a mesh; the latter come with
``distributed/sharding.py``.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (ParamTree, apply_mlp, apply_norm,
                                       cross_entropy_loss, mlp_init,
                                       norm_init, truncated_normal_init)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int | None = None
    norm: str = "rms"                    # rms | ln | nonparam_ln
    qk_norm: bool = False
    act: str = "swiglu"
    rope_theta: float = 1e6
    moe: object | None = None            # an MoE config: not ported yet
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "nothing"        # only "nothing" (full remat)
    attn_chunk: int = 512
    unroll: int = 1                      # the reference's scan unroll

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    def param_count(self) -> int:
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        H, G = self.head_dim, self.n_kv_heads
        attn_p = D * (self.n_heads * H) * 2 + D * G * H * 2
        n_mats = 3 if self.act == "swiglu" else 2
        if self.moe:
            E, Fe = self.moe.n_experts, self.moe.d_ff_expert
            ffn_p = D * E + E * n_mats * D * Fe
            if self.moe.n_shared:
                ffn_p += n_mats * D * Fe * self.moe.n_shared
        else:
            ffn_p = n_mats * D * F
        emb = V * D * (1 if self.tie_embeddings else 2)
        return L * (attn_p + ffn_p) + emb


def _require_dense(cfg: LMConfig) -> None:
    if cfg.moe:
        raise NotImplementedError(
            f"{cfg.name}: a mixture-of-experts config needs "
            f"repro_torch/models/moe.py, which is not ported yet")
    if cfg.remat_policy != "nothing":
        raise ValueError(f"remat_policy {cfg.remat_policy!r}: the port "
                         f"recomputes whole layers only ('nothing')")


# ---------------------------------------------------------------------------
# the module tree
# ---------------------------------------------------------------------------

def _cast(tree, dt: torch.dtype):
    """The reference's ``_cast_params``: float32 masters to the compute
    dtype at the use site (differentiable); other dtypes as they are."""
    if isinstance(tree, (ParamTree, dict)):
        return {k: _cast(v, dt) for k, v in tree.items()}
    return tree.to(dt) if tree.dtype == torch.float32 else tree


class DecoderLayer(nn.Module):
    """Pre-norm block: norm -> causal GQA -> residual, norm -> MLP ->
    residual."""

    def __init__(self, cfg: LMConfig, p: dict):
        super().__init__()
        self.cfg = cfg
        self.ln1, self.ln2 = ParamTree(p["ln1"]), ParamTree(p["ln2"])
        self.attn, self.mlp = ParamTree(p["attn"]), ParamTree(p["mlp"])

    def cast(self) -> dict:
        dt = self.cfg.compute_dtype
        return {k: _cast(getattr(self, k), dt)
                for k in ("ln1", "ln2", "attn", "mlp")}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg, lp = self.cfg, self.cast()
        h = apply_norm(lp["ln1"], x, cfg.norm)
        x = x + attn.attend_train(lp["attn"], h, qk_norm=cfg.qk_norm,
                                  rope_theta=cfg.rope_theta,
                                  chunk=cfg.attn_chunk)
        h = apply_norm(lp["ln2"], x, cfg.norm)
        return x + apply_mlp(lp["mlp"], h, cfg.act)


class TransformerLM(nn.Module):
    """The LM; ``params`` is the reference's tree with the layer axis
    unstacked into a list of per-layer trees."""

    def __init__(self, cfg: LMConfig, params: dict):
        super().__init__()
        _require_dense(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(params["embed"])
        self.layers = nn.ModuleList(DecoderLayer(cfg, p)
                                    for p in params["layers"])
        self.final_norm = ParamTree(params["final_norm"])
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(params["lm_head"])

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed.to(self.cfg.compute_dtype)[tokens]

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and the LM head: (..., D) -> (..., V) logits."""
        dt = self.cfg.compute_dtype
        x = apply_norm(_cast(self.final_norm, dt), x, self.cfg.norm)
        w = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return x @ w.to(dt)


def init_params(gen: torch.Generator, cfg: LMConfig,
                device: str | torch.device | None = None,
                param_dtype: torch.dtype = torch.float32) -> TransformerLM:
    """Random init at the reference's scales, drawn on the CPU and moved
    to ``device`` (None: the CUDA card). As the reference splits one key a
    layer, each layer draws from its own generator, seeded from ``gen``;
    the layers are drawn on parallel threads (a CPU generator draws on one
    core, and the full presets hold billions of layer weights)."""
    dev = resolve_device(device)
    _require_dense(cfg)
    seeds = torch.randint(0, 2 ** 62, (cfg.n_layers,), generator=gen)

    def layer(seed: int) -> dict:
        g = torch.Generator().manual_seed(seed)
        return {"ln1": norm_init(cfg.norm, cfg.d_model),
                "ln2": norm_init(cfg.norm, cfg.d_model),
                "attn": attn.attn_init(g, cfg.d_model, cfg.n_heads,
                                       cfg.n_kv_heads, cfg.head_dim,
                                       cfg.qk_norm, param_dtype),
                "mlp": mlp_init(g, cfg.d_model, cfg.d_ff, cfg.act,
                                param_dtype)}

    with ThreadPoolExecutor(min(cfg.n_layers, os.cpu_count() or 1)) as ex:
        layers = list(ex.map(layer, seeds.tolist()))
    p = {"embed": truncated_normal_init(gen, (cfg.vocab, cfg.d_model), 1.0,
                                        param_dtype),
         "layers": layers,
         "final_norm": norm_init(cfg.norm, cfg.d_model)}
    if not cfg.tie_embeddings:
        p["lm_head"] = truncated_normal_init(gen, (cfg.d_model, cfg.vocab),
                                             1.0, param_dtype)
    return TransformerLM(cfg, p).to(dev)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def forward(model: TransformerLM, tokens: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V), aux_loss)."""
    x = model.embed_tokens(tokens.to(model.device))
    for layer in model.layers:
        if model.cfg.remat and torch.is_grad_enabled():
            x = checkpoint(layer, x, use_reentrant=False)
        else:
            x = layer(x)
    return model.head(x), torch.zeros((), dtype=torch.float32,
                                      device=x.device)


def loss_fn(model: TransformerLM, batch: dict) -> torch.Tensor:
    logits, aux = forward(model, batch["tokens"])
    mask = batch.get("mask")
    return cross_entropy_loss(
        logits, batch["labels"].to(model.device),
        None if mask is None else mask.to(model.device)) + aux


def prefill(model: TransformerLM, tokens: torch.Tensor,
            cache_dtype: torch.dtype = torch.bfloat16
            ) -> tuple[torch.Tensor, dict]:
    """Serving prefill: run the full sequence, emit the KV cache and the
    *last-token* logits only."""
    cfg = model.cfg
    tokens = tokens.to(model.device)
    B, S = tokens.shape
    x = model.embed_tokens(tokens)
    positions = torch.arange(S, device=x.device).expand(B, S)
    ks, vs = [], []
    for layer in model.layers:
        lp = layer.cast()
        h = apply_norm(lp["ln1"], x, cfg.norm)
        q, k, v = attn._project_qkv(lp["attn"], h, positions, cfg.qk_norm,
                                    cfg.rope_theta)
        o = attn.chunked_causal_attention(q, k, v, chunk=cfg.attn_chunk)
        x = x + torch.einsum("bsgph,gphd->bsd", o, lp["attn"]["wo"])
        h = apply_norm(lp["ln2"], x, cfg.norm)
        x = x + apply_mlp(lp["mlp"], h, cfg.act)
        ks.append(k.to(cache_dtype))
        vs.append(v.to(cache_dtype))
    logits = model.head(x[:, -1:, :])
    cache = {"k": torch.stack(ks), "v": torch.stack(vs),
             "len": torch.tensor(S, dtype=torch.int32, device=x.device)}
    return logits, cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache(cfg: LMConfig, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device | None = None) -> dict:
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "len": torch.zeros((), dtype=torch.int32, device=dev)}


def decode_step(model: TransformerLM, cache: dict, tokens: torch.Tensor
                ) -> tuple[torch.Tensor, dict]:
    """One decode step. tokens (B, 1) -> (logits (B, 1, V), new cache)."""
    cfg = model.cfg
    x = model.embed_tokens(tokens.to(model.device))
    cur = cache["len"]
    new_k, new_v = [], []
    for layer, ck, cv in zip(model.layers, cache["k"], cache["v"]):
        lp = layer.cast()
        h = apply_norm(lp["ln1"], x, cfg.norm)
        a, ck, cv = attn.attend_decode(lp["attn"], h, ck, cv, cur,
                                       qk_norm=cfg.qk_norm,
                                       rope_theta=cfg.rope_theta)
        x = x + a
        h = apply_norm(lp["ln2"], x, cfg.norm)
        x = x + apply_mlp(lp["mlp"], h, cfg.act)
        new_k.append(ck)
        new_v.append(cv)
    logits = model.head(x)
    return logits, {"k": torch.stack(new_k), "v": torch.stack(new_v),
                    "len": cur + 1}
