"""Decoder-only LM: GQA + RoPE + (optional) qk-norm / non-parametric LN /
MoE (PyTorch port of ``repro/models/transformer.py``). Covers stablelm-3b,
qwen3-14b, olmo-1b, llama4-scout and olmoe; a config with ``moe`` puts
``models/moe.py``'s single-device FFN where the dense MLP sits, and its
auxiliary loss, summed over the layers, joins the training loss.

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
reference leaves them to XLA. ``unroll`` has no meaning without a
scanned layer axis.

The sharding tables (``layer_axes``, ``param_axes``, ``cache_axes``) and
the ``constrain`` calls are the reference's; ``param_axes`` names the
reference's stacked layout (a leading "layers" axis), which
``distributed.parallelize.shard_module`` places the per-layer modules by.
On a sharded model the use-site cast is where FSDP gathers: each float32
master block is cast to the compute dtype, then gathered
(``parallelize.unshard``), as the reference's ``_cast_params`` casts and
then constrains. The MLP's and the experts' weights are left to
``apply_mlp`` and ``models/moe.py``, which keep them split where the
rules split their compute.

Under a layout the program splits its compute over 'model' where
``lm_rules`` does: training and prefill take each rank's chunk of the
sequence from the lookup on (sequence parallelism; attention
context-parallel; the logits and the loss the chunk's), and decode
splits the MLP, the vocab (lookup and head) and the KV cache's slots over
'model' (``long_context``: over ("data", "model")), writing the cache in
place.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed import parallelize as par
from repro_torch.distributed.parallelize import in_context, unshard
from repro_torch.distributed.sharding import constrain, map_axes
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (ParamTree, apply_mlp, apply_norm,
                                       cross_entropy_loss, mlp_axes,
                                       mlp_init, norm_init,
                                       truncated_normal_init)

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
    moe: moe_lib.MoEConfig | None = None
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

    def active_param_count(self) -> int:
        """Per-token active params (MoE: top_k + shared experts only)."""
        if not self.moe:
            return self.param_count()
        D, L = self.d_model, self.n_layers
        H, G = self.head_dim, self.n_kv_heads
        attn_p = D * (self.n_heads * H) * 2 + D * G * H * 2
        n_mats = 3 if self.act == "swiglu" else 2
        Fe = self.moe.d_ff_expert
        ffn_p = (D * self.moe.n_experts
                 + (self.moe.top_k + self.moe.n_shared) * n_mats * D * Fe)
        emb = self.vocab * D * (1 if self.tie_embeddings else 2)
        return L * (attn_p + ffn_p) + emb


def _check_remat_policy(cfg: LMConfig) -> None:
    if cfg.remat_policy != "nothing":
        raise ValueError(f"remat_policy {cfg.remat_policy!r}: the port "
                         f"recomputes whole layers only ('nothing')")


# ---------------------------------------------------------------------------
# the module tree
# ---------------------------------------------------------------------------

def _cast(tree, dt: torch.dtype, split=()):
    """The reference's ``_cast_params``: float32 masters to the compute
    dtype at the use site (differentiable), other dtypes as they are; a
    sharded master is cast and then gathered whole, except the keys in
    ``split``, which stay as they are (their user gathers them)."""
    if isinstance(tree, (ParamTree, dict)):
        return {k: (v if k in split else _cast(v, dt))
                for k, v in tree.items()}
    return unshard(tree, dt)


def layer_axes(cfg: LMConfig) -> dict:
    """Per-layer logical axes without the scanned 'layers' dim."""
    norm_ax = _norm_axes(cfg)
    ax: dict = {"ln1": norm_ax, "ln2": norm_ax,
                "attn": attn.attn_axes(cfg.qk_norm)}
    if cfg.moe:
        ax["moe"] = moe_lib.moe_axes(cfg.moe, cfg.act)
    else:
        ax["mlp"] = mlp_axes(cfg.act)
    return ax


def _norm_axes(cfg: LMConfig) -> dict:
    return {} if cfg.norm == "nonparam_ln" else (
        {"scale": ("embed",)} if cfg.norm == "rms"
        else {"scale": ("embed",), "bias": ("embed",)})


def param_axes(cfg: LMConfig) -> dict:
    """Tree of logical-axis tuples mirroring the reference's parameter
    tree (layers stacked on a leading 'layers' axis)."""
    p = {"embed": ("w_vocab", "w_embed"),
         "layers": map_axes(lambda t: ("layers",) + t, layer_axes(cfg)),
         "final_norm": _norm_axes(cfg)}
    if not cfg.tie_embeddings:
        p["lm_head"] = ("w_embed", "w_vocab")
    return p


def cache_axes() -> dict:
    return {"k": ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
            "v": ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
            "len": ()}


class DecoderLayer(nn.Module):
    """Pre-norm block: norm -> causal GQA -> residual, norm -> MLP (or
    MoE) -> residual."""

    def __init__(self, cfg: LMConfig, p: dict):
        super().__init__()
        self.cfg = cfg
        self.ffn_name = "moe" if cfg.moe else "mlp"
        self.ln1, self.ln2 = ParamTree(p["ln1"]), ParamTree(p["ln2"])
        self.attn = ParamTree(p["attn"])
        self.add_module(self.ffn_name, ParamTree(p[self.ffn_name]))

    def cast(self) -> dict:
        """The layer's weights for compute: cast and gathered, but for the
        MLP's and the experts', which ``apply_mlp`` and ``apply_moe`` cast
        and gather as the rules lay their compute."""
        dt = self.cfg.compute_dtype
        ffn = getattr(self, self.ffn_name)
        keep = (moe_lib.EXPERT_KEYS + ("shared",) if self.cfg.moe
                else tuple(k for k, _ in ffn.items()))
        return {k: _cast(getattr(self, k), dt,
                         keep if k == self.ffn_name else ())
                for k in ("ln1", "ln2", "attn", self.ffn_name)}

    def ffn(self, lp: dict, h: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
        """The MLP or the MoE on the normed residual: (y, aux loss)."""
        cfg = self.cfg
        if cfg.moe:
            return moe_lib.apply_moe(lp["moe"], h, cfg.moe, cfg.act)
        return (apply_mlp(lp["mlp"], h, cfg.act),
                h.new_zeros((), dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        cfg, lp = self.cfg, self.cast()
        h = apply_norm(lp["ln1"], x, cfg.norm)
        x = x + attn.attend_train(lp["attn"], h, qk_norm=cfg.qk_norm,
                                  rope_theta=cfg.rope_theta,
                                  chunk=cfg.attn_chunk)
        y, aux = self.ffn(lp, apply_norm(lp["ln2"], x, cfg.norm))
        return constrain(x + y, "batch", "seq", "embed"), aux


class TransformerLM(nn.Module):
    """The LM; ``params`` is the reference's tree with the layer axis
    unstacked into a list of per-layer trees."""

    def __init__(self, cfg: LMConfig, params: dict):
        super().__init__()
        _check_remat_policy(cfg)
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

    def _vocab_split(self, w, dim: int) -> tuple[str, ...]:
        """The mesh axes ``w``'s vocab dim ``dim`` stays split over at use:
        where the rules put the logits' "vocab" (decode: 'model', as the
        sequence leaves it) and ``w`` is split there."""
        return tuple(a for a in par.split_axes("batch", "seq", "vocab")
                     if a in par.split_dim_axes(w, dim))

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens -> rows of the embedding, in the compute dtype. Where the
        vocab stays split (:meth:`_vocab_split`), each rank takes the ids
        its block of rows holds and an all-reduce over the vocab's axes
        assembles the rows (the others add zeros: exact)."""
        dt = self.cfg.compute_dtype
        tp = self._vocab_split(self.embed, 0)
        if not tp:
            x = unshard(self.embed, dt).to(dt)[tokens]
        else:
            mesh = par.current_layout().mesh
            w = unshard(self.embed, dt, keep=tp).to(dt)
            n = w.shape[0]
            ids = tokens.long() - par.line_index(mesh, tp) * n
            inside = ((ids >= 0) & (ids < n))[..., None]
            x = torch.where(inside, w[torch.clamp(ids, 0, n - 1)], 0)
            x = par.reduce_from(x, par.group(mesh, tp))
        return constrain(x, "batch", "seq", "embed")

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and the LM head: (..., D) -> (..., V) logits. Where
        the vocab stays split, each rank computes its block's logits and an
        all-gather returns every block's."""
        dt = self.cfg.compute_dtype
        x = apply_norm(_cast(self.final_norm, dt), x, self.cfg.norm)
        w, dim = ((self.embed, 0) if self.cfg.tie_embeddings
                  else (self.lm_head, 1))
        tp = self._vocab_split(w, dim)
        w = unshard(w, dt, keep=tp)
        logits = x @ (w.T if dim == 0 else w).to(dt)
        if tp:
            logits = par.gather(logits, logits.dim() - 1,
                                par.group(par.current_layout().mesh, tp))
        return constrain(logits, "batch", "seq", "vocab")


def init_params(gen: torch.Generator, cfg: LMConfig,
                device: str | torch.device | None = None,
                param_dtype: torch.dtype = torch.float32) -> TransformerLM:
    """Random init at the reference's scales, drawn on ``gen``'s device
    and moved to ``device`` (None: the CUDA card). As the reference splits
    one key a layer, each layer draws from its own generator, seeded from
    ``gen``. A CPU generator's layers are drawn on parallel threads (it
    draws on one core, and the full presets hold billions of layer
    weights); a CUDA generator fills the model on the card (olmoe's 6.9B
    weights would otherwise pass through 27.7 GB of host memory)."""
    dev = resolve_device(device)
    _check_remat_policy(cfg)
    seeds = torch.randint(0, 2 ** 62, (cfg.n_layers,), generator=gen,
                          device=gen.device)

    def layer(seed: int) -> dict:
        g = torch.Generator(device=gen.device).manual_seed(seed)
        p = {"ln1": norm_init(cfg.norm, cfg.d_model),
             "ln2": norm_init(cfg.norm, cfg.d_model),
             "attn": attn.attn_init(g, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.head_dim,
                                    cfg.qk_norm, param_dtype)}
        if cfg.moe:
            p["moe"] = moe_lib.moe_init(g, cfg.d_model, cfg.moe, cfg.act,
                                        param_dtype)
        else:
            p["mlp"] = mlp_init(g, cfg.d_model, cfg.d_ff, cfg.act,
                                param_dtype)
        return p

    workers = (1 if gen.device.type == "cuda"
               else min(cfg.n_layers, os.cpu_count() or 1))
    with ThreadPoolExecutor(workers) as ex:
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
    """tokens (B, S) -> (logits (B, S, V), aux_loss summed over the
    layers). Under a layout that splits the sequence, tokens are this
    rank's chunk of its rows' sequence (``parallelize.local_batch``) and
    the logits the chunk's."""
    x = model.embed_tokens(tokens.to(model.device))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in model.layers:
        if model.cfg.remat and torch.is_grad_enabled():
            x, a = checkpoint(in_context(layer), x, use_reentrant=False)
        else:
            x, a = layer(x)
        aux = aux + a
    return model.head(x), aux


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
    *last-token* logits only.

    Under a layout that splits the sequence, tokens are this rank's chunk
    of its rows' sequence: its K/V chunk is its block of the cache (the
    rules split "cache_seq" over the sequence's axes in prefill too; a
    layout that splits them otherwise raises), attention is
    context-parallel, and the last token's logits, computed from the last
    chunk's rank's hidden state, are every rank's. ``len`` is the whole
    sequence's."""
    cfg = model.cfg
    tokens = tokens.to(model.device)
    B, S = tokens.shape
    seq = par.split_axes("batch", "seq")
    if par.split_axes("batch", "cache_seq") != seq:
        raise ValueError(
            f"prefill keeps each rank's K/V chunk as its cache block: the "
            f"rules split the sequence over {seq} and the cache over "
            f"{par.split_axes('batch', 'cache_seq')}")
    x = model.embed_tokens(tokens)
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
    ks = torch.empty(shape, dtype=cache_dtype, device=x.device)
    vs = torch.empty(shape, dtype=cache_dtype, device=x.device)
    for i, layer in enumerate(model.layers):
        lp = layer.cast()
        h = apply_norm(lp["ln1"], x, cfg.norm)
        q, k, v = attn.project_chunk(lp["attn"], h, cfg.qk_norm,
                                     cfg.rope_theta)
        ks[i].copy_(constrain(k, "batch", "cache_seq", "kv_heads",
                              "head_dim"))
        vs[i].copy_(constrain(v, "batch", "cache_seq", "kv_heads",
                              "head_dim"))
        o = attn.chunked_causal_attention(
            q, par.gather_seq(k), par.gather_seq(v), chunk=cfg.attn_chunk,
            q_offset=par.seq_offset(S))
        o = torch.einsum("bsgph,gphd->bsd", o, lp["attn"]["wo"])
        x = x + constrain(o, "batch", "seq", "embed")
        x = constrain(x + layer.ffn(lp, apply_norm(lp["ln2"], x,
                                                   cfg.norm))[0],
                      "batch", "seq", "embed")
    logits = model.head(par.from_last_chunk(x[:, -1:, :]))
    n = S * (par.axes_size(par.current_layout().mesh, seq) if seq else 1)
    cache = {"k": ks, "v": vs,
             "len": torch.tensor(n, dtype=torch.int32, device=x.device)}
    return logits, cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache(cfg: LMConfig, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device | None = None) -> dict:
    """An empty cache of ``batch`` rows and ``max_seq`` slots; under a
    layout, this rank's block of it: its rows over the batch axes and its
    chunk of the slots over the cache's ("cache_seq"), each of which must
    divide."""
    dev = resolve_device(device)
    layout = par.current_layout()
    if layout is not None:
        blocks = []
        for what, n, axes in (
                ("rows", batch, layout.batch_axes),
                ("slots", max_seq, par.split_axes("batch", "cache_seq"))):
            m = par.axes_size(layout.mesh, axes) if axes else 1
            if n % m:
                raise ValueError(f"the cache's {n} {what} do not divide "
                                 f"over {axes} ({m} ranks)")
            blocks.append(n // m)
        batch, max_seq = blocks
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "len": torch.zeros((), dtype=torch.int32, device=dev)}


def decode_step(model: TransformerLM, cache: dict, tokens: torch.Tensor
                ) -> tuple[torch.Tensor, dict]:
    """One decode step. tokens (B, 1) -> (logits (B, 1, V), cache): the
    token's K/V are written into ``cache``'s tensors in place, and the
    cache returned holds those tensors and ``len`` + 1 (no new cache is
    built). Under a layout, tokens are this rank's rows and the cache its
    block (:func:`init_cache`); the MLP and the vocab are split over
    'model' (``apply_mlp``, :meth:`TransformerLM.head`), and the logits
    are every vocab block's."""
    cfg = model.cfg
    x = model.embed_tokens(tokens.to(model.device))
    cur = cache["len"]
    for layer, ck, cv in zip(model.layers, cache["k"], cache["v"]):
        lp = layer.cast()
        h = apply_norm(lp["ln1"], x, cfg.norm)
        a, _, _ = attn.attend_decode(lp["attn"], h, ck, cv, cur,
                                     qk_norm=cfg.qk_norm,
                                     rope_theta=cfg.rope_theta)
        x = x + a
        x = x + layer.ffn(lp, apply_norm(lp["ln2"], x, cfg.norm))[0]
    logits = model.head(x)
    return logits, {"k": cache["k"], "v": cache["v"], "len": cur + 1}
