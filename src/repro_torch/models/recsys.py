"""RecSys architectures: DLRM (MLPerf), DIN, DeepFM, BERT4Rec (PyTorch
port of ``repro/models/recsys.py``).

Common shape: large embedding tables -> feature interaction (dot / FM /
target attention / bidirectional self-attention) -> small MLP. Per-field
tables with a uniform vocab are stacked into one (F * R, D) table, the
ids offset by field * R, so one lookup serves all fields.

Each model is a :class:`~repro_torch.models.layers.TreeModel`: the
reference's parameter tree as modules under the same names
(``convert.recsys_params_from_arrays`` carries a JAX tree across),
trained in place by ``training/train_loop``.
BERT4Rec's blocks, stacked on a scanned axis in the reference, are one
module a block; ``convert.to_arrays`` stacks them again for checkpoints.
Every ``*_forward``, ``*_loss`` and ``*_retrieval`` takes the model and a
batch of tensors on any device (moved to the model's); the config is the
model's ``cfg``. ``*_retrieval`` scores one user against a candidate
block as one batched forward pass.

Initialisers draw from an explicit ``torch.Generator`` on its own device
(their numbers are not ``jax.random``'s; the scales are the same), so a
CUDA generator draws a full-size table on the card. The ``*_axes``
tables (``RECSYS_AXES``) and the ``constrain`` calls are the
reference's. On a sharded model (``distributed/parallelize.py``) the
tables stay split over 'table_rows' (``embedding_lookup``'s row-sharded
path), every other weight is gathered at use, and the losses are each
rank's share of the whole batch's mean.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.distributed.parallelize import batch_share, batch_sum, \
    unshard
from repro_torch.distributed.sharding import constrain
from repro_torch.models.embedding import embedding_init, embedding_lookup
from repro_torch.models.layers import (TreeModel, apply_mlp_stack,
                                       apply_norm, draw_device,
                                       mlp_stack_init, norm_init, randn)

NEG_MASK = -1e30      # the reference's masked attention logit


def _model(cfg, params: dict,
           device: str | torch.device | None) -> TreeModel:
    return TreeModel(cfg, params).to(resolve_device(device))


def _ids(x: torch.Tensor, model: TreeModel) -> torch.Tensor:
    return x.to(device=model.device, dtype=torch.int64)


def _bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy of logits, the reference's stable form."""
    z = logits.reshape(-1).float()
    y = labels.reshape(-1).to(device=z.device, dtype=torch.float32)
    return batch_share(torch.mean(torch.clamp(z, min=0) - z * y
                                  + torch.log1p(torch.exp(-torch.abs(z)))))


def _mlp_stack_axes(n: int) -> dict:
    return {f"layer{i}": {"w": ("w_fsdp", "w_out"), "b": ("w_out",)}
            for i in range(n)}


# ===========================================================================
# DLRM (MLPerf config, arXiv:1906.00091)
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-mlperf"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 128
    vocab_per_table: int = 4_000_000
    bot_mlp: tuple = (512, 256, 128)
    top_mlp: tuple = (1024, 1024, 512, 256, 1)
    interaction: str = "dot"
    dtype: str = "float32"

    @property
    def n_pairs(self) -> int:
        f = self.n_sparse + 1
        return f * (f - 1) // 2

    @property
    def top_in(self) -> int:
        return self.n_pairs + self.bot_mlp[-1]


def dlrm_init(gen: torch.Generator, cfg: DLRMConfig,
              device: str | torch.device | None = None) -> TreeModel:
    return _model(cfg, {
        "tables": embedding_init(
            gen, cfg.n_sparse * cfg.vocab_per_table, cfg.embed_dim),
        "bot": mlp_stack_init(gen, [cfg.n_dense, *cfg.bot_mlp]),
        "top": mlp_stack_init(gen, [cfg.top_in, *cfg.top_mlp]),
    }, device)


def _dot_interaction(vectors: torch.Tensor) -> torch.Tensor:
    """vectors (B, F, D) -> (B, F*(F-1)/2) upper-tri pairwise dots, in
    ``jnp.triu_indices``' row-major order."""
    z = torch.einsum("bfd,bgd->bfg", vectors, vectors)
    f = vectors.shape[1]
    iu, ju = torch.triu_indices(f, f, 1, device=vectors.device)
    return z[:, iu, ju]


def dlrm_forward(model: TreeModel, batch: dict) -> torch.Tensor:
    """batch: dense (B, 13) f32, sparse (B, 26) int -> logits (B,)."""
    cfg = model.cfg
    offsets = torch.arange(cfg.n_sparse, dtype=torch.int64,
                           device=model.device) * cfg.vocab_per_table
    ids = _ids(batch["sparse"], model) + offsets[None, :]
    emb = embedding_lookup(model["tables"], ids)           # (B, 26, D)
    emb = constrain(emb, "batch", "fields", "embed")
    bot = apply_mlp_stack(model["bot"], batch["dense"].to(model.device),
                          final_act=True)
    x = torch.cat([bot[:, None, :], emb], dim=1)           # (B, 27, D)
    inter = _dot_interaction(x)                            # (B, 351)
    top_in = torch.cat([bot, inter], dim=-1)
    return constrain(apply_mlp_stack(model["top"], top_in)[:, 0], "batch")


def dlrm_axes(cfg: DLRMConfig) -> dict:
    return {"tables": ("table_rows", "embed"),
            "bot": _mlp_stack_axes(len(cfg.bot_mlp)),
            "top": _mlp_stack_axes(len(cfg.top_mlp))}


def dlrm_loss(model: TreeModel, batch: dict) -> torch.Tensor:
    return _bce(dlrm_forward(model, batch), batch["labels"])


def dlrm_retrieval(model: TreeModel, batch: dict) -> torch.Tensor:
    """One user against a candidate block: candidates replace sparse field
    0 and the user context is broadcast. batch: dense (1, 13), sparse
    (1, 26), cand_ids (C,). Returns (C,) scores."""
    cfg = model.cfg
    cand = _ids(batch["cand_ids"], model)
    c = cand.shape[0]
    sparse = _ids(batch["sparse"], model).expand(c, cfg.n_sparse).clone()
    sparse[:, 0] = cand
    dense = batch["dense"].to(model.device).expand(c, cfg.n_dense)
    return dlrm_forward(model, {"dense": dense, "sparse": sparse})


# ===========================================================================
# DIN (arXiv:1706.06978)
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class DINConfig:
    name: str = "din"
    embed_dim: int = 18
    seq_len: int = 100
    attn_mlp: tuple = (80, 40)
    mlp: tuple = (200, 80)
    n_items: int = 1_000_000
    n_cates: int = 10_000
    dtype: str = "float32"

    @property
    def feat_dim(self) -> int:          # item ++ category embedding
        return 2 * self.embed_dim


def din_init(gen: torch.Generator, cfg: DINConfig,
             device: str | torch.device | None = None) -> TreeModel:
    f = cfg.feat_dim
    return _model(cfg, {
        "item_emb": embedding_init(gen, cfg.n_items, cfg.embed_dim),
        "cate_emb": embedding_init(gen, cfg.n_cates, cfg.embed_dim),
        "attn": mlp_stack_init(gen, [4 * f, *cfg.attn_mlp, 1]),
        "mlp": mlp_stack_init(gen, [3 * f, *cfg.mlp, 1]),
    }, device)


def _din_feat(model: TreeModel, items, cates) -> torch.Tensor:
    return torch.cat([embedding_lookup(model["item_emb"], _ids(items, model)),
                      embedding_lookup(model["cate_emb"], _ids(cates, model))],
                     dim=-1)


def din_forward(model: TreeModel, batch: dict) -> torch.Tensor:
    """batch: hist_items/hist_cates (B, L), hist_mask (B, L),
    target_item/target_cate (B,) -> logits (B,)."""
    h = _din_feat(model, batch["hist_items"], batch["hist_cates"])
    t = _din_feat(model, batch["target_item"], batch["target_cate"])
    h = constrain(h, "batch", "seq", "embed")
    tb = t[:, None, :].expand_as(h)
    att_in = torch.cat([h, tb, h - tb, h * tb], dim=-1)
    w = apply_mlp_stack(model["attn"], att_in)[..., 0]     # (B, L)
    w = torch.where(batch["hist_mask"].to(model.device), w, NEG_MASK)
    w = torch.softmax(w, dim=-1)
    user = torch.einsum("bl,blf->bf", w, h)
    x = torch.cat([user, t, user * t], dim=-1)
    return apply_mlp_stack(model["mlp"], x)[:, 0]


def din_axes(cfg: DINConfig) -> dict:
    return {"item_emb": ("table_rows", "embed"),
            "cate_emb": ("table_rows", "embed"),
            "attn": _mlp_stack_axes(len(cfg.attn_mlp) + 1),
            "mlp": _mlp_stack_axes(len(cfg.mlp) + 1)}


def din_loss(model: TreeModel, batch: dict) -> torch.Tensor:
    return _bce(din_forward(model, batch), batch["labels"])


def din_retrieval(model: TreeModel, batch: dict) -> torch.Tensor:
    """One user history vs a candidate block. batch: hist_* (1, L),
    cand_items (C,), cand_cates (C,)."""
    c = batch["cand_items"].shape[0]
    L = model.cfg.seq_len
    rep = {k: batch[k].to(model.device).expand(c, L)
           for k in ("hist_items", "hist_cates", "hist_mask")}
    rep.update(target_item=batch["cand_items"],
               target_cate=batch["cand_cates"])
    return din_forward(model, rep)


# ===========================================================================
# DeepFM (arXiv:1703.04247)
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class DeepFMConfig:
    name: str = "deepfm"
    n_fields: int = 39
    embed_dim: int = 10
    vocab_per_field: int = 1_000_000
    mlp: tuple = (400, 400, 400)
    dtype: str = "float32"


def deepfm_init(gen: torch.Generator, cfg: DeepFMConfig,
                device: str | torch.device | None = None) -> TreeModel:
    rows = cfg.n_fields * cfg.vocab_per_field
    return _model(cfg, {
        "emb": embedding_init(gen, rows, cfg.embed_dim),
        "w1": embedding_init(gen, rows, 1),
        "mlp": mlp_stack_init(
            gen, [cfg.n_fields * cfg.embed_dim, *cfg.mlp, 1]),
        "bias": torch.zeros((), dtype=torch.float32,
                            device=draw_device(gen)),
    }, device)


def deepfm_forward(model: TreeModel, batch: dict) -> torch.Tensor:
    """batch: fields (B, 39) int -> logits (B,)."""
    cfg = model.cfg
    offsets = torch.arange(cfg.n_fields, dtype=torch.int64,
                           device=model.device) * cfg.vocab_per_field
    ids = _ids(batch["fields"], model) + offsets[None, :]
    e = embedding_lookup(model["emb"], ids)                # (B, F, D)
    e = constrain(e, "batch", "fields", "embed")
    first = embedding_lookup(model["w1"], ids)[..., 0].sum(-1)
    s = e.sum(dim=1)
    fm = 0.5 * (s * s - (e * e).sum(dim=1)).sum(-1)
    deep = apply_mlp_stack(model["mlp"], e.reshape(e.shape[0], -1))[:, 0]
    return unshard(model["bias"]) + first + fm + deep


def deepfm_axes(cfg: DeepFMConfig) -> dict:
    return {"emb": ("table_rows", "embed"), "w1": ("table_rows", "embed"),
            "mlp": _mlp_stack_axes(len(cfg.mlp) + 1), "bias": ()}


def deepfm_loss(model: TreeModel, batch: dict) -> torch.Tensor:
    return _bce(deepfm_forward(model, batch), batch["labels"])


def deepfm_retrieval(model: TreeModel, batch: dict) -> torch.Tensor:
    cand = _ids(batch["cand_ids"], model)
    c = cand.shape[0]
    fields = _ids(batch["fields"], model).expand(
        c, model.cfg.n_fields).clone()
    fields[:, 0] = cand
    return deepfm_forward(model, {"fields": fields})


# ===========================================================================
# BERT4Rec (arXiv:1904.06690)
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class Bert4RecConfig:
    name: str = "bert4rec"
    n_items: int = 1_000_000
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    n_negatives: int = 1024      # sampled softmax at 10^6-item catalogs
    dtype: str = "float32"


def bert4rec_init(gen: torch.Generator, cfg: Bert4RecConfig,
                  device: str | torch.device | None = None) -> TreeModel:
    d = cfg.embed_dim

    def init(i: int, o: int) -> torch.Tensor:
        return randn(gen, (i, o)) / math.sqrt(i)

    def block() -> dict:
        p = {k: init(d, d) for k in ("wq", "wk", "wv", "wo")}
        p.update(ln1=norm_init("ln", d), ln2=norm_init("ln", d),
                 ff1={"w": init(d, 4 * d), "b": torch.zeros((4 * d,))},
                 ff2={"w": init(4 * d, d), "b": torch.zeros((d,))})
        return p

    blocks = [block() for _ in range(cfg.n_blocks)]
    return _model(cfg, {
        # +1 row: the [MASK] item; rows padded so a row-sharded table
        # divides the 'model' mesh axis (n_items + 1 is odd)
        "item_emb": embedding_init(gen, cfg.n_items + 1, d, 0.02,
                                   pad_rows_to=2048),
        "pos_emb": embedding_init(gen, cfg.seq_len, d, 0.02),
        "blocks": blocks,
        "final_ln": norm_init("ln", d),
    }, device)


def _bert4rec_block(bp, x: torch.Tensor, mask: torch.Tensor,
                    n_heads: int) -> torch.Tensor:
    B, L, d = x.shape
    dh = d // n_heads
    w = {k: unshard(bp[k]) for k in ("wq", "wk", "wv", "wo")}
    ff1 = {k: unshard(v) for k, v in bp["ff1"].items()}
    ff2 = {k: unshard(v) for k, v in bp["ff2"].items()}
    y = apply_norm(bp["ln1"], x, "ln")
    q = (y @ w["wq"]).reshape(B, L, n_heads, dh)
    k = (y @ w["wk"]).reshape(B, L, n_heads, dh)
    v = (y @ w["wv"]).reshape(B, L, n_heads, dh)
    s = torch.einsum("blhd,bmhd->bhlm", q, k) / math.sqrt(dh)
    s = torch.where(mask[:, None, None, :], s, NEG_MASK)
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bhlm,bmhd->blhd", a, v).reshape(B, L, d)
    x = x + o @ w["wo"]
    y = apply_norm(bp["ln2"], x, "ln")
    y = F.gelu(y @ ff1["w"] + ff1["b"], approximate="tanh")
    return x + (y @ ff2["w"] + ff2["b"])


def bert4rec_encode(model: TreeModel, batch: dict) -> torch.Tensor:
    """batch: items (B, L) int (n_items is [MASK]), mask (B, L) bool.
    Returns hidden (B, L, D) on the model's device."""
    cfg = model.cfg
    mask = batch["mask"].to(model.device)
    x = embedding_lookup(model["item_emb"], _ids(batch["items"], model)) \
        + unshard(model["pos_emb"])
    x = constrain(x, "batch", "seq", "embed")
    for bp in model["blocks"]:
        x = _bert4rec_block(bp, x, mask, cfg.n_heads)
    return apply_norm(model["final_ln"], x, "ln")


def bert4rec_loss(model: TreeModel, batch: dict) -> torch.Tensor:
    """Masked-item prediction with a sampled softmax over n_negatives
    shared negatives. batch adds: labels (B, L), label_mask (B, L) bool,
    negatives (n_negatives,)."""
    hidden = bert4rec_encode(model, batch)                   # (B, L, D)
    pos_emb = embedding_lookup(model["item_emb"], _ids(batch["labels"],
                                                       model))
    neg_emb = embedding_lookup(model["item_emb"], _ids(batch["negatives"],
                                                       model))
    pos_logit = torch.einsum("bld,bld->bl", hidden, pos_emb)
    neg_logit = torch.einsum("bld,nd->bln", hidden, neg_emb)
    logits = torch.cat([pos_logit[..., None], neg_logit], dim=-1)
    nll = torch.logsumexp(logits, dim=-1) - pos_logit
    w = batch["label_mask"].to(device=model.device, dtype=torch.float32)
    return torch.sum(nll * w) / torch.clamp(batch_sum(torch.sum(w)),
                                            min=1.0)


def bert4rec_axes(cfg: Bert4RecConfig) -> dict:
    def s(t):
        return ("layers",) + t
    block_ax = {
        "wq": s(("embed", "w_out")), "wk": s(("embed", "w_out")),
        "wv": s(("embed", "w_out")), "wo": s(("embed", "w_out")),
        "ln1": {"scale": s(("embed",)), "bias": s(("embed",))},
        "ln2": {"scale": s(("embed",)), "bias": s(("embed",))},
        "ff1": {"w": s(("embed", "w_out")), "b": s(("w_out",))},
        "ff2": {"w": s(("w_out", "embed")), "b": s(("embed",))},
    }
    return {"item_emb": ("table_rows", "embed"), "pos_emb": ("seq", "embed"),
            "blocks": block_ax, "final_ln": {"scale": ("embed",),
                                             "bias": ("embed",)}}


def bert4rec_retrieval(model: TreeModel, batch: dict) -> torch.Tensor:
    """Encode once, dot against the candidate block. batch: items (1, L),
    mask (1, L), cand_ids (C,). Returns (C,)."""
    hidden = bert4rec_encode(model, batch)[:, -1, :]         # (1, D)
    cand = embedding_lookup(model["item_emb"], _ids(batch["cand_ids"],
                                                    model))
    cand = constrain(cand, "candidates", "embed")
    return (cand @ hidden[0]).float()


# arch id -> (init, forward, loss, retrieval)
RECSYS = {
    "dlrm-mlperf": (dlrm_init, dlrm_forward, dlrm_loss, dlrm_retrieval),
    "din": (din_init, din_forward, din_loss, din_retrieval),
    "deepfm": (deepfm_init, deepfm_forward, deepfm_loss, deepfm_retrieval),
    "bert4rec": (bert4rec_init, bert4rec_encode, bert4rec_loss,
                 bert4rec_retrieval),
}

# arch id -> its parameters' logical axes (the reference's layout)
RECSYS_AXES = {"dlrm-mlperf": dlrm_axes, "din": din_axes,
               "deepfm": deepfm_axes, "bert4rec": bert4rec_axes}
