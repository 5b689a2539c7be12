"""Shared neural building blocks (PyTorch port of ``repro/models/layers.py``).

Parameters are dictionaries of tensors with the reference's names, shapes
and layouts (``x @ w`` with ``w`` of shape (d_in, d_out)), so a parameter
tree carried across from the JAX package drops in unchanged; the modules
of ``sparse_encoder.py`` hold them as ``nn.ParameterDict``s and pass them
here. Initialisers draw from an explicit ``torch.Generator``: its numbers
are not ``jax.random``'s, the scales and truncation are the same.

Three behaviours of the reference that PyTorch's defaults do not share:
``jax.nn.gelu`` is the tanh approximation, the norms take eps 1e-6, and
RoPE rotates the two halves of the head dim (not interleaved pairs).

``mlp_axes`` and the ``constrain`` calls are the reference's
(``distributed/sharding.py``; the identity without a mesh). Under a
split of the tokens (``distributed/parallelize.py``) the loss's mean
divides by the whole batch's count, summed over the ranks that split
it, so the ranks' losses add up to the reference's; the MLP is
tensor-parallel where the rules put its hidden dim on a mesh axis.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import parallelize as par
from repro_torch.distributed.parallelize import batch_share, batch_sum, \
    unshard
from repro_torch.distributed.sharding import constrain

NORM_EPS = 1e-6

# > 0 inside :func:`shapes_only` (a count, not a thread-local: the LM's
# initialiser draws its layers on worker threads)
_shapes_only = 0


@contextlib.contextmanager
def shapes_only():
    """Inside, every initialiser of the port's models makes its tensors on
    the meta device: a draw's shape and dtype, no values and no storage.
    A production model (a 53 GB table, 109B expert weights) is built so
    and sharded before any rank's block is made real
    (``launch/cells.py``)."""
    global _shapes_only
    _shapes_only += 1
    try:
        yield
    finally:
        _shapes_only -= 1


def draw_device(gen: torch.Generator) -> torch.device:
    """Where an initialiser draws: ``gen``'s device, or the meta device
    inside :func:`shapes_only`."""
    return torch.device("meta") if _shapes_only else gen.device


def randn(gen: torch.Generator, shape: tuple,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard normals drawn from ``gen`` on its device; inside
    :func:`shapes_only` an empty meta tensor (no draw: a meta draw takes
    milliseconds, and olmoe's experts make thousands)."""
    if _shapes_only:
        return torch.empty(shape, dtype=dtype, device="meta")
    return torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)


class ParamTree(nn.Module):
    """A nested parameter dictionary as a module: tensors become
    parameters, nested dicts child trees, under the same names, so
    ``tree["attn"]["q_norm"]["scale"]`` reads as on the reference's dict
    and ``named_parameters`` gives ``attn.q_norm.scale``. A list of
    per-layer trees (which the reference stacks on a scanned axis)
    becomes a ``ModuleList`` of trees."""

    def __init__(self, tree: dict):
        super().__init__()
        self._keys = list(tree)
        for k, v in tree.items():
            if isinstance(v, (list, tuple)):
                self.add_module(k, nn.ModuleList(ParamTree(p) for p in v))
            elif isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __len__(self) -> int:
        return len(self._keys)

    def items(self):
        return [(k, self[k]) for k in self._keys]


class TreeModel(ParamTree):
    """A model that is the reference's whole parameter tree as a
    :class:`ParamTree`, with its config beside it as ``cfg``."""

    def __init__(self, cfg, params: dict):
        super().__init__(params)
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


def truncated_normal_init(gen: torch.Generator, shape: tuple, scale: float,
                          dtype=torch.float32) -> torch.Tensor:
    """Normal truncated at two standard deviations, std
    ``scale / sqrt(shape[0])``, as the reference's: standard normals, each
    one outside (-2, 2) drawn again until none is (about 5% the first
    round; a fraction of the inverse-CDF route's time on a CPU). Drawn on
    ``gen``'s device."""
    stddev = scale / max(1.0, (shape[0] if shape else 1)) ** 0.5
    x = randn(gen, shape)
    if x.is_meta:
        return x.to(dtype)
    flat = x.view(-1)
    redraw = (flat.abs() >= 2.0).nonzero().squeeze(1)
    while redraw.numel():
        flat[redraw] = torch.randn(redraw.numel(), generator=gen,
                                   device=gen.device)
        redraw = redraw[flat[redraw].abs() >= 2.0]
    return (x * stddev).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32) -> torch.Tensor:
    x = randn(gen, (d_in, d_out))
    if x.is_meta:
        return x.to(dtype)
    return (x * (1.0 / math.sqrt(d_in))).to(dtype)


# ---------------------------------------------------------------------------
# Norms: rms | ln | nonparam_ln (OLMo's non-parametric LayerNorm)
# ---------------------------------------------------------------------------

def norm_init(norm: str, dim: int, dtype=torch.float32) -> dict:
    if norm == "rms":
        return {"scale": torch.ones((dim,), dtype=dtype)}
    if norm == "ln":
        return {"scale": torch.ones((dim,), dtype=dtype),
                "bias": torch.zeros((dim,), dtype=dtype)}
    if norm == "nonparam_ln":
        return {}
    raise ValueError(f"unknown norm {norm!r}")


def apply_norm(params, x: torch.Tensor, norm: str,
               eps: float = NORM_EPS) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    if norm == "rms":
        x = x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps)
        x = x * unshard(params["scale"]).float()
    else:
        mu = torch.mean(x, -1, keepdim=True)
        var = torch.mean((x - mu) ** 2, -1, keepdim=True)
        x = (x - mu) * torch.rsqrt(var + eps)
        if norm == "ln":
            x = (x * unshard(params["scale"]).float()
                 + unshard(params["bias"]).float())
    return x.to(dt)


# ---------------------------------------------------------------------------
# MLP: swiglu | gelu
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, act: str,
             dtype=torch.float32) -> dict:
    p = {"w_up": dense_init(gen, d_model, d_ff, dtype),
         "w_down": dense_init(gen, d_ff, d_model, dtype)}
    if act == "swiglu":
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype)
    return p


def mlp_axes(act: str) -> dict:
    a = {"w_up": ("w_fsdp", "w_mlp"), "w_down": ("w_mlp", "w_fsdp")}
    if act == "swiglu":
        a["w_gate"] = ("w_fsdp", "w_mlp")
    return a


def apply_mlp(params, x: torch.Tensor, act: str) -> torch.Tensor:
    """The MLP as the rules lay it, its float32 weights cast to x's dtype
    at use. Where the rules put its hidden dim ("mlp") on mesh axes
    (decode: the sequence leaves 'model' to it), ``w_up`` and ``w_gate``
    stay split by column and ``w_down`` by row there, and the product is
    all-reduced over them; elsewhere (training and prefill, where the
    sequence holds 'model') each weight is gathered whole at use and x is
    this rank's chunk of the sequence."""
    tp = tuple(a for a in par.split_axes("batch", "seq", "mlp")
               if a in par.split_dim_axes(params["w_down"], 0))
    up = constrain(x @ unshard(params["w_up"], x.dtype, keep=tp), "batch",
                   "seq", "mlp")
    if act == "swiglu":
        h = F.silu(x @ unshard(params["w_gate"], x.dtype, keep=tp)) * up
    elif act == "gelu":
        h = F.gelu(up, approximate="tanh")     # jax.nn.gelu's default
    else:
        raise ValueError(f"unknown act {act!r}")
    w_down = unshard(params["w_down"], x.dtype, keep=tp)
    if tp:
        # each rank's partial product in float32, rounded once after the
        # sum, as one device rounds its float32-accumulated product
        out = par.reduce_from(h.float() @ w_down.float(),
                              par.group(par.current_layout().mesh, tp))
        out = out.to(x.dtype)
    else:
        out = h @ w_down
    return constrain(out, "batch", "seq", "embed")


def mlp_stack_init(gen: torch.Generator, dims: list[int],
                   dtype=torch.float32) -> dict:
    """Plain MLP tower ([in, h1, ..., out]) with biases."""
    return {
        f"layer{i}": {"w": dense_init(gen, dims[i], dims[i + 1], dtype),
                      "b": torch.zeros((dims[i + 1],), dtype=dtype,
                                       device=draw_device(gen))}
        for i in range(len(dims) - 1)
    }


def apply_mlp_stack(params, x: torch.Tensor, act=F.relu,
                    final_act: bool = False) -> torch.Tensor:
    n = len(params)
    for i in range(n):
        p = params[f"layer{i}"]
        x = x @ unshard(p["w"]) + unshard(p["b"])
        if i < n - 1 or final_act:
            x = act(x)
    return x


# ---------------------------------------------------------------------------
# Rotary position embeddings (GPT-NeoX half-rotation convention)
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float,
               device: torch.device | None = None) -> torch.Tensor:
    return 1.0 / theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                        device=device) / d_head)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (..., seq, d_head); positions: (..., seq) integer."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (d/2,)
    angles = positions[..., None].float() * freqs             # (..., s, d/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean CE over valid positions; the label's logit taken by a masked
    sum over the vocab, as the reference takes it."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    vocab_ids = torch.arange(logits.shape[-1], device=logits.device)
    ll = torch.sum(torch.where(vocab_ids == labels[..., None], logits, 0.0),
                   dim=-1)
    nll = lse - ll
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(batch_sum(torch.sum(mask)),
                                                   min=1.0)
    return batch_share(torch.mean(nll))
