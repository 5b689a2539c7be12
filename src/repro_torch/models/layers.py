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

The reference's ``constrain`` calls (a sharding constraint under ambient
logical-axis rules, a no-op without a mesh) and its ``*_axes`` tables of
logical axis names are left out: nothing in the port shards a model
yet; they come with ``distributed/sharding.py``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

NORM_EPS = 1e-6


class ParamTree(nn.Module):
    """A nested parameter dictionary as a module: tensors become
    parameters, nested dicts child trees, under the same names, so
    ``tree["attn"]["q_norm"]["scale"]`` reads as on the reference's dict
    and ``named_parameters`` gives ``attn.q_norm.scale``."""

    def __init__(self, tree: dict):
        super().__init__()
        self._keys = list(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def items(self):
        return [(k, self[k]) for k in self._keys]


def truncated_normal_init(gen: torch.Generator, shape: tuple, scale: float,
                          dtype=torch.float32) -> torch.Tensor:
    """Normal truncated at two standard deviations, std
    ``scale / sqrt(shape[0])``, as the reference's: standard normals, each
    one outside (-2, 2) drawn again until none is (about 5% the first
    round; a fraction of the inverse-CDF route's time on a CPU)."""
    stddev = scale / max(1.0, (shape[0] if shape else 1)) ** 0.5
    x = torch.randn(shape, generator=gen, dtype=torch.float32)
    flat = x.view(-1)
    redraw = (flat.abs() >= 2.0).nonzero().squeeze(1)
    while redraw.numel():
        flat[redraw] = torch.randn(redraw.numel(), generator=gen)
        redraw = redraw[flat[redraw].abs() >= 2.0]
    return (x * stddev).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32) -> torch.Tensor:
    x = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32)
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
        x = x * params["scale"].float()
    else:
        mu = torch.mean(x, -1, keepdim=True)
        var = torch.mean((x - mu) ** 2, -1, keepdim=True)
        x = (x - mu) * torch.rsqrt(var + eps)
        if norm == "ln":
            x = x * params["scale"].float() + params["bias"].float()
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


def apply_mlp(params, x: torch.Tensor, act: str) -> torch.Tensor:
    up = x @ params["w_up"]
    if act == "swiglu":
        h = F.silu(x @ params["w_gate"]) * up
    elif act == "gelu":
        h = F.gelu(up, approximate="tanh")     # jax.nn.gelu's default
    else:
        raise ValueError(f"unknown act {act!r}")
    return h @ params["w_down"]


def mlp_stack_init(gen: torch.Generator, dims: list[int],
                   dtype=torch.float32) -> dict:
    """Plain MLP tower ([in, h1, ..., out]) with biases."""
    return {
        f"layer{i}": {"w": dense_init(gen, dims[i], dims[i + 1], dtype),
                      "b": torch.zeros((dims[i + 1],), dtype=dtype)}
        for i in range(len(dims) - 1)
    }


def apply_mlp_stack(params, x: torch.Tensor, act=F.relu,
                    final_act: bool = False) -> torch.Tensor:
    n = len(params)
    for i in range(n):
        p = params[f"layer{i}"]
        x = x @ p["w"] + p["b"]
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
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
