"""Mixture-of-Experts FFN with sort-based capacity dispatch (PyTorch port of
``repro/models/moe.py``, its single-device path).

Top-k routing (Switch/GShard lineage) with the memory-lean dispatch:
tokens are sorted by expert id within a *group* (one group per sequence)
and placed into (E, C) capacity slots; dispatch and combine are gathers
and scatters of O(T·k·d), never the O(T·E·C) one-hot tensors of the
einsum formulation. The per-expert FFN is one batched product pair over
the expert axis, left to ``torch.einsum`` as the reference leaves it to
XLA. The load-balancing auxiliary loss is the Switch formulation on the
top-1 expert.

Where the port must take care to place the same tokens:

  * the top-k is a stable descending sort (``topk_stable``): on tied
    router probabilities the lower expert id comes first, as
    ``jax.lax.top_k`` puts it; ``torch.topk`` does not;
  * the reference vmaps its per-group dispatch over the B sequences. The
    port sorts once, stably, over the key ``b·E + e``: runs of equal keys
    never span two groups, so each pick's position within its expert, and
    so the capacity drops, equal B separate sorts;
  * the reference scatters every dropped pick into one extra row ``E·C``
    and slices it away. The port instead gathers each slot's source token
    from a map in which only kept picks land on real slots (the dropped
    ones go to a spare entry of an integer map, which is cut off): the
    activations are written once a slot, and no float row is written
    twice;
  * determinism on the card: the combine sums each token's K expert
    outputs by ``index_add`` over token ids. On a CUDA tensor that sums
    with float atomics, so two runs can differ in the last bit; under
    ``torch.use_deterministic_algorithms(True)`` PyTorch routes it through
    ``index_put_(accumulate=True)``, which sorts the indices and sums each
    row's sources in one fixed order. The backward of the two gathers
    (``x_pad[src]`` in the dispatch, ``flat[slot]`` in the combine) is
    that same accumulating ``index_put_``. The stable sort and the
    running maximum of ``rank_within_run`` are exact on either device.

``moe_axes``, ``_a2a_path_available``, ``_moe_weight_dims_divide`` and
``_apply_moe_a2a`` (the expert-parallel all-to-all the reference takes
under a mesh with a 'model' axis) and the ``constrain`` calls come with
``distributed/sharding.py``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.search import topk_stable
from repro_torch.models.layers import apply_mlp, dense_init, mlp_init
from repro_torch.utils import rank_within_run


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # shared (always-on) experts, llama4-style
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


def moe_init(gen: torch.Generator, d_model: int, cfg: MoEConfig, act: str,
             dtype=torch.float32) -> dict:
    """The reference's tree: the router (float32 whatever ``dtype``), the
    experts' ``w_up``/``w_down`` (and ``w_gate`` for swiglu) stacked on a
    leading expert axis, one draw an expert, and the shared experts as
    one MLP of width ``d_ff_expert · n_shared``."""
    E, F_ = cfg.n_experts, cfg.d_ff_expert

    def experts(d_in: int, d_out: int) -> torch.Tensor:
        return torch.stack([dense_init(gen, d_in, d_out, dtype)
                            for _ in range(E)])

    p = {"router": dense_init(gen, d_model, E, torch.float32),
         "w_up": experts(d_model, F_),
         "w_down": experts(F_, d_model)}
    if act == "swiglu":
        p["w_gate"] = experts(d_model, F_)
    if cfg.n_shared:
        p["shared"] = mlp_init(gen, d_model, F_ * cfg.n_shared, act, dtype)
    return p


def _expert_ffn(params, x: torch.Tensor, act: str) -> torch.Tensor:
    """x: (B, E, C, D) -> (B, E, C, D), one batched product pair over the
    expert axis."""
    up = torch.einsum("becd,edf->becf", x, params["w_up"])
    if act == "swiglu":
        gate = torch.einsum("becd,edf->becf", x, params["w_gate"])
        h = F.silu(gate) * up
    else:
        h = F.gelu(up, approximate="tanh")     # jax.nn.gelu's default
    return torch.einsum("becf,efd->becd", h, params["w_down"])


def route(params, x: torch.Tensor, cfg: MoEConfig
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (probs (B, S, E) float32, gates (B, S, K) renormalised
    to sum 1, idx (B, S, K) expert ids). The logits are float32 products of
    the activations and the router as the layer holds it (the reference
    casts the router to the compute dtype with the rest of the layer)."""
    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = topk_stable(probs, cfg.top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, idx


def dispatch(x: torch.Tensor, gates: torch.Tensor, idx: torch.Tensor,
             E: int, C: int):
    """Sort-based capacity placement of every group at once.

    x (B, S, D), gates/idx (B, S, K). Returns (expert_in (B, E, C, D),
    info), info = (st, sg, slot, keep), each (B, S·K) in the group's
    expert-sorted order: the pick's token within its sequence, its gate,
    its slot ``e·C + pos`` (``E·C`` where dropped) and whether it is
    kept; the reference's ``_dispatch_one_group`` per group."""
    B, S, K = idx.shape
    D = x.shape[-1]
    n = S * K
    group = torch.arange(B, device=x.device)[:, None]
    key = (idx.reshape(B, n).long() + E * group).reshape(-1)
    skey, order = torch.sort(key, stable=True)
    pos = rank_within_run(skey).reshape(B, n)
    local = order.reshape(B, n) - n * group         # pick within its group
    se = skey.reshape(B, n) - E * group
    st = local // K
    sg = gates.reshape(B, n).gather(1, local)
    keep = pos < C
    slot = torch.where(keep, se * C + pos, E * C)
    # each slot's source row of x; B·S is a zero row (an unfilled slot),
    # and the dropped picks all land on the spare last entry
    src = torch.full((B * E * C + 1,), B * S, dtype=torch.int64,
                     device=x.device)
    src[torch.where(keep, slot + E * C * group, B * E * C).reshape(-1)] = (
        st + S * group).reshape(-1)
    x_pad = torch.cat([x.reshape(B * S, D), x.new_zeros((1, D))])
    return (x_pad[src[:-1]].reshape(B, E, C, D), (st, sg, slot, keep))


def combine(expert_out: torch.Tensor, info, S: int) -> torch.Tensor:
    """(B, E, C, D) expert outputs -> (B, S, D): each token's kept picks,
    weighted by their gates, summed (``_combine_one_group`` per group)."""
    st, sg, slot, keep = info
    B, E, C, D = expert_out.shape
    group = torch.arange(B, device=expert_out.device)[:, None]
    flat = expert_out.reshape(B * E * C, D)
    picked = flat[(torch.clamp(slot, max=E * C - 1)
                   + E * C * group).reshape(-1)]
    w = torch.where(keep, sg, 0.0).to(flat.dtype).reshape(-1, 1)
    out = expert_out.new_zeros((B * S, D))
    return out.index_add(0, (st + S * group).reshape(-1),
                         picked * w).reshape(B, S, D)


def apply_moe(params, x: torch.Tensor, cfg: MoEConfig,
              act: str) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss). Groups = sequences."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = max(1, int(S * K / E * cfg.capacity_factor))
    probs, gates, idx = route(params, x, cfg)
    expert_in, info = dispatch(x, gates.to(x.dtype), idx, E, C)
    out = combine(_expert_ffn(params, expert_in, act), info, S)
    if cfg.n_shared:
        out = out + apply_mlp(params["shared"], x, act)
    # Switch load-balance loss: E * sum_e f_e * p_e
    f = F.one_hot(idx[..., 0], E).float().mean(dim=(0, 1))
    pbar = probs.mean(dim=(0, 1))
    aux = cfg.aux_loss_weight * E * torch.sum(f * pbar)
    return out, aux
