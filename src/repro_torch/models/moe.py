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

Sharded (``distributed/parallelize.py``): ``moe_axes`` puts the experts
over 'model' and their input dim over the data axes. Where the reference
takes its expert-parallel all-to-all (``_a2a_path_available`` and
``_moe_weight_dims_divide``), so does the port (``_apply_moe_a2a``):
each 'model' rank routes its chunk of the sequence (the layout splits
the sequence over 'model'), capacity-sorts it for every expert
(``dispatch``, one group, capacity per source shard), sends each
expert's slots to its owner (``all_to_all_single`` over 'model'), runs
its local experts on what it receives (their weights cast to the compute
dtype, then gathered over the data axes), sends the outputs back and
combines them for its own tokens. Otherwise (decode's one-token
sequence, a batch the data axes do not divide) the sequence is gathered
whole (its gradient reduce-scattered back) and every 'model' rank
dispatches the same tokens alike; where the rules keep the experts on
'model' (``n_experts`` divides it: the weights hold their block of the
expert dim) each rank runs only its experts on their slots of the
dispatch buffer and combines their weighted outputs for every token,
and the partial outputs are summed over 'model' in float32 (an
all-reduce, whose backward all-reduces the gradient): the reference's
``_expert_ffn`` constrains the expert dim to 'model', and GSPMD runs
the same program. Where they do not divide, the experts are gathered
whole and the single-device path runs on every rank. Each rank keeps its
chunk of the output. The shared experts run on the rank's chunk, as
``apply_mlp`` runs the dense MLP. The aux loss is the whole batch's (its
frequencies and mean probabilities averaged over the ranks that split
the tokens), each rank holding its share.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.search import topk_stable
from repro_torch.distributed import parallelize as par
from repro_torch.distributed.sharding import constrain, current_rules, \
    mesh_sizes
from repro_torch.models.layers import apply_mlp, dense_init, mlp_init
from repro_torch.utils import rank_within_run

# the stacked expert weights: the transformer's use-site cast leaves them
# to apply_moe, which gathers them as its path needs
EXPERT_KEYS = ("w_up", "w_gate", "w_down")


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


def moe_axes(cfg: MoEConfig, act: str) -> dict:
    a = {
        # the router is small: replicated
        "router": (None, None),
        "w_up": ("experts", "w_fsdp", "w_mlp"),
        "w_down": ("experts", "w_mlp", "w_fsdp"),
    }
    if act == "swiglu":
        a["w_gate"] = ("experts", "w_fsdp", "w_mlp")
    if cfg.n_shared:
        a["shared"] = {"w_up": ("w_fsdp", "w_mlp"),
                       "w_down": ("w_mlp", "w_fsdp")}
        if act == "swiglu":
            a["shared"]["w_gate"] = ("w_fsdp", "w_mlp")
    return a


def _experts(params, dtype: torch.dtype, keep=()) -> dict:
    """The expert weights cast to ``dtype`` (float32 masters), then
    gathered over every axis they are split on but ``keep``."""
    return {k: par.unshard(params[k], dtype, keep)
            for k in EXPERT_KEYS if k in params}


def _expert_ffn(params, x: torch.Tensor, act: str) -> torch.Tensor:
    """x: (B, E, C, D) -> (B, E, C, D), one batched product pair over the
    expert axis."""
    x = constrain(x, "batch", "experts", "expert_cap", "embed")
    up = torch.einsum("becd,edf->becf", x, params["w_up"])
    up = constrain(up, "batch", "experts", "expert_cap", "mlp")
    if act == "swiglu":
        gate = torch.einsum("becd,edf->becf", x, params["w_gate"])
        h = F.silu(gate) * up
    else:
        h = F.gelu(up, approximate="tanh")     # jax.nn.gelu's default
    out = torch.einsum("becf,efd->becd", h, params["w_down"])
    return constrain(out, "batch", "experts", "expert_cap", "embed")


def route(params, x: torch.Tensor, cfg: MoEConfig
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (probs (B, S, E) float32, gates (B, S, K) renormalised
    to sum 1, idx (B, S, K) expert ids). The logits are float32 products of
    the activations and the router as the layer holds it (the reference
    casts the router to the compute dtype with the rest of the layer)."""
    logits = x.float() @ par.unshard(params["router"]).float()
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


def combine(expert_out: torch.Tensor, info, S: int,
            first: int = 0) -> torch.Tensor:
    """(B, E_l, C, D) outputs of experts ``first`` .. ``first + E_l - 1``
    -> (B, S, D): each token's kept picks among them, weighted by their
    gates, summed (``_combine_one_group`` per group, where E_l is every
    expert)."""
    st, sg, slot, keep = info
    B, E, C, D = expert_out.shape
    group = torch.arange(B, device=expert_out.device)[:, None]
    flat = expert_out.reshape(B * E * C, D)
    local = slot - first * C
    mine = keep & (local >= 0) & (local < E * C)
    picked = flat[(torch.clamp(local, 0, E * C - 1)
                   + E * C * group).reshape(-1)]
    w = torch.where(mine, sg, 0.0).to(flat.dtype).reshape(-1, 1)
    out = expert_out.new_zeros((B * S, D))
    return out.index_add(0, (st + S * group).reshape(-1),
                         picked * w).reshape(B, S, D)


def _data_model_sizes(mesh) -> tuple[int, int]:
    sizes = mesh_sizes(mesh)
    dp = 1
    for a in ("pod", "data"):
        dp *= sizes.get(a, 1)
    return dp, sizes.get("model", 1)


def _a2a_path_available(cfg: MoEConfig, B: int, S: int) -> bool:
    """True when the explicit expert-parallel all-to-all path applies:
    a mesh with a 'model' axis is installed, experts divide across it,
    and the activation grid (B the whole batch) divides the mesh."""
    rules = current_rules()
    if rules is None or rules.mesh is None:
        return False
    if "model" not in rules.mesh.mesh_dim_names:
        return False
    dp, mp = _data_model_sizes(rules.mesh)
    return (cfg.n_experts % mp == 0 and B % dp == 0 and S % mp == 0
            and mp > 1)


def _moe_weight_dims_divide(params, mesh) -> bool:
    dp, _ = _data_model_sizes(mesh)
    return (params["w_up"].shape[1] % dp == 0
            and params["w_down"].shape[2] % dp == 0)


def _apply_moe_a2a(params, x: torch.Tensor, gates: torch.Tensor,
                   idx: torch.Tensor, cfg: MoEConfig,
                   act: str) -> torch.Tensor:
    """Expert parallelism over 'model' with two all-to-alls (the
    reference's ``shard_map`` body, on this rank's tokens).

    x (B_l, S_l, D) is this rank's rows and its chunk of their sequence
    (the layout splits the sequence over 'model'). The rank capacity-sorts
    its T tokens for all E experts with capacity ``max(1, int(T * K / E *
    cf))`` per source shard, exchanges the (E, C, D) slots
    destination-major, runs its E / mp experts on the (mp * C) slots each
    received, exchanges the outputs back and combines them for its own
    tokens."""
    mesh = current_rules().mesh
    _, mp = _data_model_sizes(mesh)
    g = par.group(mesh, "model")
    E, K = cfg.n_experts, cfg.top_k
    e_local = E // mp
    Bl, Sl, D = x.shape
    T = Bl * Sl
    C = max(1, int(T * K / E * cfg.capacity_factor))
    send, info = dispatch(x.reshape(1, T, D), gates.reshape(1, T, K),
                          idx.reshape(1, T, K), E, C)
    # (E, C, D) is destination-major: expert e lives on rank e // e_local
    recv = par.all_to_all(send.reshape(E * C, D), g)
    # grouped by source rank: (src, e_local, C, D) -> (e_local, src * C, D)
    recv = recv.reshape(mp, e_local, C, D).transpose(0, 1).reshape(
        e_local, mp * C, D)
    # cast to the compute dtype BEFORE the gather over the data axes
    w = _experts(params, x.dtype, keep=("experts",))
    up = torch.einsum("ecd,edf->ecf", recv, w["w_up"])
    if act == "swiglu":
        h = F.silu(torch.einsum("ecd,edf->ecf", recv, w["w_gate"])) * up
    else:
        h = F.gelu(up, approximate="tanh")
    eo = torch.einsum("ecf,efd->ecd", h, w["w_down"])
    # back: (e_local, src, C, D) -> (src, e_local * C, D)
    eo = eo.reshape(e_local, mp, C, D).transpose(0, 1).reshape(
        mp * e_local * C, D)
    back = par.all_to_all(eo, g).reshape(1, E, C, D)
    return combine(back, info, T).reshape(Bl, Sl, D)


def _local_experts(params, expert_in: torch.Tensor, info, S: int,
                   act: str, axes: tuple[str, ...]) -> torch.Tensor:
    """(B, S, D): this rank's experts (its block of the expert dim, split
    over ``axes``) run on their slots of the dispatch buffer ``expert_in``
    (the same on every rank of ``axes``), their picks combined for every
    token, and the partial outputs summed over ``axes``."""
    mesh = params["w_up"].device_mesh
    w = _experts(params, expert_in.dtype, keep=axes)
    n = w["w_up"].shape[0]
    first = par.line_index(mesh, axes) * n
    part = combine(_expert_ffn(w, expert_in[:, first:first + n], act),
                   info, S, first)
    return par.sum_shares(part, par.group(mesh, axes))


def apply_moe(params, x: torch.Tensor, cfg: MoEConfig,
              act: str) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss). Groups = sequences. Sharded, x is
    this rank's rows and chunk of their sequence, the output the same
    block, and the aux loss this rank's share of the whole batch's."""
    E, K = cfg.n_experts, cfg.top_k
    layout = par.current_layout()
    rows = (par.axes_size(layout.mesh, layout.batch_axes)
            if layout is not None and layout.batch_axes else 1)
    seq = layout.seq_axes if layout is not None else ()
    n_seq = par.axes_size(layout.mesh, seq) if seq else 1
    use_a2a = (_a2a_path_available(cfg, x.shape[0] * rows,
                                   x.shape[1] * n_seq)
               and seq == ("model",)
               and _moe_weight_dims_divide(params, current_rules().mesh))
    xs = x
    if not use_a2a:
        # the dispatch's sorts span a whole sequence: gather it first
        # (the reference's batch-only reshard)
        xs = constrain(par.gather_seq(x), "batch", "seq_kv", "embed")
    B, S, D = xs.shape
    probs, gates, idx = route(params, xs, cfg)
    if use_a2a:
        out = _apply_moe_a2a(params, xs, gates.to(x.dtype), idx, cfg, act)
    else:
        C = max(1, int(S * K / E * cfg.capacity_factor))
        expert_in, info = dispatch(xs, gates.to(x.dtype), idx, E, C)
        # the axes the placement splits the experts over (the rules'
        # "experts", where n_experts divides them): the tokens are the
        # same on each of their ranks here
        axes = par.split_dim_axes(params["w_up"], 0)
        if axes:
            out = _local_experts(params, expert_in, info, S, act, axes)
        else:
            out = combine(_expert_ffn(_experts(params, x.dtype), expert_in,
                                      act), info, S)
        if seq:
            # this rank's chunk (the others' gradient is zero here; the
            # gather sums every rank's back)
            out = out.narrow(1, par.seq_offset(x.shape[1]), x.shape[1])
    if cfg.n_shared:
        out = out + apply_mlp(params["shared"], x, act)
    # Switch load-balance loss: E * sum_e f_e * p_e, over the whole batch
    f = par.batch_mean(F.one_hot(idx[..., 0], E).float().mean(dim=(0, 1)))
    pbar = par.batch_mean(probs.mean(dim=(0, 1)))
    aux = par.batch_share(cfg.aux_loss_weight * E * torch.sum(f * pbar))
    return constrain(out, "batch", "seq", "embed"), aux
