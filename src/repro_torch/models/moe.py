"""Token-choice top-k MoE with capacity-based dispatch
(``repro/models/moe.py``).

Expert compute is E x C x (3 d f) with the reference's capacity
``C = max(int(K * T_group * cap_factor / E), 1)``: a token whose expert
is full is dropped for that expert, exactly as there.  Groups split the
tokens as the reference does; the batch of groups is a written-out
dimension and the per-group dispatch a Python loop.

Expert parallelism (a config view with ``tp``, ``distributed/tp.py``):
the reference dispatches the whole global batch (its decode as one
group), so a rank all-gathers the tokens over the batch axes and every
rank computes the same dispatch, with the reference's groups and
capacity.  The router's E columns are all-gathered over the axes that
split them.  A rank holds its block of the experts (E over ``("model",
"data")`` where both divide, else over what divides), with their rows
(``DE``) and hidden columns (``F``) cut where the rules cut them: it
fills only its experts' slots, runs them (a rows block's partial gate /
up products all-reduced over the rows' axes before the SwiGLU, a hidden
block's outputs kept in f32), and adds its gated outputs into the token
set's; one all-reduce over every axis that splits the experts' work
sums the ranks' in f32, rounded once, and the rank keeps its own lanes.
The rows stay on the rank whatever the rules (a contraction over its
columns of the tokens, which are the same on every rank): the training
rules' ``DE`` over ``data`` splits the experts as the serve rules do.

Under autograd (the training step) each use of the whole token set and
of the router's probabilities by the rank's own experts or router
columns starts at ``tp.enter`` over the axes that make it the rank's:
the tokens' and the gates' gradients are summed over every rank whose
experts used them, the SwiGLU input's over the rows' ranks, and the
combined output's over the batch axes (``own_lanes``: each rank's lanes
carry their own gradient), never over ``model``, whose ranks hold the
same lanes.  So each rank's gradient of its experts and router columns
is the whole batch's, and the load-balance loss, the same on every rank,
counts once.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.distributed.tp import tp_of
from repro_torch.models.layers import ParamSpec, top_k


def moe_param_specs(cfg) -> Dict[str, ParamSpec]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamSpec((d, e), ("G", "E")),
        "w_gate": ParamSpec((e, d, f), ("E", "DE", "F")),
        "w_up": ParamSpec((e, d, f), ("E", "DE", "F")),
        "w_down": ParamSpec((e, f, d), ("E", "F", "DE")),
    }


def _dispatch_one(xt, probs, E: int, K: int, C: int, lo: int = 0,
                  n: int = 0):
    """Capacity dispatch for one token group, into the slots of experts
    [lo, lo + n) (all E by default; the others' tokens go to the
    sentinel, as dropped ones do).

    xt: [T, D]; probs: [T, E] -> (dispatched [n*C+1, D], slot [T*K],
    weight [T*K], aux)."""
    n = n or E
    T, D = xt.shape
    gate_vals, expert_ids = top_k(probs, K)                      # [T, K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    # load-balancing aux loss (Switch-style)
    me = probs.mean(0)
    flat_e = expert_ids.reshape(-1)                              # [T*K]
    ce = torch.zeros(E, device=xt.device).index_add_(
        0, flat_e, torch.ones(T * K, device=xt.device)) / (T * K)
    aux = E * torch.sum(me * ce)

    onehot = F.one_hot(flat_e, E).to(torch.int32)
    pos_in_e = (torch.cumsum(onehot, dim=0) - onehot)[
        torch.arange(T * K, device=xt.device), flat_e]
    keep = pos_in_e < C
    mine = keep if n == E else keep & (flat_e >= lo) & (flat_e < lo + n)
    slot = torch.where(mine, (flat_e - lo) * C + pos_in_e, n * C)  # sentinel
    # kept slots are distinct, so a copy equals the reference's
    # scatter-add; dropped lanes copy zeros into the sentinel row
    vals = xt.repeat_interleave(K, dim=0) * mine[:, None].to(xt.dtype)
    dispatched = xt.new_zeros(n * C + 1, D).index_copy_(0, slot, vals)
    w = gate_vals.reshape(-1) * keep.float()
    return dispatched, slot, w, aux


def moe_block(p, x, cfg, *, cap_factor: float = 1.25, groups: int = 1):
    """x: [B, S, D] -> ([B, S, D], aux_loss); over an expert-parallel
    rank ``x`` is its lanes and the groups split the whole batch."""
    tp = tp_of(cfg)
    x = tp.gather_lanes(x)
    B, S, D = x.shape
    E, K, Fh = cfg.n_experts, cfg.topk_experts, cfg.d_ff
    e, rows, f = (tp.split(("E", "DE", "F"), (E, D, Fh), i) for i in range(3))
    down = tp.split(("E", "F", "DE"), (E, Fh, D), 2)
    if down != rows:
        raise ValueError(f"w_gate's rows over {rows.axes}, w_down's "
                         f"columns over {down.axes}")
    T = B * S
    groups = max(1, min(groups, T))
    while T % groups:
        groups //= 2
    Tg = T // groups
    C = max(int(K * Tg * cap_factor / E), 1)

    xt = x.reshape(groups, Tg, D)
    axes = e.axes + f.axes + rows.axes    # the axes that split the work
    router = tp.split(("G", "E"), (D, E), 1)
    logits = tp.all_gather(tp.enter(xt, router.axes) @ p["router"],
                           router.axes)                         # [G, Tg, E]
    probs = torch.softmax(logits.float(), dim=-1)
    n = E // e.n                          # the rank's experts [lo, lo + n)
    xe = tp.enter(xt, axes)
    parts = [_dispatch_one(xe[g], probs[g], E, K, C, e.index * n, n)
             for g in range(groups)]
    dispatched = torch.stack([q[0] for q in parts])
    slot = torch.stack([q[1] for q in parts])
    w = tp.enter(torch.stack([q[2] for q in parts]), axes)
    aux = torch.stack([q[3] for q in parts])
    ex = dispatched[:, : n * C].reshape(groups, n, C, D)
    r0, r1 = rows.bounds(D)
    ex_in = ex if rows.n == 1 else ex[..., r0:r1]

    if rows.n > 1:      # partial over the rows' blocks, summed in f32
        hu = torch.einsum("gecd,sedf->sgecf", ex_in.float(), torch.stack(
            [p["w_gate"], p["w_up"]]).float())
        h, u = tp.enter(tp.all_reduce(hu, rows.axes), rows.axes).to(x.dtype)
    else:
        h = torch.einsum("gecd,edf->gecf", ex_in, p["w_gate"])
        u = torch.einsum("gecd,edf->gecf", ex_in, p["w_up"])
    h = F.silu(h) * u
    if f.n > 1:         # partial over the hidden blocks: kept in f32
        h = h.float()
    out_e = torch.einsum("gecf,efd->gecd", h, p["w_down"].to(h.dtype))
    if rows.n > 1:                  # the rank's block of the columns
        out_e = F.pad(out_e, (r0, D - r1))

    flat_out = torch.cat([out_e.reshape(groups, n * C, D),
                          out_e.new_zeros(groups, 1, D)], dim=1)
    gathered = flat_out.gather(1, slot[..., None].expand(-1, -1, D))
    gated = (gathered * w[..., None].to(out_e.dtype)
             ).reshape(groups, Tg, K, D)
    if tp.size(axes) == 1:
        combined = gated.sum(2)
    else:               # the ranks' gated outputs, summed in f32
        combined = tp.all_reduce(gated.float().sum(2), axes).to(x.dtype)
    return tp.own_lanes(combined.reshape(B, S, D)), aux.mean()


def moe_decode(p, x, cfg, *, groups: int = 1):
    """Decode-time MoE for a single token per request (S=1)."""
    out, _ = moe_block(p, x[:, None, :], cfg, cap_factor=2.0, groups=groups)
    return out[:, 0, :]
