"""Token-choice top-k MoE with capacity-based dispatch
(``repro/models/moe.py``).

Expert compute is E x C x (3 d f) with the reference's capacity
``C = max(int(K * T_group * cap_factor / E), 1)``: a token whose expert
is full is dropped for that expert, exactly as there.  Groups split the
tokens as the reference does; the batch of groups is a written-out
dimension and the per-group dispatch a Python loop.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamSpec, top_k


def moe_param_specs(cfg) -> Dict[str, ParamSpec]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamSpec((d, e), ("G", "E")),
        "w_gate": ParamSpec((e, d, f), ("E", "DE", "F")),
        "w_up": ParamSpec((e, d, f), ("E", "DE", "F")),
        "w_down": ParamSpec((e, f, d), ("E", "F", "DE")),
    }


def _dispatch_one(xt, probs, E: int, K: int, C: int):
    """Capacity dispatch for one token group.

    xt: [T, D]; probs: [T, E] -> (dispatched [E*C+1, D], slot [T*K],
    weight [T*K], aux)."""
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
    slot = torch.where(keep, flat_e * C + pos_in_e, E * C)      # sentinel
    # kept slots are distinct, so a copy equals the reference's
    # scatter-add; dropped lanes copy zeros into the sentinel row
    vals = xt.repeat_interleave(K, dim=0) * keep[:, None].to(xt.dtype)
    dispatched = xt.new_zeros(E * C + 1, D).index_copy_(0, slot, vals)
    w = gate_vals.reshape(-1) * keep.float()
    return dispatched, slot, w, aux


def moe_block(p, x, cfg, *, cap_factor: float = 1.25, groups: int = 1):
    """x: [B, S, D] -> ([B, S, D], aux_loss)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.topk_experts
    T = B * S
    groups = max(1, min(groups, T))
    while T % groups:
        groups //= 2
    Tg = T // groups
    C = max(int(K * Tg * cap_factor / E), 1)

    xt = x.reshape(groups, Tg, D)
    probs = torch.softmax((xt @ p["router"]).float(), dim=-1)   # [G, Tg, E]
    parts = [_dispatch_one(xt[g], probs[g], E, K, C) for g in range(groups)]
    dispatched = torch.stack([q[0] for q in parts])
    slot = torch.stack([q[1] for q in parts])
    w = torch.stack([q[2] for q in parts])
    aux = torch.stack([q[3] for q in parts])
    ex = dispatched[:, : E * C].reshape(groups, E, C, D)

    h = torch.einsum("gecd,edf->gecf", ex, p["w_gate"])
    h = F.silu(h) * torch.einsum("gecd,edf->gecf", ex, p["w_up"])
    out_e = torch.einsum("gecf,efd->gecd", h, p["w_down"])      # [G,E,C,D]

    flat_out = torch.cat([out_e.reshape(groups, E * C, D),
                          out_e.new_zeros(groups, 1, D)], dim=1)
    gathered = flat_out.gather(1, slot[..., None].expand(-1, -1, D))
    combined = (gathered * w[..., None].to(x.dtype)
                ).reshape(groups, Tg, K, D).sum(2)
    return combined.reshape(B, S, D), aux.mean()


def moe_decode(p, x, cfg, *, groups: int = 1):
    """Decode-time MoE for a single token per request (S=1)."""
    out, _ = moe_block(p, x[:, None, :], cfg, cap_factor=2.0, groups=groups)
    return out[:, 0, :]
