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

Dispatch groups over the batch axes (the reference's ``("B", "Sq",
"G")`` constraint, ``moe_groups`` a multiple of the batch ranks, off
decode): where the batch axes are the minor axes of the experts' split,
a rank routes only its own lanes' groups (the router's E columns
gathered over the batch axes, its model column's block of the logits
all-gathered over the rest) and dispatches them into the slots of the
experts its model column holds.  One all-to-all over the batch axes
hands each rank every group's slots of its own experts, the same
[G, n, C, D] the gathered path dispatches on it; the experts run as
there; the reverse all-to-all brings each group's outputs back to its
rank, which gate-combines its lanes, and the column's ranks' sums are
added in f32 over the axes off the batch that split the work.  Where
no batch axis splits the experts (fewer experts than the model and data
ranks together), their rows are split over the batch axes instead: the
rank runs its own experts on its own groups with those rows gathered
(``tp.rows``), and no slot crosses.  No lane is gathered; ``aux`` is
all-reduced over the batch axes, so it stays the whole batch's mean.

With the residual split over the sequence (``tp.seq``: training and
prefill of the attention families) the block's input is the rank's
block of each lane's sequence: it is all-gathered first, so the groups
are the reference's over the whole sequence (``("B", "Sq", "G")``), and
the combine's sum over the axes that split the work becomes a
reduce-scatter back to the rank's block where the sequence's axes are
among them (else the rank takes its block of the sum).

Under autograd (the training step) each use of the whole token set and
of the router's probabilities by the rank's own experts or router
columns starts at ``tp.enter`` over the axes that make it the rank's:
the tokens' and the gates' gradients are summed over every rank whose
experts used them, the SwiGLU input's over the rows' ranks, and the
combined output's over the batch axes (``own_lanes``: each rank's lanes
carry their own gradient), never over ``model``, whose ranks hold the
same lanes.  On the grouped path the lanes are the rank's own, so those
sums run over the axes off the batch; the all-to-alls carry the slots'
gradients back to their groups' ranks, and the router's gathered columns
and the experts' gathered rows have theirs reduce-scattered over the
batch axes (a router whole over them is summed over them).  So each
rank's gradient of its experts and router columns is the whole batch's,
and the load-balance loss, the same on every rank, counts once.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.distributed.tp import WHOLE_SPLIT, tp_of
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


def _group_count(T: int, groups: int) -> int:
    """The reference's group count for ``T`` tokens."""
    groups = max(1, min(groups, T))
    while T % groups:
        groups //= 2
    return groups


def _experts(p, ex, tp, rows, f, dtype):
    """The rank's experts on their slots ``ex`` [G, n, C, D] -> [G, n, C,
    D]: a rows block's partial gate / up products summed in f32 over the
    rows' axes, a hidden block's outputs kept in f32, a rows block's
    output its block of the columns (the rest zeros)."""
    D = ex.shape[-1]
    r0, r1 = rows.bounds(D)
    ex_in = ex if rows.n == 1 else ex[..., r0:r1]
    if rows.n > 1:      # partial over the rows' blocks, summed in f32
        hu = torch.einsum("gecd,sedf->sgecf", ex_in.float(), torch.stack(
            [p["w_gate"], p["w_up"]]).float())
        h, u = tp.enter(tp.all_reduce(hu, rows.axes), rows.axes).to(dtype)
    else:
        h = torch.einsum("gecd,edf->gecf", ex_in, p["w_gate"])
        u = torch.einsum("gecd,edf->gecf", ex_in, p["w_up"])
    h = F.silu(h) * u
    if f.n > 1:         # partial over the hidden blocks: kept in f32
        h = h.float()
    out_e = torch.einsum("gecf,efd->gecd", h, p["w_down"].to(h.dtype))
    if rows.n > 1:                  # the rank's block of the columns
        out_e = F.pad(out_e, (r0, D - r1))
    return out_e


def _gate_sum(out_e, slot, w, K: int, tp, axes, dtype, shape):
    """Each token's gated expert outputs summed: ``out_e`` [G, m, C, D]
    the outputs of the slots that ``slot`` [G, Tg*K] indexes (``m*C``,
    the sentinel, a zero row), ``w`` [G, Tg*K] the gates.  Over ranks
    that each hold a part of the experts' work (``axes``) the ranks' sums
    are added in f32 and rounded once -> the tokens' ``shape`` [B, S, D];
    with the residual split over the sequence, the rank's block of S."""
    G, D = out_e.shape[0], out_e.shape[-1]
    flat_out = torch.cat([out_e.reshape(G, -1, D),
                          out_e.new_zeros(G, 1, D)], dim=1)
    gathered = flat_out.gather(1, slot[..., None].expand(-1, -1, D))
    gated = (gathered * w[..., None].to(out_e.dtype)).reshape(G, -1, K, D)
    if tp.size(axes) == 1:
        return tp.all_reduce(gated.sum(2).reshape(shape), axes, True)
    return tp.all_reduce(gated.float().sum(2).reshape(shape), axes,
                         True).to(dtype)


def _seq_uses(tp, *uses):
    """The sequence's axes where every one of ``uses`` (the axes over
    which a use of the gathered input is the rank's own) holds them (the
    gather's backward sums those), and each use's other axes (it enters
    over them)."""
    seq = tp.seq.axes
    if not all(set(seq) <= set(u) for u in uses):
        seq = ()
    return (seq,) + tuple(tuple(a for a in u if a not in seq) for u in uses)


def _grouped(tp, e, rows, G: int, Tg: int, D: int):
    """The split of the dispatch groups where they run over the batch
    axes (the reference's ``constrain(xt, ("B", "Sq", "G"))``), else
    None: the group dim is split over exactly the axes the lanes are, and
    either those are the minor axes of the experts' split (each rank of
    them holds its own block of its model column's experts: the slots
    cross by all-to-all) and the expert rows are whole over them, or no
    batch axis splits the experts and their rows are split over exactly
    the batch axes (gathered before use, as the dense rows are)."""
    batch = tp.batch_axes
    if tp.size(batch) == 1:
        return None
    g = tp.split(("B", "Sq", "G"), (G, Tg, D), 0)
    if g.axes != batch:
        return None
    if (e.axes[len(e.axes) - len(batch):] == batch
            and not set(rows.axes) & set(batch)):
        return g
    if not set(e.axes) & set(batch) and rows.axes == batch:
        return g
    return None


def moe_block(p, x, cfg, *, cap_factor: float = 1.25, groups: int = 1):
    """x: [B, S, D] -> ([B, S, D], aux_loss); over an expert-parallel
    rank ``x`` is its lanes and the groups split the whole batch."""
    tp = tp_of(cfg)
    nb = tp.size(tp.batch_axes)
    S, D = x.shape[1:]
    S *= tp.seq.n                         # the whole sequence
    E, K, Fh = cfg.n_experts, cfg.topk_experts, cfg.d_ff
    T = x.shape[0] * nb * S               # the whole batch's tokens
    G = _group_count(T, groups)
    Tg = T // G
    C = max(int(K * Tg * cap_factor / E), 1)
    e, rows, f = (tp.split(("E", "DE", "F"), (E, D, Fh), i) for i in range(3))
    down = tp.split(("E", "F", "DE"), (E, Fh, D), 2)
    if down != rows:
        raise ValueError(f"w_gate's rows over {rows.axes}, w_down's "
                         f"columns over {down.axes}")
    g = _grouped(tp, e, rows, G, Tg, D)
    if g is not None:
        return _moe_grouped(p, x, cfg, g, G, e, rows, f, C)
    axes = e.axes + f.axes + rows.axes    # the axes that split the work
    router = tp.split(("G", "E"), (D, E), 1)
    seq, work, routing = _seq_uses(tp, axes, router.axes)
    x = tp.gather_lanes(tp.gather_seq(x, seq))
    B = x.shape[0]

    xt = x.reshape(G, Tg, D)
    logits = tp.all_gather(tp.enter(xt, routing) @ p["router"],
                           router.axes)                         # [G, Tg, E]
    probs = torch.softmax(logits.float(), dim=-1)
    n = E // e.n                          # the rank's experts [lo, lo + n)
    xe = tp.enter(xt, work)
    parts = [_dispatch_one(xe[g], probs[g], E, K, C, e.index * n, n)
             for g in range(G)]
    dispatched = torch.stack([q[0] for q in parts])
    slot = torch.stack([q[1] for q in parts])
    w = tp.enter(torch.stack([q[2] for q in parts]), axes)
    aux = torch.stack([q[3] for q in parts])
    ex = dispatched[:, : n * C].reshape(G, n, C, D)
    out_e = _experts(p, ex, tp, rows, f, x.dtype)
    combined = _gate_sum(out_e, slot, w, K, tp, axes, x.dtype, (B, S, D))
    return tp.own_lanes(combined), aux.mean()


def _moe_grouped(p, x, cfg, groups, G: int, e, rows, f, C: int):
    """``moe_block`` with the G groups over the batch axes (``groups``:
    their split), on a rank's own lanes ``x`` [b, S, D]."""
    tp = tp_of(cfg)
    batch = tp.batch_axes
    E, K, Fh = cfg.n_experts, cfg.topk_experts, cfg.d_ff
    nb, n = groups.n, E // e.n            # batch ranks, experts a rank
    Gl = G // nb                          # the rank's groups
    trade = bool(set(e.axes) & set(batch))
    # the experts the rank dispatches into: its model column's
    # [lo, lo + m) (the batch axes are the minor ones of the experts'
    # split, so the column is contiguous), or its own block
    m = nb * n if trade else n
    lo = (e.index - groups.index if trade else e.index) * n
    off = tuple(a for a in e.axes + f.axes + rows.axes if a not in batch)
    D = x.shape[-1]
    router = tp.split(("G", "E"), (D, E), 1)
    r_off = tuple(a for a in router.axes if a not in batch)
    seq, work, routing = _seq_uses(tp, off, r_off)
    x = tp.gather_seq(x, seq)
    b, S = x.shape[:2]
    Tg = b * S * nb // G

    xt = x.reshape(Gl, Tg, D)
    # the router's columns gathered over the batch axes, or, whole over
    # them, used by every batch rank on its own lanes: its gradient summed
    w_r = (tp.all_gather(p["router"], batch, dim=1, reduce=True) if trade
           else tp.enter(p["router"], batch))
    logits = tp.all_gather(tp.enter(xt, routing) @ w_r,
                           r_off)                               # [Gl, Tg, E]
    probs = torch.softmax(logits.float(), dim=-1)
    xe = tp.enter(xt, work)
    parts = [_dispatch_one(xe[g], probs[g], E, K, C, lo, m)
             for g in range(Gl)]
    dispatched = torch.stack([q[0] for q in parts])
    slot = torch.stack([q[1] for q in parts])
    w = tp.enter(torch.stack([q[2] for q in parts]), off)
    aux = tp.all_reduce(torch.stack([q[3] for q in parts]).sum(), batch) / G
    if trade:           # every group's slots of the rank's experts, and back
        send = dispatched[:, :m * C].reshape(Gl, nb, n * C, D)
        ex = tp.all_to_all(send.transpose(0, 1), batch, 0)  # [nb, Gl, ...]
        out_e = _experts(p, ex.reshape(G, n, C, D), tp, rows, f, x.dtype)
        out_e = tp.all_to_all(out_e.reshape(nb, Gl, n * C, D), batch,
                              0).transpose(0, 1)
    else:               # the rank's own experts, their rows gathered
        pw = {k: tp.rows(p[k], dims, (E,) + shape) for k, dims, shape
              in (("w_gate", ("E", "DE", "F"), (D, Fh)),
                  ("w_up", ("E", "DE", "F"), (D, Fh)),
                  ("w_down", ("E", "F", "DE"), (Fh, D)))}
        out_e = _experts(pw, dispatched[:, :n * C].reshape(Gl, n, C, D), tp,
                         WHOLE_SPLIT, f, x.dtype)
    return _gate_sum(out_e, slot, w, K, tp, off, x.dtype, (b, S, D)), aux


def moe_decode(p, x, cfg, *, groups: int = 1):
    """Decode-time MoE for a single token per request (S=1)."""
    out, _ = moe_block(p, x[:, None, :], cfg, cap_factor=2.0, groups=groups)
    return out[:, 0, :]
