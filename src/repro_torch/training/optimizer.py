"""AdamW with cosine / WSD (warmup-stable-decay, minicpm) schedules
(``repro/training/optimizer.py``).

Functional, as the reference: ``adamw_update`` returns new parameter and
state trees and changes none of its inputs.  The opt state is a tree
shaped like the parameters (the port's nested dicts and lists) with f32
moments whatever the parameter dtype, and an int32 step on the
parameters' device.  ``tree_leaves`` / ``tree_map`` walk such a tree in
one fixed order (dict keys sorted, as ``jax.tree`` orders them; lists in
order), which the training loop and the checkpoints share.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    schedule: str = "cosine"        # cosine | wsd | const
    warmup_steps: int = 100
    total_steps: int = 10_000
    stable_frac: float = 0.8        # WSD: fraction of post-warmup at peak lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    min_lr_frac: float = 0.1


def tree_leaves(tree) -> List[Any]:
    """The leaves of a nested dict / list / tuple tree: dict keys sorted,
    sequences in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same positions of the
    trees in ``rest``), keeping ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` (in ``tree_leaves``
    order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = dict.fromkeys(t)            # ``like``'s key order
            for k in sorted(t):
                out[k] = build(t[k])
            return out
        if isinstance(t, (list, tuple)):
            return type(t)([build(v) for v in t])
        return next(it)
    return build(like)


def schedule_lr(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int tensor or an int), f32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    total = max(cfg.total_steps, 1)
    if cfg.schedule == "const":
        frac = torch.ones_like(step)
    elif cfg.schedule == "wsd":
        # warmup -> stable plateau -> linear decay to min_lr (MiniCPM §4)
        stable_end = cfg.warmup_steps + cfg.stable_frac * (
            total - cfg.warmup_steps)
        decay = (step - stable_end) / max(total - stable_end, 1)
        frac = torch.where(step <= stable_end, torch.ones_like(step),
                           1.0 - (1.0 - cfg.min_lr_frac)
                           * torch.clamp(decay, 0, 1))
    else:  # cosine
        prog = torch.clamp((step - cfg.warmup_steps)
                           / max(total - cfg.warmup_steps, 1), 0, 1)
        frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * frac


def init_opt_state(params) -> Dict[str, Any]:
    """Zero f32 moments shaped like ``params`` and step 0 (int32), on
    the parameters' device."""
    device = tree_leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree, whole: Optional[Callable] = None) -> torch.Tensor:
    """The L2 norm of every leaf together, summed in f32.  ``whole``
    takes the leaves' squared sums stacked ([n]) and returns each
    leaf's over its whole tensor (a rank of the tensor-parallel step
    holds blocks: ``distributed/tp.py::TensorParallel.block_sums``)."""
    sq = [l.float().square().sum() for l in tree_leaves(tree)]
    if whole is not None:
        sq = list(whole(torch.stack(sq)).unbind())
    return torch.sqrt(sum(sq))


def adamw_update(params, grads, opt_state, cfg: OptConfig,
                 whole_norm: Optional[Callable] = None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step with global-norm clipping: (new params in their
    own dtypes, new opt state, {"lr", "grad_norm"}).  Leaf by leaf, so a
    rank's blocks of the parameters, gradients and moments update as the
    whole tensors would; the clipping norm is the whole model's
    (``global_norm``'s ``whole``)."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads, whole_norm)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule_lr(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g.square()
        mhat = m / b1c
        vhat = v / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
            + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(opt_state["m"]),
        tree_leaves(opt_state["v"]))]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    return new_p, {"m": new_m, "v": new_v, "step": step}, \
        {"lr": lr, "grad_norm": gnorm}
