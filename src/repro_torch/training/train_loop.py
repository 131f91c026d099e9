"""Training step (``repro/training/train_loop.py``): loss, gradients by
``torch.autograd`` (the reference's ``value_and_grad``), gradient
accumulation over microbatches, clipping + AdamW, metrics.

``make_train_step(model, opt_cfg, grad_accum)`` returns a function
``(params, opt_state, batch) -> (params, opt_state, metrics)`` that, as
the reference's, changes none of its inputs.  A batch holds numpy arrays
or tensors (``tokens`` / ``labels``, and ``frames`` for an
encoder-decoder); they are moved to the parameters' device.  The
forward runs the plain PyTorch layers (no kernel of the port has a
backward, as no Pallas kernel of the reference has one).

Under ``sharding.use_rules(TRAIN_RULES, mesh)`` the step runs on this
rank's blocks of the parameters and of the AdamW moments (ZeRO's
sharding of both, ``distributed/tp.py``) and on its lanes of the batch
(its slice over the batch axes; the microbatches of gradient
accumulation are the rank's lanes).  Each rank's loss is the mean over
its lanes scaled by its share of the global lanes, so the global loss is
the sum over the batch ranks; the MoE load-balance loss is the whole
batch's on every rank and counts once.  The gradient of a row block
gathered for the forward is reduce-scattered over ``data`` by its
backward; every other leaf's is summed over the batch axes its block is
not split over (``reduce_grads``); the clipping norm is the whole
model's, each distinct block counted once.  At a world of one the step
is the unsharded step bit for bit.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.distributed.tp import TensorParallel, tp_of
from repro_torch.training.optimizer import (OptConfig, adamw_update,
                                            tree_leaves, tree_map,
                                            tree_unflatten)

AUX_COEF = 0.01  # MoE load-balance loss weight


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """logits [B,S,V] f32, labels [B,S] int -> mean loss.  The label's
    logit is gathered: exactly the value of the reference's one-hot dot
    (every other product there is an exact 0), with no [B,S,V] one-hot."""
    logz = torch.logsumexp(logits, dim=-1)
    label_logit = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (logz - label_logit).mean()


def plan_of(model):
    """The tensor-parallel plan the model runs under here (``WHOLE``
    outside ``use_rules``, and for a model without one)."""
    rank_cfg = getattr(model, "rank_cfg", None)
    return tp_of(rank_cfg() if rank_cfg else model.cfg)


def make_loss_fn(model) -> Callable:
    cfg = model.cfg

    def loss_fn(params, batch):
        if cfg.enc_dec:
            logits, aux = model.forward(
                params, {"frames": batch["frames"], "tokens": batch["tokens"]})
        else:
            logits, aux = model.forward(params, batch["tokens"])
        loss = cross_entropy(logits, batch["labels"])
        tp = plan_of(model)
        share = tp.size(tp.batch_axes)     # this rank's lanes: 1/share
        total = loss if share == 1 else loss / share
        return total + AUX_COEF * aux, {"loss": loss, "aux": aux}

    return loss_fn


def reduce_grads(grads, specs, tp):
    """Each gradient leaf summed over the batch axes its block is not
    split over (``tp.grad_sum_axes``: the ranks of those axes took other
    lanes), one f32 all-reduce per set of axes, rounded once to the
    leaf's dtype; ``grads`` itself where no leaf needs one."""
    leaves, spec_leaves = tree_leaves(grads), tree_leaves(specs)
    groups: Dict[Tuple[str, ...], list] = {}
    for i, s in enumerate(spec_leaves):
        axes = tp.grad_sum_axes(s.dims, s.shape)
        if tp.size(axes) > 1:
            groups.setdefault(axes, []).append(i)
    if not groups:
        return grads
    out = list(leaves)
    for axes, idx in groups.items():
        flat = tp.all_reduce(torch.cat([leaves[i].float().reshape(-1)
                                        for i in idx]), axes)
        for i, part in zip(idx, flat.split([leaves[i].numel()
                                            for i in idx])):
            out[i] = part.view(leaves[i].shape).to(leaves[i].dtype)
    return tree_unflatten(grads, out)


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_grad_fn(model) -> Callable:
    """``(params, batch) -> (metrics, grads)``: the loss's gradient with
    respect to every parameter leaf (zeros for a leaf the loss does not
    use, as ``jax.grad`` gives), in the parameters' dtypes."""
    loss_fn = make_loss_fn(model)

    def grad_fn(params, batch):
        leaves = tree_leaves(params)
        live = tree_unflatten(params, [p.detach().requires_grad_()
                                       for p in leaves])
        with torch.enable_grad():
            total, metrics = loss_fn(live, batch)
            grads = torch.autograd.grad(total, tree_leaves(live),
                                        allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return ({k: v.detach() for k, v in metrics.items()},
                tree_unflatten(params, grads))

    return grad_fn


def make_step_grads(model, grad_accum: int = 1) -> Callable:
    """``(params, batch) -> (metrics, grads)``: the training step's
    gradients, summed in f32 over ``grad_accum`` microbatches of the
    batch's rows and averaged; under ``use_rules`` also summed over the
    batch axes (``reduce_grads``), with the global loss."""
    grad_fn = make_grad_fn(model)

    def step_grads(params, batch):
        tp = plan_of(model)
        batch = to_device(batch, tree_leaves(params)[0].device)
        if grad_accum == 1:
            metrics, grads = grad_fn(params, batch)
        else:
            # [B, ...] -> grad_accum microbatches of B/grad_accum rows;
            # gradients summed in f32
            b = next(iter(batch.values())).shape[0] // grad_accum
            grads, loss_sum, aux_sum = None, 0.0, 0.0
            for i in range(grad_accum):
                mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
                m, g = grad_fn(params, mb)
                grads = (tree_map(lambda x: x.float(), g) if grads is None
                         else tree_map(lambda a, x: a + x.float(), grads, g))
                loss_sum = loss_sum + m["loss"]
                aux_sum = aux_sum + m["aux"]
            grads = tree_map(lambda g: g / grad_accum, grads)
            metrics = {"loss": loss_sum / grad_accum,
                       "aux": aux_sum / grad_accum}
        if isinstance(tp, TensorParallel):
            grads = reduce_grads(grads, model.specs, tp)
            n = tp.size(tp.batch_axes)
            if n > 1:
                metrics["loss"] = tp.all_reduce(metrics["loss"] / n,
                                                tp.batch_axes)
        return metrics, grads

    return step_grads


def whole_norm_of(model) -> Optional[Callable]:
    """The clipping norm's ``whole`` (``optimizer.global_norm``) under the
    plan the model runs under: each leaf's squared sum over its whole
    tensor (``tp.block_sums``); None unsharded."""
    tp = plan_of(model)
    if not isinstance(tp, TensorParallel):
        return None
    shapes = [(s.dims, s.shape) for s in tree_leaves(model.specs)]
    return lambda sq: tp.block_sums(sq, shapes)


def make_train_step(model, opt_cfg: OptConfig, grad_accum: int = 1
                    ) -> Callable:
    step_grads = make_step_grads(model, grad_accum)

    def train_step(params, opt_state, batch):
        metrics, grads = step_grads(params, batch)
        params, opt_state, stats = adamw_update(params, grads, opt_state,
                                                opt_cfg, whole_norm_of(model))
        metrics.update(stats)
        return params, opt_state, metrics

    return train_step


def train_loop(model, params, opt_state, batches, opt_cfg: OptConfig,
               *, steps: int, grad_accum: int = 1,
               checkpoint_fn: Callable = None, checkpoint_every: int = 0,
               log_every: int = 10) -> Tuple[Any, Any, list]:
    """Host loop: iterate batches, call the step, checkpoint."""
    step_fn = make_train_step(model, opt_cfg, grad_accum)
    history = []
    for i in range(steps):
        batch = next(batches)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if i % log_every == 0 or i == steps - 1:
            history.append({k: float(v) for k, v in metrics.items()})
        if checkpoint_fn and checkpoint_every and (i + 1) % checkpoint_every == 0:
            checkpoint_fn(params, opt_state, i + 1)
    return params, opt_state, history
