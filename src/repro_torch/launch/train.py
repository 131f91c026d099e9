"""End-to-end training driver (``repro/launch/train.py``): the port's
training step on one CUDA card (the default) or, with ``--device cpu``,
on the CPU.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --steps 300 --batch 8 --seq 128 [--reduced] [--ckpt-dir ckpts] \
        [--resume] [--device cpu]

The flags, their defaults and the printed lines are the reference's,
plus ``--device``.  Parameters are drawn from ``torch.Generator`` seeded
with ``--seed`` on the device.  Fault tolerance: atomic checkpoints
every ``--ckpt-every`` steps (params, opt state, data cursor);
``--resume`` restarts from the newest consistent snapshot.
"""
from __future__ import annotations

import argparse
import time

import torch


def main(argv=None):
    """Parse ``argv`` (default: the command line) and train.  Returns
    ``(params, opt_state, history)`` for callers that drive the CLI
    in-process: ``history`` holds each step's ``step``, ``loss``, ``aux``,
    ``lr``, ``grad_norm`` and wall ``seconds`` (the step's, from the
    batch's move to the device to its loss on the host)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--schedule", default="wsd",
                    choices=["wsd", "cosine", "const"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.model import build_model
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.data import batch_iterator
    from repro_torch.training.optimizer import (OptConfig, init_opt_state,
                                                tree_leaves)
    from repro_torch.training.train_loop import make_train_step

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train --device cuda: no CUDA device is "
                           "available; pass --device cpu to train on the "
                           "CPU")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    opt_state = init_opt_state(params)
    opt_cfg = OptConfig(lr=args.lr, schedule=args.schedule,
                        warmup_steps=max(args.steps // 20, 5),
                        total_steps=args.steps)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")

    start_step = 0
    if args.resume and args.ckpt_dir and ckpt.latest_step(args.ckpt_dir):
        (state, start_step, extras) = ckpt.restore(
            args.ckpt_dir, {"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        print(f"[train] resumed from step {start_step}")

    batches = batch_iterator(cfg, shape, seed=args.seed,
                             start_step=start_step)
    step_fn = make_train_step(model, opt_cfg, args.grad_accum)

    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"[train] {cfg.name} params={n_params/1e6:.1f}M "
          f"batch={args.batch}x{args.seq} steps={args.steps}")
    history = []
    t0 = time.time()
    for i in range(start_step, args.steps):
        t_step = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state,
                                             next(batches))
        row = {k: float(v) for k, v in metrics.items()}
        history.append(dict(row, step=i,
                            seconds=time.perf_counter() - t_step))
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"  step {i:5d} loss={row['loss']:.4f} "
                  f"lr={row['lr']:.2e} "
                  f"gnorm={row['grad_norm']:.3f} "
                  f"({(time.time()-t0)/(i-start_step+1):.2f}s/step)",
                  flush=True)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, i + 1,
                      {"params": params, "opt": opt_state},
                      extras={"data_step": i + 1, "arch": cfg.name})
            ckpt.prune(args.ckpt_dir, keep=3)
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps,
                  {"params": params, "opt": opt_state},
                  extras={"data_step": args.steps, "arch": cfg.name})
    print("[train] done")
    return params, opt_state, history


if __name__ == "__main__":
    main()
