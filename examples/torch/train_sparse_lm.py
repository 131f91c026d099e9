"""Train a small sparse-attention LM (MLA + lightning indexer weights)
on the PyTorch/CUDA port (``examples/train_sparse_lm.py``): the
end-to-end training driver.

    PYTHONPATH=src python examples/torch/train_sparse_lm.py [--steps 200]
    PYTHONPATH=src python examples/torch/train_sparse_lm.py --device cpu

The config is ``reduced()`` exactly on either device: the training
forward runs plain PyTorch layers (no kernel of the port has a
backward), so no kernel's width rule applies.
"""
import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.models.model import build_model
from repro_torch.training.data import batch_iterator
from repro_torch.training.optimizer import (OptConfig, init_opt_state,
                                            tree_leaves)
from repro_torch.training.train_loop import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="deepseek-v32")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    model = build_model(cfg, device=args.device)
    params = model.init(torch.Generator(device=args.device).manual_seed(0))
    n = sum(p.numel() for p in tree_leaves(params))
    print(f"training {cfg.name} (reduced): {n/1e6:.2f}M params, "
          f"WSD schedule, {args.steps} steps")

    opt = init_opt_state(params)
    ocfg = OptConfig(lr=2e-3, schedule="wsd",
                     warmup_steps=args.steps // 10, total_steps=args.steps)
    step = make_train_step(model, ocfg, grad_accum=2)
    it = batch_iterator(cfg, ShapeConfig("ex", 64, 16, "train"))
    t0 = time.time()
    losses = []
    for i in range(args.steps):
        params, opt, m = step(params, opt, next(it))
        losses.append(float(m["loss"]))
        if i % 20 == 0 or i == args.steps - 1:
            print(f"  step {i:4d}  loss {losses[-1]:.4f}  "
                  f"lr {float(m['lr']):.2e}  "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)")
    print("done — loss should have dropped by >1 nat on the synthetic "
          "zipf+copy stream")
    return losses


if __name__ == "__main__":
    main()
