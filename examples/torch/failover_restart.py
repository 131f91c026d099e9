"""Fault tolerance on the PyTorch/CUDA port
(``examples/failover_restart.py``): train, checkpoint, corrupt the
newest snapshot (a simulated torn write or node crash), restore onto a
re-meshed "cluster" (``distributed/elastic.py``), resume bit-exactly.

    PYTHONPATH=src python examples/torch/failover_restart.py    # card
    PYTHONPATH=src python examples/torch/failover_restart.py --device cpu

The re-mesh runs in a process group of one rank that the example starts
itself (NCCL on the card, gloo on the CPU) on a free localhost port.
The config is ``reduced()`` exactly: training runs no kernel.
"""
import argparse
import os
import socket
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.elastic import (SkipSlowReducer, remesh,
                                             reshard_tree)
from repro_torch.models.model import build_model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import batch_iterator
from repro_torch.training.optimizer import OptConfig, init_opt_state
from repro_torch.training.train_loop import make_train_step


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    cfg = get_config("granite-34b").reduced()
    model = build_model(cfg, device=dev)
    ocfg = OptConfig(lr=1e-3, warmup_steps=0, total_steps=20,
                     schedule="const")
    step = make_train_step(model, ocfg, 1)
    shape = ShapeConfig("ex", 32, 8, "train")

    params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt = init_opt_state(params)
    with tempfile.TemporaryDirectory() as d:
        it = batch_iterator(cfg, shape)
        for i in range(4):
            params, opt, m = step(params, opt, next(it))
            ckpt.save(d, i + 1, {"p": params, "o": opt},
                      extras={"data_step": i + 1})
        # the straight run's step 4, kept for the resume's check
        straight_loss = float(m["loss"])
        print(f"trained 4 steps, snapshots: {sorted(os.listdir(d))}")

        # simulate a torn write on the newest snapshot
        victim = os.path.join(d, "step_000000004", "arr_00000.npy")
        with open(victim, "wb") as f:
            f.write(b"torn write from a dying node")
        print("corrupted newest snapshot (node crash mid-write)")

        # restart: restore newest CONSISTENT snapshot
        restored, s, extras = ckpt.restore(d, {"p": params, "o": opt})
        print(f"restored step {s} (fell back past the corrupt snapshot)")
        assert s == 3 and extras["data_step"] == 3

        # elastic: re-mesh onto the surviving ranks and reshard
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method=f"tcp://localhost:"
                                f"{_free_port()}", rank=0, world_size=1)
        try:
            mesh = remesh(dist.get_world_size(), device=dev.type)
            reshard_tree(restored["p"], model.specs, mesh)
            print(f"resharded onto mesh "
                  f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}")
        finally:
            dist.destroy_process_group()

        # resume with the restored data cursor: bit-exact continuation
        p2, o2 = restored["p"], restored["o"]
        it2 = batch_iterator(cfg, shape, start_step=extras["data_step"])
        p2, o2, m2 = step(p2, o2, next(it2))
        resumed_loss = float(m2["loss"])
        print(f"resumed: step-4 loss (replayed) = {resumed_loss:.5f}")

    # straggler mitigation: drop the slow host, rescale the mean
    red = SkipSlowReducer(n_hosts=4)
    g = lambda v: {"w": np.full((2,), float(v))}  # noqa: E731
    grads, report = red.aggregate(0, {0: (g(1), 0.1), 1: (g(2), 0.1),
                                      2: (g(3), 0.12), 3: (g(9), 3.0)})
    print(f"straggler aggregation: kept {report.contributors}/4 hosts, "
          f"skipped {report.skipped}, grad mean {grads['w'][0]:.2f}")
    return straight_loss, resumed_loss


if __name__ == "__main__":
    main()
