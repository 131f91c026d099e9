"""Checkpoints of a sharded train state: ``sharding.gather_params`` (the
inverse of ``shard_params``) makes each rank's blocks of the parameters
and AdamW moments whole, ``training/checkpoint.save`` writes the whole
arrays (as the reference saves its global arrays), and a world at
another mesh restores them and cuts its blocks with ``shard_params``.

A ``gloo`` world at (data 2, model 2) trains reduced Qwen2 one step
under ``TRAIN_RULES``, saves the state whole, and takes a second step
(the uninterrupted run).  Two worlds at (4, 1) and (1, 4) restore it:
the restored tree equals the saved one bit for bit, the blocks cut at
the new mesh gather back to it bit for bit, and their second step
matches the uninterrupted run (loss within ``LOSS_REL``, parameters
within ``PARAM_REL_L2``: the meshes sum their partial products in other
orders; the QKV biases, drawn as zeros, are all update, whose elements
take the sign of gradients that rounding can flip near zero, and are
left out).
"""
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

B, S = 4, 16
LOSS_REL = 1e-3
PARAM_REL_L2 = 1e-2


def _cfg():
    from repro_torch.configs import get_config
    return get_config("qwen2-1.5b").reduced()


def _batch(step):
    rng = np.random.default_rng(step)
    t = rng.integers(0, _cfg().vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _equal(a, b) -> bool:
    la, lb = list(_leaves(a)), list(_leaves(b))
    return len(la) == len(lb) and all(
        pa == pb and x.dtype == y.dtype and torch.equal(x, y)
        for (pa, x), (pb, y) in zip(la, lb))


def _rank_main(rank, world, init, shape, ckpt_dir, out_dir):
    torch.set_num_threads(1)
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    from repro_torch.training import checkpoint
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_loop import make_train_step
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        cfg = _cfg()
        m = build_model(cfg, device="cpu")
        whole0 = m.init(torch.Generator().manual_seed(0))
        d = mesh.get_local_rank("data")
        lanes = slice(d * B // shape[0], (d + 1) * B // shape[0])
        out = {}
        with shd.use_rules(shd.TRAIN_RULES, mesh):
            step = make_train_step(m, OptConfig(warmup_steps=1,
                                                total_steps=100))

            def run(params, opt, i):
                batch = {k: torch.from_numpy(v[lanes])
                         for k, v in _batch(i).items()}
                return step(params, opt, batch)

            def whole(params, opt):
                return {"params": shd.gather_params(params, m.specs),
                        "opt": {"m": shd.gather_params(opt["m"], m.specs),
                                "v": shd.gather_params(opt["v"], m.specs),
                                "step": opt["step"]}}

            like = {"params": whole0, "opt": init_opt_state(whole0)}
            if shape == (2, 2):
                params = shd.shard_params(whole0, m.specs)
                params, opt, _ = run(params, init_opt_state(params), 1)
                saved = whole(params, opt)
                if rank == 0:
                    checkpoint.save(ckpt_dir, 1, saved)
                dist.barrier()
                out["saved"] = saved
            else:
                restored, at, _ = checkpoint.restore(ckpt_dir, like)
                out["restored"], out["restored_step"] = restored, at
                params = shd.shard_params(restored["params"], m.specs)
                opt = {k: shd.shard_params(restored["opt"][k], m.specs)
                       for k in ("m", "v")}
                opt["step"] = restored["opt"]["step"]
                out["recut_equal"] = _equal(whole(params, opt), restored)
            params, opt, met = run(params, opt, 2)
            out["after"] = shd.gather_params(params, m.specs)
            out["loss"] = float(met["loss"])
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _world(tmp, shape, ckpt_dir):
    name = f"mesh{shape[0]}{shape[1]}"
    out_dir = tmp / name
    out_dir.mkdir()
    world = int(np.prod(shape))
    ctx = mp.start_processes(
        _rank_main, args=(world, f"file://{tmp / (name + '.rdv')}", shape,
                          str(ckpt_dir), str(out_dir)),
        nprocs=world, join=False, start_method="spawn")
    return ctx, out_dir, world


def _join(ctx, out_dir, world):
    while not ctx.join(timeout=300):
        pass
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def test_sharded_state_restores_at_other_meshes(tmp_path):
    ckpt = tmp_path / "ckpt"
    first = _join(*_world(tmp_path, (2, 2), ckpt))
    saved = first[0]["saved"]
    assert all(_equal(r["saved"], saved) for r in first)
    worlds = {shape: _world(tmp_path, shape, ckpt)
              for shape in ((4, 1), (1, 4))}
    for shape, w in worlds.items():
        for r, res in enumerate(_join(*w)):
            assert res["restored_step"] == 1
            assert _equal(res["restored"], saved), (shape, r)
            assert res["recut_equal"], (shape, r)
            err = abs(res["loss"] - first[0]["loss"]) / abs(first[0]["loss"])
            assert err <= LOSS_REL, (shape, r, err)
            for (p, a), (_, b) in zip(_leaves(res["after"]),
                                      _leaves(first[0]["after"])):
                if p.split("/")[-1] in ("bq", "bk", "bv"):
                    continue      # drawn as zeros: all sign-like update
                e = ((a.double() - b.double()).norm()
                     / b.double().norm()).item()
                assert e <= PARAM_REL_L2, (shape, r, p, e)
