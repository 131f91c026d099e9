"""The port's training step under ``TRAIN_RULES`` (each rank on its
blocks, ``distributed/tp.py``) against the reference's GSPMD train step,
on the CPU.

The reference runs in one subprocess with four host devices: its
``make_train_step`` ``jax.jit``-compiled with the dry-run's
``TRAIN_RULES`` shardings (``repro/launch/dryrun.py:171-199``: the
parameters' and both moments' ``params_shardings``, the batch over
``data``) at mesh (data 2, model 2).  The port runs the same step in a
``gloo`` world at the same mesh, each rank on its blocks
(``bridge.shards_from_jax`` of the same weights) and its lanes.  Reduced
Qwen2, one step from the same weights and batch.

Held: the loss and the gradient norm within ``METRIC_REL``, the gathered
parameters after the step within ``PARAM_REL_L2`` relative L2 (the step
at a learning rate of 1e-2, so that it moves a weight by about a tenth
of its scale and the limit weighs the update); a control, the port's
step with every gradient sum over the batch axes skipped, misses the
parameters' limit (``tests/test_torch_fsdp.py``'s).  The figures are
printed.
"""
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
MESH = (2, 2)
B, S = 4, 16
LR = 1e-2
METRIC_REL = 2e-2
PARAM_REL_L2 = 5e-2


def _cfg():
    from repro_torch.configs import get_config
    return get_config("qwen2-1.5b").reduced()


def _batch():
    rng = np.random.default_rng(0)
    t = rng.integers(0, _cfg().vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


_REFERENCE = textwrap.dedent("""
    import os, sys, pickle
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, sys.argv[3])
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.distributed import sharding as shd
    from repro.models.model import build_model
    from repro.training.optimizer import OptConfig, init_opt_state
    from repro.training.train_loop import make_train_step

    def as_jax(a):                        # bf16 crosses as its bits
        return jnp.asarray(a.view(jnp.bfloat16) if a.dtype == np.uint16
                           else a)

    inp = pickle.load(open(sys.argv[1], "rb"))
    cfg = get_config("qwen2-1.5b").reduced()
    m = build_model(cfg)
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    params = jax.tree.map(as_jax, inp["params"])
    with shd.use_rules(shd.TRAIN_RULES, mesh):
        p_sh = shd.params_shardings(m.specs, mesh, rules=shd.TRAIN_RULES)
        o_sh = {"m": p_sh, "v": p_sh, "step": NamedSharding(mesh, P())}
        b_sh = {k: NamedSharding(mesh, P(("data",), None))
                for k in ("tokens", "labels")}
        step = jax.jit(make_train_step(m, OptConfig(
            lr=inp["lr"], warmup_steps=1, total_steps=100), 1),
            in_shardings=(p_sh, o_sh, b_sh))
        placed = jax.device_put(params, p_sh)
        opt = jax.device_put(init_opt_state(params), o_sh)
        batch = jax.device_put({k: jnp.asarray(v)
                                for k, v in inp["batch"].items()}, b_sh)
        with mesh:
            new, _, met = step(placed, opt, batch)
    bits = lambda a: (np.asarray(a).view(np.uint16)
                      if a.dtype == jnp.bfloat16 else np.asarray(a))
    out = dict(params=jax.tree.map(bits, new),
               metrics={k: float(met[k]) for k in ("loss", "grad_norm")})
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


def _rank_main(rank, world, init, payload, out_dir):
    torch.set_num_threads(1)
    from repro_torch.bridge import params_to_numpy, shards_from_jax
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_loop import make_train_step
    from test_torch_fsdp import _skip_batch_reduction
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(MESH, ("data", "model"), device="cpu")
        p = torch.load(payload, weights_only=False)
        cfg = _cfg()
        m = build_model(cfg, device="cpu")
        params = shards_from_jax(p["params"], cfg, mesh, shd.TRAIN_RULES,
                                 "cpu")
        d = mesh.get_local_rank("data")
        lanes = slice(d * B // MESH[0], (d + 1) * B // MESH[0])
        batch = {k: torch.from_numpy(v[lanes]) for k, v in p["batch"].items()}
        out = {}
        with shd.use_rules(shd.TRAIN_RULES, mesh):
            step = make_train_step(m, OptConfig(lr=LR, warmup_steps=1,
                                                total_steps=100))
            new, _, met = step(params, init_opt_state(params), batch)
            out["params"] = params_to_numpy(shd.gather_params(new, m.specs),
                                            cfg)
            out["metrics"] = {k: float(v) for k, v in met.items()}
            with _skip_batch_reduction():
                new, _, _ = step(params, init_opt_state(params), batch)
            out["control"] = params_to_numpy(
                shd.gather_params(new, m.specs), cfg)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    a = np.asarray(tree)
    if a.dtype == np.uint16:               # bf16 bits
        a = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).float()\
            .numpy()
    return [a.astype(np.float64).ravel()]


def _rel_l2(got, want) -> float:
    g, w = np.concatenate(_flat(got)), np.concatenate(_flat(want))
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def test_train_step_near_reference_gspmd(tmp_path):
    from repro_torch.bridge import params_to_numpy
    from repro_torch.models.model import build_model
    cfg = _cfg()
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    jp = params_to_numpy(params, cfg)
    inp = dict(params=jp, batch=_batch(), lr=LR)
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(tmp_path / "inputs.pkl"),
         str(tmp_path / "ref.pkl"), str(ROOT / "src")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        payload = str(tmp_path / "payload.pt")
        torch.save(inp, payload)
        out_dir = tmp_path / "ranks"
        out_dir.mkdir()
        world = int(np.prod(MESH))
        mp.start_processes(_rank_main, args=(
            world, f"file://{tmp_path / 'rendezvous'}", payload,
            str(out_dir)), nprocs=world, start_method="spawn")
        out, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, out
    finally:
        if proc.poll() is None:
            proc.kill()
    with open(tmp_path / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    for r in range(world):
        got = torch.load(out_dir / f"rank{r}.pt", weights_only=False)
        errs = {k: abs(got["metrics"][k] - ref["metrics"][k])
                / abs(ref["metrics"][k]) for k in ("loss", "grad_norm")}
        p_err = _rel_l2(got["params"], ref["params"])
        c_err = _rel_l2(got["control"], ref["params"])
        moved = _rel_l2(jp, ref["params"])
        print(f"rank {r}: loss / grad_norm rel {errs}, params rel L2 "
              f"{p_err:.4g} (the step moved them {moved:.4g}), control "
              f"{c_err:.4g}")
        assert all(e <= METRIC_REL for e in errs.values()), errs
        assert p_err <= PARAM_REL_L2 < c_err, (p_err, c_err)
