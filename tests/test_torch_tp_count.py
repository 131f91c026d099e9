"""The tensor-parallel serving step counted (``launch/dryrun.py::
count_step``, ``distributed/cost_analysis.py::StepCost``) on ``fake``
process groups, on the CPU: the collectives a layer of reduced Qwen2's
TP decode, that no collective moves a weight, its FLOPs a rank against
the reference's per-device ``hlo_metrics`` of its GSPMD-compiled decode
at the same mesh (2, 4), and DeepSeek-V3.2 x decode_32k's rank at the
production single pod holding its ``spec_for`` blocks (9.38 GB of
weights, not 1.41 TB).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
MESH = (2, 4)
B, S = 4, 64             # global lanes and pool rows
# the port's FLOPs a rank over the reference's per device: the port
# counts its matmuls and its kernels' analytic FLOPs, XLA the dots of its
# partitioned HLO; they agree to 0.998 at whole weights
# (tests/test_torch_dryrun.py) and under TP alike (the ratio is printed)
FLOP_REL_TOL = 0.01


def _qwen(pkg):
    from importlib import import_module
    base = import_module(f"{pkg}.configs").get_config("qwen2-1.5b").reduced()
    return dataclasses.replace(base, sac=dataclasses.replace(base.sac,
                                                             d_idx=32))


class _Collectives(TorchDispatchMode):
    """Every collective's kind and tensors, as the dispatcher sees them."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from repro_torch.distributed.collectives import kind_of
        kind = kind_of(func)
        if kind is not None:
            self.calls.append((kind, [t for t in tree_leaves(args)
                                      if isinstance(t, torch.Tensor)]))
        return func(*args, **(kwargs or {}))


def _inject_topk(scores, cache_len, k: int = 16):
    j = torch.arange(k, dtype=torch.int32)[None]
    t = cache_len[:, None]
    return ((j * 7 + 3 * t) % torch.clamp(t, min=1)).to(torch.int32), \
        (j < t) & (j % 5 != 3)


def test_tp_decode_collectives_and_no_weight_moved():
    """Reduced Qwen2 at (data 2, model 4) over the sharded pool: a pool
    layer's three all-gathers (the scores, the k / v column blocks of
    half a head, the indexer's q) and three all-reduces (the fetch's
    rows, ``wo``'s and ``w_down``'s partial sums), the embedding's
    all-reduce and the logits' all-gather; no collective touches the
    storage of a weight block."""
    from repro_torch.core.pool import make_pooled_fetch
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    cfg = _qwen("repro_torch")
    with dryrun.fake_world(int(np.prod(MESH))):
        mesh = make_mesh(MESH, ("data", "model"), device="cpu")
        m = build_model(cfg, fetch_fn=make_pooled_fetch(mesh), device="cpu",
                        topk_fn=_inject_topk)
        with shd.use_rules(shd.SERVE_RULES, mesh):
            params = shd.init_shards(m.specs, torch.Generator().manual_seed(0),
                                     "cpu")
            state = m.init_serve_state(B // MESH[0], S // MESH[1])
            state["cache_len"].fill_(S - 8)
            with _Collectives() as rec:
                m.decode(params, state, torch.zeros(B // MESH[0],
                                                    dtype=torch.int32))
    kinds = [k for k, _ in rec.calls]
    L = cfg.n_layers
    assert kinds.count("all-gather") == 3 * L + 1
    assert kinds.count("all-reduce") == 3 * L + 1
    assert len(kinds) == 6 * L + 2
    weights = {t.untyped_storage().data_ptr() for t in tree_leaves(params)}
    for kind, tensors in rec.calls:
        for t in tensors:
            assert t.untyped_storage().data_ptr() not in weights, kind


_REFERENCE = textwrap.dedent("""
    import os, sys, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, sys.argv[1])
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.core.pool import make_pooled_fetch
    from repro.distributed import sharding as shd
    from repro.distributed.hlo_analysis import hlo_metrics
    from repro.models.model import build_model
    B, S = int(sys.argv[2]), int(sys.argv[3])
    base = get_config("qwen2-1.5b").reduced()
    cfg = dataclasses.replace(base, sac=dataclasses.replace(base.sac,
                                                            d_idx=32))
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
    m = build_model(cfg, fetch_fn=make_pooled_fetch(
        mesh, batch_axes=("data",)), mode="sac")
    st = m.serve_state_shapes(B, S)
    pool = NamedSharding(mesh, P(None, "data", "model", None))
    lanes = NamedSharding(mesh, P("data"))
    st_sh = {k: (pool if k in ("kv_pool", "idx_pool") else lanes)
             for k in st}
    with shd.use_rules(shd.SERVE_RULES, mesh):
        p_sh = shd.params_shardings(m.specs, mesh)
        comp = jax.jit(m.decode, in_shardings=(p_sh, st_sh, lanes)).lower(
            m.param_shapes(), st, jax.ShapeDtypeStruct((B,), jnp.int32)
        ).compile()
    print("FLOPS", hlo_metrics(comp.as_text())["flops"])
""")


def test_tp_flops_near_reference_hlo():
    from repro_torch.core.pool import make_pooled_fetch
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(ROOT / "src"), str(B),
         str(S)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env)
    cfg = _qwen("repro_torch")
    with dryrun.fake_world(int(np.prod(MESH))):
        mesh = make_mesh(MESH, ("data", "model"), device="cpu")
        m = build_model(cfg, fetch_fn=make_pooled_fetch(mesh), device="meta")
        with shd.use_rules(shd.SERVE_RULES, mesh):
            got = dryrun.count_step(m.decode, (
                m.param_shapes(), m.serve_state_shapes(B // MESH[0],
                                                       S // MESH[1]),
                torch.empty(B // MESH[0], dtype=torch.int32,
                            device="meta")))
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out
    want = float(out.split("FLOPS")[-1].split()[0])
    ratio = got["flops"] / want
    print("port / reference FLOPs a rank under TP:", ratio)
    assert abs(ratio - 1) < FLOP_REL_TOL, ratio


def test_deepseek_rank_holds_its_blocks_at_the_single_pod():
    """DeepSeek-V3.2 x decode_32k at (16, 16): the rank's weights are its
    ``spec_for`` blocks (9.38 GB), and what its step holds equals the
    reference's per-rank layout."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.transformer import model_param_specs
    rec = dryrun.run_cell("deepseek-v32", "decode_32k", multi_pod=False,
                          mode="sac", verbose=False)
    assert rec["status"] == "ok" and rec["tensor_parallel"]
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device="cpu")
        blocks = sum(
            int(np.prod(shd.block_shape(s, mesh, shd.SERVE_RULES))) * 2
            for s in tree_leaves(model_param_specs(get_config(
                "deepseek-v32")), is_leaf=lambda x: not isinstance(
                    x, (dict, list))))
    mem = rec["mem_per_device"]
    assert mem["layout"]["params"] == blocks
    assert abs(blocks / 9.38e9 - 1) < 1e-3, blocks
    assert mem["step_argument_bytes"] == mem["argument_bytes"]
    assert rec["useful_flops_ratio"] > 0.3
