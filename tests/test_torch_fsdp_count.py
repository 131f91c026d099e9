"""The training step under ``TRAIN_RULES`` counted (``launch/dryrun.py::
count_step``, ``distributed/cost_analysis.py::StepCost``) on ``fake``
process groups, on the CPU: reduced Qwen2 at mesh (data 2, model 4),
each rank on its blocks of the weights and AdamW moments and its lanes.

Held: its FLOPs a rank within ``FLOP_REL_TOL`` of the reference's
per-device ``hlo_metrics`` of its GSPMD-compiled train step at the same
mesh with the dry-run's ``TRAIN_RULES`` shardings
(``repro/launch/dryrun.py:171-199``); the only collectives that touch a
weight's storage are its rows' all-gathers over ``data`` (the forward's
and the activation checkpoint's recompute); one reduce-scatter over
``data`` for each row-split leaf the forward uses, counted by
``StepCost`` as the reference's kind, beside the reduce-scatters of the
residual split over the sequence; one all-reduce of the replicated
leaves' gradients (norm gammas, QKV biases) over ``data``; and the
dry-run's attention-family train and ``long_500k`` cells report
``tensor_parallel`` with their backward's collectives.
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
TB, TS = 4, 32           # global batch, tokens a row
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


def _step(m, device):
    """(step, params, opt_state, batch) of the rank at coordinate 0."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_loop import make_train_step
    if device == "meta":
        params = m.param_shapes()
    else:
        params = shd.init_shards(m.specs, torch.Generator().manual_seed(0),
                                 device)
    batch = {k: torch.zeros((TB // MESH[0], TS), dtype=torch.int32,
                            device=device) for k in ("tokens", "labels")}
    return (make_train_step(m, OptConfig(), 1), params,
            init_opt_state(params), batch)


def test_train_collectives_touch_weights_only_in_the_row_gather():
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import model_param_specs
    cfg = _qwen("repro_torch")
    specs = model_param_specs(cfg)
    with dryrun.fake_world(int(np.prod(MESH))):
        mesh = make_mesh(MESH, ("data", "model"), device="cpu")
        m = build_model(cfg, device="cpu")
        with shd.use_rules(shd.TRAIN_RULES, mesh):
            step, params, opt, batch = _step(m, "cpu")
            with _Collectives() as rec:
                step(params, opt, batch)
            blocks = {path: shd.block_shape(s) for path, s in
                      _paths(specs)}
            sums = {path: m.rank_cfg().tp.grad_sum_axes(s.dims, s.shape)
                    for path, s in _paths(specs)}
    weights = {t.untyped_storage().data_ptr(): t
               for t in tree_leaves(params)}
    for kind, tensors in rec.calls:
        for t in tensors:
            w = weights.get(t.untyped_storage().data_ptr())
            if w is not None:       # the rows' gather: 2 blocks over data
                assert kind == "all-gather", kind
                out = tensors[0]
                assert out.numel() * out.element_size() == \
                    2 * w.numel() * w.element_size()
    # the leaves whose rows split over data and that the forward uses
    # (the indexer's weights are the serve path's)
    rows = [p for p, s in _paths(specs) if "D" in s.dims
            and blocks[p][s.dims.index("D")] * MESH[0] ==
            s.shape[s.dims.index("D")] and "/idx/" not in p]
    # the other reduce-scatters are the residual's, split over the
    # sequence: [S/4, lanes, D] blocks (the reduce-scatter's layout)
    seq = (TS // MESH[1], TB // MESH[0], cfg.d_model)
    scattered = [tuple(ts[0].shape) for k, ts in rec.calls
                 if k == "reduce-scatter"]
    assert len([s for s in scattered if s != seq]) == len(rows) == 2 * 7 + 2
    # each row-parallel product and the embedding forward, each
    # sequence gather (q / k / v, the MLP, the logits) backward, and the
    # activation checkpoint's recompute of each layer's ``wo``
    assert scattered.count(seq) == 2 + 5 * cfg.n_layers
    replicated = sum(int(np.prod(blocks[p])) for p, s in _paths(specs)
                     if sums[p])
    # a layer: ln1, ln2 (64 each), the rank's blocks of bq (64 over model
    # 4), bk and bv (32 over 4); the final norm
    assert replicated == 2 * (2 * 64 + 16 + 2 * 8) + 64
    carried = [t for k, ts in rec.calls if k == "all-reduce"
               for t in ts[:1] if t.numel() == replicated]
    assert len(carried) == 1


def _paths(tree, path=""):
    from repro_torch.models.layers import ParamSpec
    if isinstance(tree, ParamSpec):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{path}/{k}")
    else:
        for i, v in enumerate(tree):
            yield from _paths(v, f"{path}/{i}")


_REFERENCE = textwrap.dedent("""
    import os, sys, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, sys.argv[1])
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.distributed import sharding as shd
    from repro.distributed.hlo_analysis import hlo_metrics
    from repro.models.model import build_model
    from repro.training.optimizer import OptConfig, init_opt_state
    from repro.training.train_loop import make_train_step
    TB, TS = int(sys.argv[2]), int(sys.argv[3])
    base = get_config("qwen2-1.5b").reduced()
    cfg = dataclasses.replace(base, sac=dataclasses.replace(base.sac,
                                                            d_idx=32))
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
    m = build_model(cfg)
    sds = jax.ShapeDtypeStruct
    with shd.use_rules(shd.TRAIN_RULES, mesh):
        p_sh = shd.params_shardings(m.specs, mesh, rules=shd.TRAIN_RULES)
        o_sh = {"m": p_sh, "v": p_sh, "step": NamedSharding(mesh, P())}
        b_sh = {k: NamedSharding(mesh, P(("data",), None))
                for k in ("tokens", "labels")}
        p = m.param_shapes()
        comp = jax.jit(make_train_step(m, OptConfig(), 1),
                       in_shardings=(p_sh, o_sh, b_sh)).lower(
            p, jax.eval_shape(init_opt_state, p),
            {k: sds((TB, TS), jnp.int32) for k in ("tokens", "labels")}
        ).compile()
    print("FLOPS", hlo_metrics(comp.as_text())["flops"])
""")


def test_train_flops_near_reference_hlo():
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(ROOT / "src"), str(TB),
         str(TS)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env)
    cfg = _qwen("repro_torch")
    with dryrun.fake_world(int(np.prod(MESH))):
        mesh = make_mesh(MESH, ("data", "model"), device="cpu")
        m = build_model(cfg, device="meta")
        with shd.use_rules(shd.TRAIN_RULES, mesh):
            step, params, opt, batch = _step(m, "meta")
            got = dryrun.count_step(step, (params, opt, batch))
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out
    want = float(out.split("FLOPS")[-1].split()[0])
    ratio = got["flops"] / want
    print("port / reference train FLOPs a rank under TRAIN_RULES:", ratio,
          got["collective_counts"])
    assert abs(ratio - 1) < FLOP_REL_TOL, ratio
    # the 16 row-split leaves' gradients and the residual's (the test
    # above)
    assert got["collective_counts"]["reduce-scatter"] == \
        16 + 2 + 5 * cfg.n_layers


def test_dryrun_train_and_long_cells_are_tensor_parallel():
    """Qwen2-1.5B's train_4k and long_500k cells at the single pod run on
    the rank's blocks: rows over ``data``, the residual split over the
    sequence in training and replicated over ``model`` in the decode;
    the train cell's backward reduce-scatters its row gradients."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device="cpu")
        for shape in ("train_4k", "long_500k"):
            step, in_sh, in_spec, meta = dryrun.build_cell(
                "qwen2-1.5b", shape, mesh)
            assert meta["tensor_parallel"] and meta["rows_over"] == ["data"]
            assert meta["residual_over_model"] == (
                "sequence" if shape == "train_4k" else "replicated")
            layout = dryrun.layout_bytes(in_sh, meta, mesh)
            held = dryrun.tree_bytes(in_spec[0]) + (
                dryrun.tree_bytes(in_spec[1]) if shape == "train_4k" else 0)
            want = layout["params"] + (layout["opt_state"]
                                       if shape == "train_4k" else 0)
            assert held == want, (shape, held, want)
