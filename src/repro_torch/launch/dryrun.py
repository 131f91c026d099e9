"""Multi-pod dry-run (``repro/launch/dryrun.py``): build every (arch x
shape) cell on PyTorch's ``meta`` device at the production meshes and
count one rank's step.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape decode_32k --mesh single [--mode sac] [--out results/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # sweep

Each cell runs under a ``fake`` process group of the mesh's world (256
ranks for ``single``, 512 for ``multi``) with this process as rank 0:
the ``DeviceMesh``, the pooled fetch and every collective are the ones a
real rank 0 would make and issue, on tensors with shapes and no storage.
The step runs eagerly under ``distributed/cost_analysis.py::StepCost``,
which replaces the reference's HLO parsers: FLOPs (matmul family and the
hand-written kernels' analytic counts), bytes, collectives by kind,
operators and kernel calls, and the live storage's peak.

What one rank runs is the port's program, which differs from the
reference's partitioned one:

- the rank runs every layer with WHOLE weights (the port's models have
  no tensor parallelism) on its own lanes (the batch over the longest
  prefix of ``(pod, data)`` that divides it, as ``batch_axes_for``), with
  its slice of the pools' sequence axis (over ``model``, the sharded
  pool of ``core/pool.py``) in a decode, the whole prompt in a prefill
  (then cut to the slice by ``shard_serve_state``, as the port does), and
  no gradient all-reduce in a train step;
- so ``flops``, ``bytes`` and ``peak_bytes`` are that program's, and
  ``mem_per_device.argument_bytes`` is the reference's layout (each
  parameter's, optimizer state's, serve state's and batch's per-rank
  shard: every dim divided by the product of its mesh axes, from
  ``spec_for`` and the reference's state and batch specs, whatever the
  nesting order), with ``step_argument_bytes`` beside it, the inputs the
  port's rank really holds.

The record keeps the reference's keys (``hlo_flops`` and ``hlo_bytes``
are the counted FLOPs and bytes; ``lower_s`` is the build and
``compile_s`` the counted step, there being nothing to lower or
compile; ``xla_cost`` is null) and the three roofline terms at the H100
SXM's published peaks, named in ``peaks``:

    compute_s    = flops / 989e12            (bf16 dense tensor cores)
    memory_s     = bytes / 3.35e12           (HBM3)
    collective_s = collective_bytes / 450e9  (NVLink 4, one direction)

``build_cell(..., device="cuda")`` on a real mesh returns the same step
with materialized inputs (random bf16 weights from seed 0, zero pools,
``cache_len`` S - 1), which ``chip_smoke.py`` phase 18 counts on the card
beside the meta build.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses as _dc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.kernels import cost, ops
from repro_torch.training.optimizer import tree_leaves, tree_map

# the H100 SXM's published peaks (NVIDIA data sheet)
PEAK_FLOPS = cost.BF16_FLOP_PER_S        # 989e12 FLOP/s, bf16 dense
HBM_BW = cost.HBM_BYTES_PER_S            # 3.35e12 B/s, HBM3
ICI_BW = cost.NVLINK_BYTES_PER_S         # 450e9 B/s, NVLink 4 per direction
PEAKS = {"PEAK_FLOPS (H100 SXM, bf16 dense tensor cores)": PEAK_FLOPS,
         "HBM_BW (H100 SXM, HBM3, B/s)": HBM_BW,
         "ICI_BW (NVLink 4, one direction, B/s)": ICI_BW}


# ---------------------------------------------------------------------------
# sharding helpers
# ---------------------------------------------------------------------------


def _sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def np_prod_axes(mesh, axes) -> int:
    sizes = _sizes(mesh)
    p = 1
    for a in axes:
        p *= sizes.get(a, 1)
    return p


def batch_axes_for(mesh, batch: int):
    """Longest prefix of (pod, data) whose product divides batch."""
    sizes = _sizes(mesh)
    axes = []
    prod = 1
    for a in ("pod", "data"):
        if a in sizes and batch % (prod * sizes[a]) == 0:
            axes.append(a)
            prod *= sizes[a]
    return tuple(axes)


def _rec_pspec(shape, batch: int, model_size: int):
    """Heuristic spec for recurrent-state leaves: shard the batch axis,
    plus the first later axis divisible by the model-axis size."""
    spec = [None] * len(shape)
    b_ax = next((i for i, d in enumerate(shape) if d == batch), None)
    if b_ax is not None:
        spec[b_ax] = "__B__"
        for j in range(b_ax + 1, len(shape)):
            if shape[j] % model_size == 0 and shape[j] >= model_size:
                spec[j] = "model"
                break
    return spec


def _axes(entry):
    """A PartitionSpec entry (None, an axis, a tuple of axes) as
    ``spec_for`` gives it (None or a tuple)."""
    if entry is None:
        return None
    return (entry,) if isinstance(entry, str) else tuple(entry)


def serve_state_shardings(state_shapes, mesh, batch: int):
    """The reference's serve-state layout: for each leaf, its spec (per
    dim None or a tuple of mesh axes, as ``spec_for``): pools over the
    batch axes and ``model``, ``self_kv`` over the batch, ``rec_*`` by
    ``_rec_pspec``."""
    baxes = batch_axes_for(mesh, batch)
    b_entry = baxes if baxes else None
    model_size = _sizes(mesh)["model"]

    def one(path_key, leaf):
        shape = leaf.shape
        if path_key in ("kv_pool", "idx_pool"):
            return (None, _axes(b_entry), ("model",), None)
        if path_key == "self_kv":
            return (None, _axes(b_entry), None, None)
        if path_key in ("cache_len", "dec_len"):
            return (_axes(b_entry),)
        spec = _rec_pspec(shape, batch, model_size)
        return tuple(_axes(b_entry if s == "__B__" else s) for s in spec)

    out = {}
    for key, sub in state_shapes.items():
        if key in ("kv_pool", "idx_pool", "self_kv", "cache_len", "dec_len"):
            out[key] = one(key, sub)
        else:  # rec_* tuples
            out[key] = tree_map(lambda l: one("rec", l), sub)
    return out


def local_shape(shape, spec, mesh):
    """A leaf's per-rank shape: each dim divided by the product of its
    mesh axes' sizes (what ``NamedSharding.shard_shape`` gives, whatever
    the axes' order)."""
    sizes = _sizes(mesh)
    out = []
    for d, axes in zip(shape, spec):
        n = math.prod(sizes[a] for a in axes) if axes else 1
        if d % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split over "
                             f"{axes} ({n})")
        out.append(d // n)
    return tuple(out)


def local_tree(tree, specs, mesh, device="meta"):
    """The tree of per-rank empty tensors of ``tree`` under ``specs`` (a
    spec per leaf: the tuple stands whole beside its tensor)."""
    return tree_map(lambda t, s: torch.empty(
        local_shape(t.shape, s, mesh), dtype=t.dtype, device=device),
        tree, specs)


def _param_specs(specs_tree, mesh, rules):
    """``spec_for`` over a ParamSpec tree (placements would refuse the
    experts' (model, data) on a (data, model) mesh; the per-rank shape
    does not depend on the nesting order)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.layers import ParamSpec
    if isinstance(specs_tree, ParamSpec):
        return shd.spec_for(specs_tree.dims, specs_tree.shape, mesh, rules)
    if isinstance(specs_tree, dict):
        return {k: _param_specs(v, mesh, rules) for k, v in specs_tree.items()}
    return [_param_specs(v, mesh, rules) for v in specs_tree]


def tree_bytes(tree) -> int:
    """Bytes of a tree's tensors, each storage once."""
    seen = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


# ---------------------------------------------------------------------------
# cell construction
# ---------------------------------------------------------------------------


def parse_opts(env: Optional[str] = None) -> Dict:
    """REPRO_OPTS="hier_topk=1,pool_closure=1,moe_groups=32" -> dict."""
    s = env if env is not None else os.environ.get("REPRO_OPTS", "")
    out: Dict = {}
    for kv in s.split(","):
        if "=" not in kv:
            continue
        k, v = kv.split("=", 1)
        out[k.strip()] = int(v) if v.strip().isdigit() else v.strip()
    return out


@contextlib.contextmanager
def fake_world(world_size: int):
    """A ``fake`` process group of ``world_size`` ranks, this process
    rank 0 (no rank runs, no collective moves a byte)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def build_cell(arch: str, shape_name: str, mesh, mode: str = "sac",
               grad_accum: int = 8, opts: Optional[Dict] = None,
               device="meta"):
    """Returns (step_fn, in_shardings, in_specs, meta) for one cell.

    ``in_specs``: the inputs this rank's step takes (its lanes, its pool
    slice, whole weights), on ``device``: empty on ``meta``, else
    materialized (weights from seed 0, zero state, ``cache_len`` S - 1,
    zero tokens).  ``in_shardings``: the reference's layout of the same
    inputs, a spec per leaf of the global trees in ``meta["global"]``
    (``layout_bytes`` reads both)."""
    from repro_torch.configs import SHAPES_BY_NAME, get_config
    from repro_torch.core.pool import local_fetch, make_pooled_fetch
    from repro_torch.core.topk import make_hierarchical_topk
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import (build_model, cell_is_supported,
                                          input_specs)
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_loop import make_train_step

    device = torch.device(device)
    opts = dict(parse_opts(), **(opts or {}))
    grad_accum = int(opts.get("grad_accum", grad_accum))
    cfg = get_config(arch)
    if opts.get("kv_quant"):
        cfg = _dc.replace(cfg, sac=_dc.replace(cfg.sac,
                                               kv_quant=opts["kv_quant"]))
    shape = SHAPES_BY_NAME[shape_name]
    skip = cell_is_supported(cfg, shape, mode)
    if skip:
        return None, None, None, {"skip": skip}

    baxes = batch_axes_for(mesh, shape.global_batch)
    rules = shd.TRAIN_RULES if shape.kind == "train" else shd.SERVE_RULES
    if shape.kind != "train" and not baxes:
        # batch unshardable (e.g. long_500k B=1): the data axis is idle, so
        # row-sharding weights over it is free capacity/bandwidth -- keep it
        rules = dict(rules, D=("data",))
    B_local = shape.global_batch // np_prod_axes(mesh, baxes)

    if shape.kind == "decode" and cfg.has_attention:
        fetch = make_pooled_fetch(mesh, batch_axes=baxes)
    else:
        fetch = local_fetch
    topk_fn = None
    if opts.get("hier_topk") and shape.kind == "decode" and cfg.sac.enabled:
        topk_fn = make_hierarchical_topk(mesh, cfg.sac.topk,
                                         batch_axes=baxes)
    if opts.get("moe_groups") == "auto":
        opts["moe_groups"] = int(np_prod_axes(mesh, baxes))
    model = build_model(cfg, fetch_fn=fetch, mode=mode, topk_fn=topk_fn,
                        opts=opts, device=device)

    meta = {"arch": arch, "shape": shape_name, "mode": model.mode,
            "kind": shape.kind, "opts": {k: v for k, v in opts.items()},
            "batch": shape.global_batch, "seq": shape.seq_len,
            "batch_axes": list(baxes), "lanes_per_rank": B_local}
    real = device.type != "meta"
    p_global = model.param_shapes()
    p_shard = _param_specs(model.specs, mesh, rules)
    if real:
        params = model.init(torch.Generator(device=device).manual_seed(0))
    else:
        params = p_global
    b_entry = (baxes,) if baxes else (None,)

    def batch_local(specs):
        return {k: (torch.zeros((B_local,) + tuple(v.shape[1:]),
                                dtype=v.dtype, device=device) if real
                    else torch.empty((B_local,) + tuple(v.shape[1:]),
                                     dtype=v.dtype, device=device))
                for k, v in specs.items()}

    if shape.kind == "train":
        if cfg.enc_dec:
            ga = min(grad_accum, shape.global_batch)
        else:
            ga = grad_accum if shape.global_batch % grad_accum == 0 else 1
        ga = math.gcd(ga, B_local)          # this rank's microbatches
        step = make_train_step(model, OptConfig(), ga)
        opt_state = init_opt_state(params)
        opt_shard = {"m": p_shard, "v": p_shard, "step": ()}
        batch_specs = input_specs(cfg, shape)
        bshard = {k: (b_entry + (("model",), None) if v.dim() == 3
                      else b_entry + (None,))
                  for k, v in batch_specs.items()}
        meta["grad_accum"] = ga
        meta["global"] = (p_global, init_opt_state(p_global), batch_specs)
        return step, (p_shard, opt_shard, bshard), \
            (params, opt_state, batch_local(batch_specs)), meta

    if shape.kind == "prefill":
        cut = cfg.has_attention and _sizes(mesh)["model"] > 1

        def step(params, batch):
            x = batch["frames"] if cfg.enc_dec else batch["tokens"]
            state, logits = model.prefill(params, x)
            if cut:         # the rank's slice of its whole-prompt pools
                state = shd.shard_serve_state(state, mesh)
            return state, logits
        batch_specs = input_specs(cfg, shape)
        bshard = {k: (b_entry + (("model",), None) if v.dim() == 3
                      else b_entry + (None,))
                  for k, v in batch_specs.items()}
        meta["global"] = (p_global, batch_specs)
        return step, (p_shard, bshard), (params, batch_local(batch_specs)), \
            meta

    # decode
    def step(params, state, tokens):
        return model.decode(params, state, tokens)
    S_local = shape.seq_len // (_sizes(mesh)["model"]
                                if cfg.has_attention else 1)
    specs = input_specs(cfg, shape, model=model)
    st_shard = serve_state_shardings(specs["state"], mesh,
                                     shape.global_batch)
    tok_shard = b_entry
    if real:
        state = model.init_serve_state(B_local, S_local)
        state["cache_len"].fill_(shape.seq_len - 1)
    else:
        state = model.serve_state_shapes(B_local, S_local)
    tokens = batch_local({"t": specs["tokens"]})["t"]
    meta["global"] = (p_global, specs["state"], specs["tokens"])
    meta["pool_rows_per_rank"] = S_local
    return step, (p_shard, st_shard, tok_shard), (params, state, tokens), meta


def layout_bytes(in_sh, meta, mesh) -> Dict[str, int]:
    """Per-rank bytes of the reference's layout (``in_sh`` over the
    global trees in ``meta["global"]``), by input: params, then the
    optimizer or serve state, then the batch or tokens."""
    names = {"train": ("params", "opt_state", "batch"),
             "prefill": ("params", "batch"),
             "decode": ("params", "state", "tokens")}[meta["kind"]]
    return {name: sum(t.numel() * t.element_size()
                      for t in tree_leaves(local_tree(tree, specs, mesh)))
            for name, tree, specs in zip(names, meta["global"], in_sh)}


def count_step(step, in_spec) -> Dict:
    """``step(*in_spec)`` once under ``StepCost`` (the inputs tracked
    first; ``kernels``: the wrappers' calls by name), the outputs' bytes,
    the seconds it took, and ``launches``: the kernels the step really
    launched (``ops.launch_counts``, empty on ``meta``)."""
    from repro_torch.distributed.cost_analysis import StepCost
    ops.reset_launch_counts()
    t0 = time.time()
    with StepCost() as counter:
        counter.track(in_spec)
        out = step(*in_spec)
    rec = counter.result()
    rec["output_bytes"] = tree_bytes(out)
    rec["launches"] = {k: n for k, n in ops.launch_counts().items() if n}
    rec["seconds"] = time.time() - t0
    return rec


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, mode: str,
             out_dir: Optional[str] = None, verbose: bool = True) -> Dict:
    """One cell at a production mesh, on ``meta`` under a ``fake`` group
    of its world: build, count, roofline; the record (also written to
    ``out_dir``)."""
    from repro_torch.configs import SHAPES_BY_NAME, get_config
    from repro_torch.launch.mesh import make_production_mesh

    world = 512 if multi_pod else 256
    with fake_world(world):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        t0 = time.time()
        step, in_sh, in_spec, meta = build_cell(arch, shape_name, mesh, mode)
        meta.setdefault("mode", mode)
        meta["mesh"] = "multi" if multi_pod else "single"
        meta["n_devices"] = world
        if step is None:
            meta["status"] = "skipped"
            if verbose:
                print(f"[dryrun] SKIP {arch} x {shape_name}: {meta['skip']}")
            _write(meta, arch, shape_name, out_dir)
            return meta
        t_build = time.time() - t0
        counts = count_step(step, in_spec)
        layout = layout_bytes(in_sh, meta, mesh)
    rec = record(meta, counts, layout, get_config(arch),
                 SHAPES_BY_NAME[shape_name], chips=world, t_build=t_build)
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} [{rec['mesh']}][{rec['mode']}]"
              f" OK build={t_build:.1f}s count={counts['seconds']:.1f}s")
        mem = rec["mem_per_device"]
        print(f"  memory: args={mem['argument_bytes']} (the port's rank "
              f"holds {mem['step_argument_bytes']}) peak={mem['peak_bytes']}")
        print(f"  counted: flops={rec['flops']:.4g} bytes={rec['bytes']:.4g}"
              f" ops={rec['ops']} collectives={rec['collective_counts']}")
        print(f"  roofline: compute={rec['compute_s']*1e3:.2f}ms"
              f" memory={rec['memory_s']*1e3:.2f}ms"
              f" collective={rec['collective_s']*1e3:.2f}ms"
              f" dominant={rec['dominant']}"
              f" useful={rec['useful_flops_ratio'] and round(rec['useful_flops_ratio'], 3)}")
    _write(rec, arch, shape_name, out_dir)
    return rec


def record(meta: Dict, counts: Dict, layout: Dict, cfg, shape, *,
           chips: int, t_build: float) -> Dict:
    """The reference's record from a counted step."""
    flops, nbytes = counts["flops"], counts["bytes"]
    compute_s = flops / PEAK_FLOPS
    memory_s = nbytes / HBM_BW
    collective_s = counts["collective_bytes"] / ICI_BW
    model_flops = _model_flops(cfg, shape)
    rec = {k: v for k, v in meta.items() if k != "global"}
    rec.update(
        status="ok", lower_s=round(t_build, 1),
        compile_s=round(counts["seconds"], 1),
        mem_per_device={
            "argument_bytes": sum(layout.values()),
            "output_bytes": counts["output_bytes"],
            "temp_bytes": counts["peak_bytes"] - counts["argument_bytes"],
            "peak_bytes": counts["peak_bytes"],
            "step_argument_bytes": counts["argument_bytes"],
            "layout": layout,
        },
        xla_cost={"flops": None, "bytes accessed": None},
        hlo_flops=flops, hlo_bytes=nbytes, flops=flops, bytes=nbytes,
        ops=counts["ops"], kernels=counts["kernels"],
        kernel_flops=counts["kernel_flops"],
        kernel_bytes=counts["kernel_bytes"],
        collective_bytes=counts["collective_bytes"],
        collective_breakdown=counts["collective_breakdown"],
        collective_counts=counts["collective_counts"],
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=max(("compute", compute_s), ("memory", memory_s),
                     ("collective", collective_s), key=lambda kv: kv[1])[0],
        model_flops=model_flops,
        useful_flops_ratio=(model_flops / chips / flops if flops else None),
        peaks=PEAKS)
    return rec


def _write(rec: Dict, arch: str, shape_name: str,
           out_dir: Optional[str]) -> None:
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    tag = os.environ.get("REPRO_TAG", "")
    tag = f"__{tag}" if tag else ""
    name = f"{arch}__{shape_name}__{rec['mesh']}__{rec['mode']}{tag}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1)


def _model_flops(cfg, shape) -> float:
    """MODEL_FLOPS convention: 6*N*D train (N_active for MoE), 2*N_active
    per generated token for decode, 2*N_active*tokens prefill (+ dense-
    attention quadratic term for attention archs on train/prefill)."""
    n_act = cfg.active_param_count()
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        base = 6 * n_act * B * S
        if cfg.has_attention:
            base += 6 * cfg.n_attn_layers * B * S * S * cfg.hd \
                * cfg.n_heads * 0.5
        return base
    if shape.kind == "prefill":
        base = 2 * n_act * B * S
        if cfg.has_attention:
            base += 2 * cfg.n_attn_layers * B * S * S * cfg.hd \
                * cfg.n_heads * 2 * 0.5
        return base
    # decode: one token per request
    base = 2 * n_act * B
    if cfg.has_attention and cfg.sac.enabled:
        k = cfg.sac.topk
        dims = (cfg.kv_lora_rank + cfg.qk_rope_dim) if cfg.mla \
            else 2 * cfg.n_kv_heads * cfg.hd
        base += 2 * cfg.n_attn_layers * B * (k * dims + S * cfg.sac.d_idx)
    return base


# ---------------------------------------------------------------------------
# sweep driver
# ---------------------------------------------------------------------------

SRC = Path(__file__).resolve().parents[2]


def sweep(args):
    """Run every cell in its own subprocess (a fresh ``fake`` group, crash
    isolation); the JSONs land in --out."""
    from repro_torch.configs import ASSIGNED, SHAPES

    archs = args.archs.split(",") if args.archs else ASSIGNED
    shapes = args.shapes.split(",") if args.shapes else [s.name for s in SHAPES]
    meshes = args.meshes.split(",") if args.meshes else ["single", "multi"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                out = os.path.join(args.out)
                marker = os.path.join(
                    out, f"{arch}__{shape}__{mesh_kind}__{args.mode}.json")
                if args.resume and os.path.exists(marker):
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape,
                       "--mesh", mesh_kind, "--mode", args.mode,
                       "--out", out]
                print(">>", " ".join(cmd), flush=True)
                r = subprocess.run(cmd, timeout=args.timeout, env=env)
                if r.returncode != 0:
                    failures.append((arch, shape, mesh_kind))
                    print(f"!! FAILED {arch} {shape} {mesh_kind}", flush=True)
    print(f"sweep done; {len(failures)} failures: {failures}")
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--mode", choices=["sac", "dense"], default="sac")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--archs", help="comma list for --all")
    ap.add_argument("--shapes", help="comma list for --all")
    ap.add_argument("--meshes", help="comma list for --all")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--timeout", type=int, default=3600)
    args = ap.parse_args(argv)
    if args.all:
        failures = sweep(args)
        sys.exit(1 if failures else 0)
    rec = run_cell(args.arch, args.shape, multi_pod=args.mesh == "multi",
                   mode=args.mode, out_dir=args.out)
    sys.exit(0 if rec.get("status") in ("ok", "skipped") else 1)


if __name__ == "__main__":
    main()
