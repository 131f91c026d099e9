"""The port's dry-run (``repro_torch.launch.dryrun``, the model-side
specs it builds on, ``distributed/{collectives,cost_analysis}.py`` and
``kernels/cost.py``) against the JAX reference, on the CPU.

What is held:
- for every (arch of ``ARCHS`` x shape of ``SHAPES``):
  ``cell_is_supported`` and ``_model_flops`` equal the reference's;
  ``input_specs`` (keys, shapes, dtypes) equal the reference's
  ``jax.eval_shape`` results, for decode also with a hot tier
  (``device_buffer`` > 0); ``param_shapes`` equal the reference's
  through ``bridge.py``'s layout mapping;
- ``batch_axes_for`` and ``parse_opts`` equal the reference's;
- the per-rank shapes of every cell's params, optimizer or serve state
  and batch at both production meshes equal ``NamedSharding(...)
  .shard_shape`` of the reference's ``build_cell`` (one subprocess with
  512 host devices, nothing lowered), the port's built under a ``fake``
  process group of 256 and 512 ranks;
- the counter's ground truth, the cases of ``tests/test_hlo_analysis.py``
  (one matmul, a loop of matmuls, a nested loop, no collective at one
  rank), and the pooled fetch's collectives on a fake (2, 2) group;
- on reduced Qwen2 with the indexer widened to 32 dims (the kernels'
  widths), the port's counted FLOPs within 10 % of the reference's
  ``hlo_metrics`` on its compiled decode step and its train step;
- ``kernels/cost.py`` gives ``PERF.md``'s published bounds at the row
  movers' and the indexer's data-independent shapes;
- ``chip_smoke.py`` phase 18's host side: (a)'s meta build and (b)'s
  pool of CLI processes, whose budget fails a cell it stops.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
# the port's counted FLOPs against the reference's HLO count
FLOP_REL_TOL = 0.10


def _ref_dryrun():
    """``repro.launch.dryrun``, imported without its module-level
    XLA_FLAGS (512 host devices) leaking into this process's later
    subprocesses (JAX here is already one device)."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return dryrun


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _flat(tree, path=""):
    """{jax keystr path: (shape, dtype)} of a port tree (dicts, lists,
    tuples of tensors), in the reference's key format."""
    if isinstance(tree, torch.Tensor):
        return {path: (tuple(tree.shape), _dtype_name(tree.dtype))}
    if isinstance(tree, dict):
        keys = [(f"[{k!r}]", v) for k, v in tree.items()]
    elif hasattr(tree, "_fields"):                 # the hot tier
        keys = [(f".{k}", v) for k, v in zip(tree._fields, tree)]
    else:
        keys = [(f"[{i}]", v) for i, v in enumerate(tree)]
    out = {}
    for k, v in keys:
        out.update(_flat(v, path + k))
    return out


def _jflat(tree):
    import jax
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): (tuple(l.shape), str(l.dtype))
            for p, l in leaves}


def _cells():
    from repro_torch.configs import ARCHS, SHAPES
    return [(a, s.name) for a in sorted(ARCHS) for s in SHAPES]


# ---------------------------------------------------------------------------
# every cell: skip reasons, model FLOPs, input specs, parameter shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(
    __import__("repro_torch.configs", fromlist=["ARCHS"]).ARCHS))
def test_cells_equal_reference(arch):
    from repro.configs import SHAPES_BY_NAME as JSHAPES
    from repro.configs import get_config as jget
    from repro.models import model as jmodel
    from repro_torch.bridge import params_to_numpy
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import model as tmodel
    jdry = _ref_dryrun()
    cfg, jcfg = get_config(arch), jget(arch)
    tm = tmodel.build_model(cfg, device="cpu")
    jm = jmodel.build_model(jcfg)
    got = _flat(params_to_numpy(tm.param_shapes(), cfg))
    assert got == _jflat(jm.param_shapes())
    for shape in SHAPES:
        js = JSHAPES[shape.name]
        for mode in ("sac", "dense"):
            assert tmodel.cell_is_supported(cfg, shape, mode) == \
                jmodel.cell_is_supported(jcfg, js, mode)
        assert dryrun._model_flops(cfg, shape) == \
            jdry._model_flops(jcfg, js)
        got = tmodel.input_specs(cfg, shape, model=tm)
        want = jmodel.input_specs(jcfg, js, model=jm)
        assert _flat(got) == _jflat(want), shape.name
        assert all(t.is_meta for t in _flat_tensors(got))
        if shape.kind == "decode":
            got = tmodel.decode_input_specs(tm, shape, device_buffer=64)
            want = jmodel.decode_input_specs(jm, js, device_buffer=64)
            assert _flat(got) == _jflat(want), shape.name


def _flat_tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    vals = tree.values() if isinstance(tree, dict) else tree
    return [t for v in vals for t in _flat_tensors(v)]


class _Mesh:
    """A mesh's names and sizes, as both packages' helpers read them."""

    def __init__(self, names, shape):
        self.mesh_dim_names = self.axis_names = names
        self.shape = shape
        self.devices = np.empty(shape)


def test_batch_axes_and_opts_equal_reference():
    from repro_torch.launch import dryrun
    jdry = _ref_dryrun()
    for names, shape in ((("data", "model"), (16, 16)),
                         (("pod", "data", "model"), (2, 16, 16)),
                         (("data", "model"), (2, 2))):
        mesh = _Mesh(names, shape)
        for batch in (1, 2, 8, 16, 32, 128, 256, 6):
            assert dryrun.batch_axes_for(mesh, batch) == \
                jdry.batch_axes_for(mesh, batch)
            assert dryrun.np_prod_axes(mesh, ("pod", "data")) == \
                jdry.np_prod_axes(mesh, ("pod", "data"))
        for shape_ in ((28, 4, 32, 64), (13, 6, 8, 16, 32), (3, 1, 5)):
            for batch in (4, 8, 1):
                assert dryrun._rec_pspec(shape_, batch, shape[-1]) == \
                    jdry._rec_pspec(shape_, batch, shape[-1])
    for env in ("", "hier_topk=1,pool_closure=1,moe_groups=32",
                "moe_groups=auto, kv_quant=fp8,x", "a=1,=2,b"):
        assert dryrun.parse_opts(env) == jdry.parse_opts(env)


# ---------------------------------------------------------------------------
# per-rank shapes at the production meshes
# ---------------------------------------------------------------------------

_REFERENCE = textwrap.dedent("""
    import os, sys, pickle
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import jax
    from jax.sharding import NamedSharding
    from repro.configs import ARCHS, SHAPES
    from repro.launch import dryrun
    from repro.launch.mesh import make_production_mesh

    def shards(sh_tree, spec_tree):
        specs = jax.tree_util.tree_flatten_with_path(spec_tree)[0]
        shs = jax.tree_util.tree_leaves(
            sh_tree, is_leaf=lambda x: isinstance(x, NamedSharding))
        assert len(specs) == len(shs)
        return {jax.tree_util.keystr(p): tuple(sh.shard_shape(s.shape))
                for (p, s), sh in zip(specs, shs)}

    out = {}
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        for arch in sorted(ARCHS):
            for shape in SHAPES:
                step, in_sh, in_spec, meta = dryrun.build_cell(
                    arch, shape.name, mesh)
                key = (arch, shape.name, multi)
                out[key] = None if step is None else [
                    shards(a, b) for a, b in zip(in_sh, in_spec)]
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
""")


def _port_shards(multi: bool):
    """(arch, shape, multi) -> [{path: per-rank shape}] of the port's
    cells at a production mesh, in the reference's layouts."""
    from repro_torch.bridge import params_to_numpy
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    def shapes(tree):
        return {k: s for k, (s, _) in _flat(tree).items()}

    out = {}
    with dryrun.fake_world(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device="cpu")
        for arch, shape in _cells():
            cfg = get_config(arch)
            step, in_sh, _, meta = dryrun.build_cell(arch, shape, mesh)
            if step is None:
                out[arch, shape, multi] = None
                continue
            local = [dryrun.local_tree(t, s, mesh)
                     for t, s in zip(meta["global"], in_sh)]
            local[0] = params_to_numpy(local[0], cfg)
            if meta["kind"] == "train":
                local[1] = dict(local[1],
                                m=params_to_numpy(local[1]["m"], cfg),
                                v=params_to_numpy(local[1]["v"], cfg))
            out[arch, shape, multi] = [shapes(t) for t in local]
    return out


def test_per_rank_shapes_equal_reference(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE,
                             str(tmp_path / "ref.pkl")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=env)
    try:
        got = {**_port_shards(False), **_port_shards(True)}
        out, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, out
    finally:
        if proc.poll() is None:
            proc.kill()
    with open(tmp_path / "ref.pkl", "rb") as f:
        want = pickle.load(f)
    assert set(got) == set(want)
    for key in want:
        assert got[key] == want[key], key
    # the DeepSeek-V3.2 MoE cells build: experts over (model, data)
    moe = got["deepseek-v32", "decode_32k", False][0]
    assert moe["['segments'][0]['mlp']['w_gate']"][:2] == (61, 1)


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_counter_single_matmul():
    from repro_torch.distributed.cost_analysis import StepCost
    M, K, N = 64, 128, 32
    a, b = _meta(M, K), _meta(K, N)
    with StepCost() as c:
        c.track((a, b))
        a @ b
    r = c.result()
    assert r["flops"] == 2 * M * K * N
    assert r["bytes"] == 4 * (M * K + K * N + M * N)
    assert (r["ops"], r["argument_bytes"]) == (1, 4 * (M * K + K * N))
    assert r["peak_bytes"] == r["bytes"]


def test_counter_loop_and_nested_loop():
    from repro_torch.distributed.cost_analysis import StepCost
    N, L = 128, 7
    x, w = _meta(N, N), _meta(L, N, N)
    with StepCost() as c:
        for i in range(L):
            x = torch.tanh(x @ w[i])
    assert c.result()["flops"] == 2 * N ** 3 * L
    N, L1, L2 = 64, 3, 5
    x, w = _meta(N, N), _meta(L1, L2, N, N)
    with StepCost() as c:
        for i in range(L1):
            for j in range(L2):
                x = torch.tanh(x @ w[i, j])
    r = c.result()
    assert r["flops"] == 2 * N ** 3 * L1 * L2
    assert r["ops"] == 2 * L1 * L2          # the matmuls and the tanhs


def test_counter_no_collective_at_one_rank():
    from repro_torch.distributed.cost_analysis import StepCost
    x = _meta(32)
    with StepCost() as c:
        x * 2 + 1
    r = c.result()
    assert r["collective_bytes"] == 0 and r["collective_counts"] == {}
    assert r["flops"] == 0 and r["ops"] == 2


def test_pooled_fetch_collectives_on_fake_group():
    """Mesh (data 2, model 2) on a fake group: the fetch's one byte
    all-reduce of [B, k, d] and the scores' all-gather of [2 * B, n],
    counted by kind with their result bytes, and the kernel call."""
    from repro_torch.core.pool import make_pooled_fetch
    from repro_torch.distributed.cost_analysis import StepCost
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    B, S_l, d, k, n = 3, 40, 64, 16, 40
    with dryrun.fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        fetch = make_pooled_fetch(mesh)
        pool = _meta(B, S_l, d, dtype=torch.bfloat16)
        idx = _meta(B, k, dtype=torch.int32)
        scores = _meta(B, n)
        ops.reset_launch_counts()
        with StepCost() as c:
            rows = fetch(pool, idx)
            whole = fetch.shard.all_gather(scores)
    assert rows.shape == (B, k, d) and whole.shape == (B, 2 * n)
    r = c.result()
    assert r["collective_counts"] == {"all-reduce": 1, "all-gather": 1}
    assert r["collective_breakdown"] == {"all-reduce": B * k * d * 2,
                                         "all-gather": 2 * B * n * 4}
    assert r["collective_bytes"] == B * k * d * 2 + 2 * B * n * 4
    assert r["kernels"] == {"gather_kv.shard": 1}
    assert not any(ops.launch_counts().values())    # meta launches nothing


def test_decode_cell_counts_qwen2():
    """Qwen2-1.5B x decode_32k at the single pod: 28 all-gathers and 28
    all-reduces a step (one each a pool layer), one indexer, shard
    gather and GQA call a layer and one shard decode write (the kernels
    the card would launch; on meta none launches)."""
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell("qwen2-1.5b", "decode_32k", multi_pod=False,
                          mode="sac", verbose=False)
    assert rec["status"] == "ok"
    assert rec["collective_counts"] == {"all-gather": 28, "all-reduce": 28}
    assert rec["kernels"] == {"gather_kv.shard": 28, "indexer_scores": 28,
                              "sparse_attn_gqa": 28,
                              "scatter_kv.rows_at_shard": 1}
    assert rec["lanes_per_rank"] == 8 and rec["pool_rows_per_rank"] == 2048
    jkeys = ("arch", "shape", "mode", "kind", "opts", "batch", "seq", "mesh",
             "n_devices", "status", "lower_s", "compile_s", "mem_per_device",
             "xla_cost", "hlo_flops", "hlo_bytes", "collective_bytes",
             "collective_breakdown", "collective_counts", "compute_s",
             "memory_s", "collective_s", "dominant", "model_flops",
             "useful_flops_ratio")
    assert set(jkeys) <= set(rec)
    assert {"argument_bytes", "output_bytes", "temp_bytes",
            "peak_bytes"} <= set(rec["mem_per_device"])


# ---------------------------------------------------------------------------
# FLOPs against the reference's HLO count, reduced Qwen2
# ---------------------------------------------------------------------------


def _qwen(pkg):
    from importlib import import_module
    base = import_module(f"{pkg}.configs").get_config("qwen2-1.5b").reduced()
    return dataclasses.replace(base, sac=dataclasses.replace(base.sac,
                                                             d_idx=32))


def test_counted_flops_near_reference_hlo():
    import jax
    import jax.numpy as jnp
    from repro.distributed.hlo_analysis import hlo_metrics
    from repro.models.model import build_model as jbuild
    from repro.training.optimizer import OptConfig as JOpt
    from repro.training.optimizer import init_opt_state as jinit
    from repro.training.train_loop import make_train_step as jstep
    from repro_torch.launch.dryrun import count_step
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.train_loop import make_train_step
    B, S, TB, TS = 2, 64, 4, 32
    jm, tm = jbuild(_qwen("repro")), build_model(_qwen("repro_torch"),
                                                 device="meta")
    sds = jax.ShapeDtypeStruct
    jp = jm.param_shapes()
    ratios = {}
    # the decode step
    comp = jax.jit(jm.decode).lower(
        jp, jm.serve_state_shapes(B, S), sds((B,), jnp.int32)).compile()
    want = hlo_metrics(comp.as_text())["flops"]
    got = count_step(tm.decode, (tm.param_shapes(),
                                 tm.serve_state_shapes(B, S),
                                 _meta(B, dtype=torch.int32)))
    ratios["decode"] = got["flops"] / want
    assert got["kernels"] == {"indexer_scores": 2, "gather_kv.rows": 2,
                              "sparse_attn_gqa": 2, "scatter_kv.rows_at": 1}
    # the train step (one microbatch, AdamW)
    comp = jax.jit(jstep(jm, JOpt(), 1)).lower(
        jp, jax.eval_shape(jinit, jp),
        {"tokens": sds((TB, TS), jnp.int32),
         "labels": sds((TB, TS), jnp.int32)}).compile()
    want = hlo_metrics(comp.as_text())["flops"]
    tp = tm.param_shapes()
    got = count_step(make_train_step(tm, OptConfig(), 1), (
        tp, init_opt_state(tp),
        {"tokens": _meta(TB, TS, dtype=torch.int32),
         "labels": _meta(TB, TS, dtype=torch.int32)}))
    ratios["train"] = got["flops"] / want
    print("port / reference FLOPs:", ratios)
    for step, r in ratios.items():
        assert abs(r - 1) < FLOP_REL_TOL, (step, r)


# ---------------------------------------------------------------------------
# the kernels' analytic cost: PERF.md's bounds
# ---------------------------------------------------------------------------


def test_cost_gives_published_bounds():
    """Bounds chip_smoke.py printed before its arithmetic moved into
    kernels/cost.py (PERF.md, H100 SXM peaks), at shapes whose count
    does not depend on the data: the gathers, decode writes, the splice,
    the page gather and the indexer."""
    from repro_torch.kernels import cost
    cases = [
        (cost.rows(4 * 2048, 1152), 0.005644),            # DeepSeek gather
        (cost.rows(8 * 2048, 1024), 0.01004),             # Qwen2 gather
        (cost.rows(8 * 2048, 14336), 0.1402),             # Zamba2 gather
        (cost.write_rows_at(8, [(28, 1024), (28, 128)]), 0.000154),
        (cost.write_rows_at(4, [(48, 7680), (48, 128)]), 0.000895),
        (cost.splice([(48, 1, 8192, 8256, 7680),
                      (48, 1, 8192, 8256, 128)]), 1.8401),
        (cost.gather_pages(8 * 2048 // 16, 16, 1024), 0.01002),
        (cost.indexer(4, 4160, 64, 128), 0.001331),
        (cost.indexer(8, 8256, 4, 64), 0.002605),
        (cost.indexer(4, 65536, 64, 128), 0.02038),
    ]
    for c, published in cases:
        ms, by = cost.bound_ms(c)
        assert by == "bytes"
        assert abs(ms - published) / published < 5e-3, (c, ms, published)


# ---------------------------------------------------------------------------
# chip_smoke.py phase 18's host side, rehearsed
# ---------------------------------------------------------------------------


def test_chip_smoke_dryrun_phase_rehearses_on_cpu(monkeypatch):
    """Phase 18's meta pieces on the CPU: (a)'s meta build of
    Qwen2-1.5B x long_500k at mesh (1, 1) in its own process (the counts
    the card must equal), and (b)'s pool of CLI processes on three cells
    (one skipped with the reference's reason)."""
    import json
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "DRYRUN_CELLS", [
        ("qwen2-1.5b", "decode_32k", "single"),
        ("whisper-small", "long_500k", "single"),
        ("deepseek-v32", "decode_32k", "multi")])
    # the card's hang guard; a loaded test machine is slower
    monkeypatch.setattr(chip_smoke, "DRYRUN_BUDGET_S", 600)
    proc = chip_smoke.start_meta_cell()
    lines = []
    recs = chip_smoke.dryrun_cli_cells(lines)
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err
    meta = json.loads([ln for ln in out.splitlines()
                       if ln.startswith("META ")][-1][5:])
    assert meta["kernels"] == {"gather_kv.shard": 28, "indexer_scores": 28,
                               "sparse_attn_gqa": 28,
                               "scatter_kv.rows_at_shard": 1}
    assert meta["collective_counts"] == {"all-gather": 28, "all-reduce": 28}
    mem = meta["mem_per_device"]
    assert mem["argument_bytes"] == mem["step_argument_bytes"]
    # weights 3.58 GB, pool 15.0 GB, indexer pool 1.88 GB
    assert mem["layout"]["state"] == 28 * 524288 * (1024 + 128) + 4
    status = {(r["arch"], r["shape"], r["mesh"]): r for r in recs}
    assert {k: r["status"] for k, r in status.items()} == {
        ("qwen2-1.5b", "decode_32k", "single"): "ok",
        ("whisper-small", "long_500k", "single"): "skipped",
        ("deepseek-v32", "decode_32k", "multi"): "ok"}
    assert status["whisper-small", "long_500k", "single"]["skip"].startswith(
        "500K-frame encoder prefill")
    assert lines[-1]["ok"] == 2 and lines[-1]["skipped"] == 1
    assert not lines[-1]["failed"]


def test_chip_smoke_dryrun_cells_past_budget_fail(monkeypatch):
    """Phase 18 (b)'s budget is a hang guard, not a cut: a cell still
    running when it runs out is killed and reported ``timeout`` with its
    stderr's tail, a cell not started by then ``not_started``, and both
    are failures."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "DRYRUN_CELLS", [
        ("qwen2-1.5b", "decode_32k", "single"),
        ("qwen2-1.5b", "long_500k", "single")])
    monkeypatch.setattr(chip_smoke, "DRYRUN_WORKERS", 1)
    monkeypatch.setattr(chip_smoke, "DRYRUN_BUDGET_S", 0.5)
    lines = []
    recs = chip_smoke.dryrun_cli_cells(lines)
    assert [r["status"] for r in recs] == ["timeout", "not_started"]
    assert "error" in recs[0]
    assert lines[-1]["ok"] == 0 and lines[-1]["failed"] == [
        ("qwen2-1.5b", "decode_32k", "single", "timeout"),
        ("qwen2-1.5b", "long_500k", "single", "not_started")]
