"""The port's distributed layer (``repro_torch.launch.mesh``,
``repro_torch.distributed``, ``core/pool.py::make_pooled_fetch``,
``core/topk.py``) against the JAX reference, on the CPU.

The port's ranks are processes of a ``gloo`` world started by
``torch.multiprocessing`` (rendezvous through a file under the test's
temporary directory), once for each mesh: (data 2, model 2) and (data
1, model 2).  The reference runs in one subprocess with eight host
devices (``--xla_force_host_platform_device_count``), as
``tests/test_distributed.py`` runs it, so this process keeps one JAX
device.  Inputs come from numpy seeds; the reference's weights are made
in this process (``init`` on one device gives the bits the subprocess
gets on eight: checked by a checksum) and bridged to the port.

What is held:
- the pooled fetch equals ``local_fetch`` bit for bit (bf16 and e4m3,
  -0 and NaN included) and the reference's pooled fetch;
- the hierarchical top-k equals the reference's and ``topk_select``;
- the sharded decode (pool split over ``model``, lanes over ``data``)
  equals the port's unsharded decode bit for bit (logits, hot-tier
  integer state, ``pf_*``), with the hierarchical top-k too, and is
  within ``REL_L2`` of the reference's sharded decode, request by
  request, with few logits outside ``BF16_TOL`` (a control with one
  rank's pool slice zeroed must fail both limits);
- ``spec_for`` equals the reference's on every ``ParamSpec`` of every
  registered config, both rule tables, at meshes (2, 2), (1, 4), (4, 1)
  and (2, 2, 2) (a ``fake`` process group stands in for the meshes that
  no world here has); ``placements_for`` / ``reshard_tree`` give each
  rank the slice its placements name, and ``remesh(1)`` restores a port
  checkpoint bit for bit;
- ``viable_mesh_shape`` and ``SkipSlowReducer`` agree with the
  reference.
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
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
# whole-model decode logits across the packages: the relative L2 error
# per request of tests/test_torch_gqa.py and test_torch_lg_super.py (bf16
# activations round at other places in XLA and PyTorch, and the port's
# logits are rounded to bf16 where the reference's stay f32)
REL_L2 = 3e-2
# and element by element: tests/test_torch_models.py's BF16_TOL, which
# up to 2 % of a request's logits may miss, none by more than 2.5 times
# its allowance (reduced Qwen2 misses it on 0-3 of 256 logits a request,
# by at most 1.93 times, on the CPU)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
BF16_MISS_FRAC, BF16_MISS_FACTOR = 0.02, 2.5
# the decode configs held against the reference (reduced; DeepSeek-V3.2
# with a dense MLP: its MoE gate sits on a near-tie at these seeds) and
# their prompt lengths (Gemma3's local window of 32 below its prompt)
REF_DECODE = {"qwen2-1.5b": 32, "deepseek-v32": 32, "gemma3-12b": 48}
# MoE kinds on the (1, 2) mesh, against the port alone: (prompt, pool)
MOE_DECODE = {"mixtral-8x22b": (72, 96), "deepseek-v32-moe": (40, 64)}
B = 4
FETCH = dict(S=32, d=16, k=8)
TOPK = dict(S=64, k=8, cache_len=[64, 40, 10, 1])


def _cfg(name: str, package: str = "torch"):
    """A reduced config of either package (``-moe``: DeepSeek-V3.2 with
    its experts; plain ``deepseek-v32`` here has a dense MLP)."""
    if package == "torch":
        from repro_torch.configs import get_config
    else:
        from repro.configs import get_config
    moe = name.endswith("-moe")
    cfg = get_config(name.removesuffix("-moe")).reduced()
    if cfg.mla and not moe:
        cfg = dataclasses.replace(cfg, n_experts=0, topk_experts=0)
    return cfg


# ---------------------------------------------------------------------------
# the port's side: one process per rank
# ---------------------------------------------------------------------------


def _inject_topk(scores, cache_len, k: int = 16):
    """A score-independent selection with invalid lanes, for the decode
    held against the reference (both packages get it, as their indexer
    scores round differently and a near-tie would select differently);
    the same formula as the reference script's."""
    j = torch.arange(k, dtype=torch.int32)[None]
    t = cache_len[:, None]
    pos = (j * 7 + 3 * t) % torch.clamp(t, min=1)
    return pos.to(torch.int32), (j < t) & (j % 5 != 3)


def _decode_runs(cfg, params, toks, lengths, S_pool, lanes, mesh=None):
    """The decode runs of one config on ``lanes`` (all of them: the
    unsharded run; a rank's data slice with ``mesh``: the sharded run):

    - ``one``: prefill of the prompts, one decode step on the prompt's
      pool (its last row rewritten: the position clamps), selecting with
      ``_inject_topk``;
    - ``hot``: ragged prompts in a pool of ``S_pool`` with the hot tier
      and the fetch pipeline's speculation, three greedy steps: logits,
      the hot tier's integer state, ``pf_*`` and hits;
    - ``hier``: the same pool without the hot tier, two steps, selecting
      with the hierarchical top-k on the mesh (``topk_select`` without).
    """
    from repro_torch.core.pool import make_pooled_fetch, pool_write_prefill
    from repro_torch.core.topk import make_hierarchical_topk
    from repro_torch.distributed.sharding import shard_serve_state
    from repro_torch.models.model import build_model

    fetch = {} if mesh is None else dict(fetch_fn=make_pooled_fetch(mesh))
    shard = ((lambda st: shard_serve_state(st, mesh)) if mesh is not None
             else (lambda st: st))
    toks, lengths = toks[lanes], lengths[lanes]
    out = {}
    m = build_model(cfg, mode="sac", device="cpu", topk_fn=_inject_topk,
                    **fetch)
    st, _ = m.prefill(params, toks)
    _, logits = m.decode(params, shard(st), toks[:, 0])
    out["one"] = logits
    if mesh is not None:
        # the control of the reference comparison: the same step with
        # model rank 1's slice of the latent / (k, v) pool zeroed
        st = shard(st)
        if mesh.get_local_rank("model") == 1:
            st["kv_pool"].zero_()
        out["one_zeroed"] = m.decode(params, st, toks[:, 0])[1]

    def pooled(model, buffer):
        st, _ = model.prefill(params, toks, lengths)
        state = model.init_serve_state(len(lanes), S_pool,
                                       device_buffer=buffer)
        for k in ("kv_pool", "idx_pool"):
            pool_write_prefill(state[k], st[k])
        state["cache_len"] = st["cache_len"].clone()
        return shard(state)

    m = build_model(cfg, mode="sac", device="cpu",
                    opts=dict(prefetch_width=cfg.sac.prefetch_width), **fetch)
    state, tok, hot = pooled(m, 24), toks[:, -1], []
    for _ in range(3):
        state, logits = m.decode(params, state, tok)
        tok = logits.argmax(-1).to(torch.int32)
        hot.append(dict(logits=logits, tier=list(state["hot_buf"]),
                        **{k: state[k].clone() for k in (
                            "pf_inserted", "pf_useful", "buf_hits",
                            "buf_misses")}))
    out["hot"] = hot
    topk = (None if mesh is None
            else make_hierarchical_topk(mesh, cfg.sac.topk))
    m = build_model(cfg, mode="sac", device="cpu", topk_fn=topk, **fetch)
    state, tok, out["hier"] = pooled(m, 0), toks[:, -1], []
    for _ in range(2):
        state, logits = m.decode(params, state, tok)
        tok = logits.argmax(-1).to(torch.int32)
        out["hier"].append(logits)
    return out


def _slices(mesh, n_lanes: int, seq: int):
    """This rank's lanes (its data slice) and pool rows (its model
    slice)."""
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    nb, ns = n_lanes // mesh.size(0), seq // mesh.size(1)
    return list(range(d * nb, (d + 1) * nb)), slice(m * ns, (m + 1) * ns)


def _job_fetch(mesh, p, rank):
    from repro_torch.core.pool import make_fetch_fn
    fetch = make_fetch_fn(mesh, "pooled_hbm")
    out = {}
    for key in ("pool_bf16", "pool_e4m3", "pool_special"):
        lanes, rows = _slices(mesh, B, p[key].shape[1])
        out[key] = fetch(p[key][lanes, rows].contiguous(), p["idx"][lanes])
    return out


def _job_topk(mesh, p, rank):
    from repro_torch.core.topk import make_hierarchical_topk
    lanes, rows = _slices(mesh, B, TOPK["S"])
    hier = make_hierarchical_topk(mesh, TOPK["k"])
    return hier(p["scores"][lanes, rows].contiguous(), p["cache_len"][lanes])


def _job_decode(mesh, p, rank):
    out = {}
    for name, params in p["params"].items():
        lanes, _ = _slices(mesh, B, 2)
        out[name] = _decode_runs(_cfg(name), params, p["toks"][name],
                                 p["lengths"][name], p["S_pool"][name],
                                 lanes, mesh)
    return out


def _port_leaves(cfg):
    """(dims, shape) of every ParamSpec of the port's model of ``cfg``."""
    from repro_torch.models.layers import ParamSpec
    from repro_torch.models.model import build_model
    out = []

    def walk(t):
        if isinstance(t, ParamSpec):
            out.append((tuple(t.dims), tuple(t.shape)))
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        else:
            for v in t:
                walk(v)
    walk(build_model(cfg, device="cpu").specs)
    return out


def _job_specs(mesh, p, rank):
    """spec_for on the real (2, 2) DeviceMesh, over the port's own
    leaves of every registered config (full size), both rule tables."""
    from repro_torch.configs import ARCHS
    from repro_torch.distributed import sharding as shd
    out = {}
    for name, cfg in ARCHS.items():
        for rules in ("TRAIN_RULES", "SERVE_RULES"):
            out[name, rules] = [
                (dims, shape, shd.spec_for(dims, shape, mesh,
                                           getattr(shd, rules)))
                for dims, shape in _port_leaves(cfg)]
    return out


def _job_reshard(mesh, p, rank):
    """reshard_tree of reduced Qwen2 on the mesh: each rank's local
    shard is the slice its placements name; the count of leaves split
    over some mesh dim."""
    from torch.distributed.tensor import Shard
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.elastic import reshard_tree
    from repro_torch.models.model import build_model
    cfg = _cfg("qwen2-1.5b")
    m = build_model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(3))
    on_mesh = reshard_tree(params, m.specs, mesh, rules=shd.SERVE_RULES)
    coord = mesh.get_coordinate()
    split, bad = 0, []

    def check(t, dt, path):
        nonlocal split
        want = t
        for mdim, pl in enumerate(dt.placements):
            if isinstance(pl, Shard):
                want = want.chunk(mesh.size(mdim), pl.dim)[coord[mdim]]
                split += 1
        if not torch.equal(dt.to_local(), want):
            bad.append(path)

    def walk(a, b, path):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}/{i}")
        else:
            check(a, b, path)
    walk(params, on_mesh, "")
    return dict(split=split, bad=bad)


def _job_remesh(mesh, p, rank):
    """A port checkpoint restored onto ``remesh(1)`` (rank 0's mesh; the
    other ranks are outside it): every leaf bit-equal."""
    from repro_torch.distributed.elastic import remesh, reshard_tree
    from repro_torch.models.model import build_model
    from repro_torch.training import checkpoint as ckpt
    small = remesh(1, device="cpu")
    if rank != 0:
        return None
    cfg = _cfg("qwen2-1.5b")
    m = build_model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    ckpt.save(p["ckpt_dir"], 7, {"params": params})
    restored, step, _ = ckpt.restore(p["ckpt_dir"], {"params": params})
    on_mesh = reshard_tree(restored["params"], m.specs, small)
    leaves_a, leaves_b = [], []

    def flat(t, acc):
        if isinstance(t, dict):
            for k in sorted(t):
                flat(t[k], acc)
        elif isinstance(t, list):
            for v in t:
                flat(v, acc)
        else:
            acc.append(t)
    flat(params, leaves_a)
    flat(on_mesh, leaves_b)
    return dict(step=step, shape=tuple(small.shape), n=len(leaves_a),
                equal=all(torch.equal(a, b.full_tensor())
                          for a, b in zip(leaves_a, leaves_b)))


def _chip_smoke():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def _job_chip_small(mesh, p, rank):
    """chip_smoke.py's sharded small checks (phase 16 (c)), rehearsed on
    the CPU: its run of each small config with the pool split over the
    model axis."""
    cs = _chip_smoke()
    out = {}
    for name in cs.SHARDED_SMALL:
        cfg = cs.small_config(name)
        out[name] = cs._small_run(torch, cfg, cs._small_params(torch, cfg,
                                                               "sac"),
                                  "cpu", mode="sac", prompt_len=40,
                                  pool_len=64, prefetch=False, mesh=mesh)
    return out


JOBS = dict(fetch=_job_fetch, topk=_job_topk, decode=_job_decode,
            specs=_job_specs, reshard=_job_reshard, remesh=_job_remesh,
            chip_small=_job_chip_small)


def _rank_main(rank, world, init, shape, payload, out_dir):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        p = torch.load(payload, weights_only=False)
        out = {job: JOBS[job](mesh, p, rank) for job in p["jobs"]}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _start_world(tmp, name, shape, payload):
    """Start the ranks of one gloo world (not joined)."""
    world = int(np.prod(shape))
    out_dir = tmp / name
    out_dir.mkdir()
    path = str(tmp / f"{name}.payload.pt")
    torch.save(payload, path)
    init = f"file://{tmp / (name + '.rendezvous')}"
    ctx = mp.start_processes(_rank_main, args=(world, init, shape, path,
                                               str(out_dir)),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, out_dir, world


def _join(ctx, out_dir, world):
    while not ctx.join(timeout=300):
        pass
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# the reference's side: one subprocess with eight host devices
# ---------------------------------------------------------------------------

_REFERENCE = textwrap.dedent("""
    import os, sys, pickle
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, sys.argv[3])
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import ARCHS
    from repro.core.pool import make_pooled_fetch
    from repro.core.topk import make_hierarchical_topk
    from repro.distributed import sharding as shd
    from repro.models.layers import ParamSpec
    from repro.models.model import build_model
    from test_torch_distributed import MESHES, REF_DECODE, TOPK, _cfg, _checksum

    def inject_topk(scores, cache_len, k=16):    # _inject_topk's formula
        j = jnp.arange(k, dtype=jnp.int32)[None]
        t = cache_len[:, None]
        pos = (j * 7 + 3 * t) % jnp.maximum(t, 1)
        return pos.astype(jnp.int32), (j < t) & (j % 5 != 3)

    def as_axes(entry):                   # P normalises ("a",) to "a"
        return (entry,) if isinstance(entry, str) else entry

    inp = pickle.load(open(sys.argv[1], "rb"))
    devs = np.array(jax.devices())
    def mesh(shape, axes):
        return Mesh(devs[:int(np.prod(shape))].reshape(shape), axes)
    m22 = mesh((2, 2), ("data", "model"))
    out = {}
    fetch = jax.jit(make_pooled_fetch(m22, batch_axes=("data",)))
    idx = jnp.asarray(inp["idx"])
    out["fetch_bf16"] = np.asarray(fetch(
        jnp.asarray(inp["pool"], jnp.bfloat16), idx)).view(np.uint16)
    try:
        out["fetch_e4m3"] = np.asarray(fetch(
            jnp.asarray(inp["pool"], jnp.float8_e4m3fn), idx)).view(np.uint8)
    except Exception as e:       # the reference's psum may take no float8
        out["fetch_e4m3"] = repr(e)
    hier = jax.jit(make_hierarchical_topk(m22, TOPK["k"],
                                          batch_axes=("data",)))
    out["topk"] = [np.asarray(a) for a in hier(
        jnp.asarray(inp["scores"]), jnp.asarray(inp["cache_len"]))]
    for name in REF_DECODE:
        cfg = _cfg(name, "jax")
        m_ref = build_model(cfg, mode="sac")
        params = jax.jit(m_ref.init)(jax.random.PRNGKey(0))
        out[name, "checksum"] = _checksum(params)
        m_sh = build_model(cfg, mode="sac", topk_fn=inject_topk,
                           fetch_fn=make_pooled_fetch(
                               m22, batch_axes=("data",)))
        toks = jnp.asarray(inp["toks"][name])
        with shd.use_rules(shd.SERVE_RULES, m22):
            st, _ = m_ref.prefill(params, toks)
            st = dict(st)
            for k in ("kv_pool", "idx_pool"):
                st[k] = jax.device_put(st[k], NamedSharding(
                    m22, P(None, "data", "model", None)))
            with m22:
                _, logits = jax.jit(m_sh.decode)(params, st, toks[:, 0])
        out[name, "decode"] = np.asarray(logits, np.float32)
    is_spec = lambda x: isinstance(x, ParamSpec)
    for name, cfg in ARCHS.items():
        leaves = jax.tree.leaves(build_model(cfg).specs, is_leaf=is_spec)
        for rules in ("TRAIN_RULES", "SERVE_RULES"):
            for shape, axes in MESHES:
                mm = mesh(shape, axes)
                out[name, rules, shape] = [
                    (tuple(s.dims), tuple(s.shape), tuple(
                        as_axes(e) for e in shd.spec_for(
                            s.dims, s.shape, mesh=mm,
                            rules=getattr(shd, rules))))
                    for s in leaves]
    pickle.dump(out, open(sys.argv[2], "wb"))
""")

MESHES = [((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
          ((4, 1), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]


def _checksum(params) -> float:
    """Sum of every leaf in f64 (a numpy or JAX tree)."""
    import jax
    return float(sum(np.asarray(x, np.float64).sum()
                     for x in jax.tree.leaves(params)))


def _inputs():
    rng = np.random.default_rng(0)
    inp = dict(
        pool=rng.standard_normal((B, FETCH["S"], FETCH["d"])).astype(
            np.float32),
        idx=rng.integers(0, FETCH["S"], (B, FETCH["k"])).astype(np.int32),
        scores=rng.standard_normal((B, TOPK["S"])).astype(np.float32),
        cache_len=np.array(TOPK["cache_len"], np.int32), toks={},
        lengths={})
    from repro_torch.configs import get_config
    for name, T in REF_DECODE.items():
        vocab = get_config(name).reduced().vocab
        inp["toks"][name] = rng.integers(0, vocab, (B, T)).astype(np.int32)
        inp["lengths"][name] = np.array([T, T - 7, T // 2, T - 2], np.int32)
    for name, (T, _) in MOE_DECODE.items():
        vocab = _cfg(name).vocab
        inp["toks"][name] = rng.integers(0, vocab, (B, T)).astype(np.int32)
        inp["lengths"][name] = np.array([T, T - 9, T // 2, T - 1], np.int32)
    return inp


def _fetch_pools(inp):
    """bf16, e4m3 and a bf16 pool of -0, NaN and random bits."""
    from repro_torch.core.pool import E4M3, to_kv_dtype
    pool = torch.from_numpy(inp["pool"])
    bits = torch.from_numpy(np.random.default_rng(5).integers(
        0, 1 << 16, pool.shape, dtype=np.int64).astype(np.int16))
    special = bits.view(torch.bfloat16).clone()
    special.view(torch.int16)[:, ::3] = -(1 << 15)        # -0
    special.view(torch.int16)[:, 1::5] = 0x7FC1           # a NaN
    return dict(pool_bf16=pool.bfloat16(), pool_e4m3=to_kv_dtype(pool, E4M3),
                pool_special=special)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything once: the reference subprocess, the two gloo worlds
    and the port's unsharded runs in this process, side by side."""
    import jax
    from repro.models.model import build_model as jbuild
    from repro_torch.bridge import params_from_jax
    from repro_torch.models.model import build_model

    tmp = tmp_path_factory.mktemp("dist")
    inp = _inputs()
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=f"{ROOT / 'tests'}:{ROOT / 'src'}")
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(tmp / "inputs.pkl"),
         str(tmp / "ref.pkl"), str(ROOT / "src")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        params, checks = {}, {}
        for name in REF_DECODE:
            cfg = _cfg(name, "jax")
            jp = jax.tree.map(np.asarray,
                              jax.jit(jbuild(cfg).init)(jax.random.PRNGKey(0)))
            checks[name] = _checksum(jp)
            params[name] = params_from_jax(jp, _cfg(name), "cpu")
        for name in MOE_DECODE:
            cfg = _cfg(name)
            params[name] = build_model(cfg, device="cpu").init(
                torch.Generator().manual_seed(2))
        toks = {k: torch.from_numpy(v) for k, v in inp["toks"].items()}
        lengths = {k: torch.from_numpy(v) for k, v in inp["lengths"].items()}
        pools = _fetch_pools(inp)
        base = dict(toks=toks, lengths=lengths, **pools,
                    idx=torch.from_numpy(inp["idx"]),
                    scores=torch.from_numpy(inp["scores"]),
                    cache_len=torch.from_numpy(inp["cache_len"]))
        w22 = _start_world(tmp, "mesh22", (2, 2), dict(
            base, jobs=["fetch", "topk", "decode", "specs", "reshard",
                        "remesh"],
            params={k: params[k] for k in REF_DECODE},
            S_pool={k: T + 16 for k, T in REF_DECODE.items()},
            ckpt_dir=str(tmp / "ckpt")))
        w12 = _start_world(tmp, "mesh12", (1, 2), dict(
            base, jobs=["decode", "chip_small"],
            params={k: params[k] for k in MOE_DECODE},
            S_pool={k: S for k, (_, S) in MOE_DECODE.items()}))
        unsharded = {}
        S_pool = {**{k: T + 16 for k, T in REF_DECODE.items()},
                  **{k: S for k, (_, S) in MOE_DECODE.items()}}
        for name in list(REF_DECODE) + list(MOE_DECODE):
            unsharded[name] = _decode_runs(_cfg(name), params[name],
                                           toks[name], lengths[name],
                                           S_pool[name], list(range(B)))
        ranks22, ranks12 = _join(*w22), _join(*w12)
        out, _ = ref_proc.communicate(timeout=600)
        assert ref_proc.returncode == 0, out
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
    with open(tmp / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    return dict(inp=inp, pools=pools, params=params, checks=checks,
                unsharded=unsharded, ranks22=ranks22, ranks12=ranks12,
                ref=ref, fake_specs=_fake_mesh_specs(ref))


def _fake_mesh_specs(ref):
    """The port's ``spec_for`` on a ``DeviceMesh`` of each of MESHES over
    a ``fake`` process group of its world (this process joins no real
    one): on every leaf of the reference's models, and on the port's
    own leaves, of every registered config under both rule tables."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import ARCHS
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    out = {}
    for shape, axes in MESHES:
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=int(np.prod(shape)))
        try:
            mesh = make_mesh(shape, axes, device="cpu")
            for name, cfg in ARCHS.items():
                port = _port_leaves(cfg)
                for rules in ("TRAIN_RULES", "SERVE_RULES"):
                    table = getattr(shd, rules)
                    out[shape, name, rules] = (
                        [shd.spec_for(d, s, mesh, table)
                         for d, s, _ in ref[name, rules, shape]],
                        [(d, s, shd.spec_for(d, s, mesh, table))
                         for d, s in port])
        finally:
            dist.destroy_process_group()
    return out


class _Mesh:
    """A mesh's names and sizes, as ``spec_for`` reads them."""

    def __init__(self, names, shape):
        self.mesh_dim_names, self.shape = names, shape


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------


def _gathered(ranks, job, fn=lambda x: x):
    """The (2, 2) ranks' results of ``job`` in lane order: one rank per
    data slice (the model ranks hold the same lanes, checked equal)."""
    by_data = {}
    for r, res in enumerate(ranks):
        d = r // 2
        val = fn(res[job])
        if d in by_data:
            assert _bits_equal(by_data[d], val), f"{job}: model ranks differ"
        else:
            by_data[d] = val
    return [by_data[d] for d in sorted(by_data)]


def _bits_equal(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return all(_bits_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a.reshape(-1).view(torch.uint8),
                       b.reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("key", ["pool_bf16", "pool_e4m3", "pool_special"])
def test_pooled_fetch_equals_local_fetch(runs, key):
    from repro_torch.core.pool import local_fetch
    idx = torch.from_numpy(runs["inp"]["idx"])
    want = local_fetch(runs["pools"][key], idx)
    got = torch.cat(_gathered(runs["ranks22"], "fetch", lambda x: x[key]))
    assert _bits_equal(got, want)


def test_pooled_fetch_equals_reference(runs):
    got = torch.cat(_gathered(runs["ranks22"], "fetch",
                              lambda x: x["pool_bf16"]))
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(
        np.uint16), runs["ref"]["fetch_bf16"])
    ref_e4m3 = runs["ref"]["fetch_e4m3"]
    if isinstance(ref_e4m3, str):
        pytest.skip(f"the reference's pooled fetch takes no e4m3: {ref_e4m3}")
    got = torch.cat(_gathered(runs["ranks22"], "fetch",
                              lambda x: x["pool_e4m3"]))
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(), ref_e4m3)


def test_pooled_fetch_checks_batch_axes():
    """Each rank hands in its own lanes: ``batch_axes`` (filtered to the
    mesh's axes) split them, the other non-pool axes replicate them; the
    pool axis cannot split them, and the mesh must have a pool axis."""
    from repro_torch.core.pool import make_pooled_fetch
    from repro_torch.core.topk import make_hierarchical_topk

    class _Mesh22(_Mesh):
        def get_group(self, axis):
            return f"group {axis}"

        def get_local_rank(self, axis):
            return self.mesh_dim_names.index(axis)

        def size(self, dim):
            return self.shape[dim]

    mesh = _Mesh22(("data", "model"), (2, 2))
    for ok in [("pod", "data"), ("data",), ("pod",), ()]:
        shard = make_pooled_fetch(mesh, batch_axes=ok).shard
        assert (shard.group, shard.rank, shard.size) == ("group model", 1, 2)
        assert make_hierarchical_topk(mesh, 8, batch_axes=ok).shard.size \
            == 2
    for bad in [("data", "model"), ("model",)]:
        with pytest.raises(ValueError, match="splits the pool"):
            make_pooled_fetch(mesh, batch_axes=bad)
        with pytest.raises(ValueError, match="splits the pool"):
            make_hierarchical_topk(mesh, 8, batch_axes=bad)
    with pytest.raises(ValueError, match="no pool axis"):
        make_pooled_fetch(mesh, pool_axis="seq")


def test_make_fetch_fn_resolves_backends():
    from repro_torch.core.pool import local_fetch, make_fetch_fn
    assert make_fetch_fn(None, "local") is local_fetch
    assert make_fetch_fn(None, "host_dram") is local_fetch
    with pytest.raises(ValueError, match="requires a mesh"):
        make_fetch_fn(None, "pooled_hbm")
    with pytest.raises(ValueError, match="unknown pool backend"):
        make_fetch_fn(None, "nvlink")


def test_hierarchical_topk_equals_reference_and_plain(runs):
    from repro_torch.core.topk import topk_select
    idx, valid = (torch.cat(t) for t in zip(*_gathered(runs["ranks22"],
                                                       "topk")))
    ref_idx, ref_valid = runs["ref"]["topk"]
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    np.testing.assert_array_equal(valid.numpy(), ref_valid)
    p_idx, p_valid = topk_select(torch.from_numpy(runs["inp"]["scores"]),
                                 torch.from_numpy(runs["inp"]["cache_len"]),
                                 TOPK["k"])
    assert torch.equal(idx, p_idx) and torch.equal(valid, p_valid)


def _decode_lanes(ranks, name, n_data):
    """Each data slice's decode results (model ranks checked equal)."""
    per = len(ranks) // n_data
    out = []
    for d in range(n_data):
        group = [r["decode"][name] for r in ranks[d * per:(d + 1) * per]]
        for other in group[1:]:
            assert _bits_equal([v for v, _ in _flat(group[0])],
                               [v for v, _ in _flat(other)]), \
                f"{name}: the model ranks' results differ"
        out.append(group[0])
    return out


def _flat(run):
    """Every result of ``_decode_runs`` with its lane axis: the hot
    tier's tensors are [L, B, ...], the rest [B, ...]."""
    vals = [(run["one"], 0)] + [(x, 0) for x in run["hier"]]
    for step in run["hot"]:
        vals += [(step["logits"], 0)] + [(t, 1) for t in step["tier"]] + [
            (step[k], 0) for k in ("pf_inserted", "pf_useful", "buf_hits",
                                   "buf_misses")]
    return vals


@pytest.mark.parametrize("name", list(REF_DECODE) + list(MOE_DECODE))
def test_sharded_decode_equals_unsharded(runs, name):
    """Logits, hot-tier integer state and pf_* bit for bit, lane for
    lane, with the plain top-k, the fetch pipeline and the hierarchical
    top-k."""
    moe = name in MOE_DECODE
    ranks = runs["ranks12"] if moe else runs["ranks22"]
    n_data = 1 if moe else 2
    full = runs["unsharded"][name]
    assert int(full["hot"][-1]["pf_inserted"].sum()) > 0, \
        "nothing was warm-inserted: the speculation is not exercised"
    for d, part in enumerate(_decode_lanes(ranks, name, n_data)):
        lanes = slice(d * B // n_data, (d + 1) * B // n_data)
        for i, ((a, _), (b, axis)) in enumerate(zip(_flat(part),
                                                    _flat(full))):
            b = b[lanes] if axis == 0 else b[:, lanes]
            assert _bits_equal(a, b), f"{name}: item {i} of data slice {d}"


@pytest.mark.parametrize("name", list(REF_DECODE))
def test_sharded_decode_near_reference(runs, name):
    assert runs["checks"][name] == runs["ref"][name, "checksum"]
    got = torch.cat([p["one"] for p in _decode_lanes(runs["ranks22"], name,
                                                     2)]).float().numpy()
    want = runs["ref"][name, "decode"]
    zeroed = torch.cat([p["one_zeroed"] for p in _decode_lanes(
        runs["ranks22"], name, 2)]).float().numpy()
    for b in range(B):
        err, n_out, worst = _near(got[b], want[b])
        assert err <= REL_L2, f"{name} request {b}: relative L2 {err:.4f}"
        assert n_out <= BF16_MISS_FRAC * want[b].size and \
            worst <= BF16_MISS_FACTOR, (
                f"{name} request {b}: {n_out} of {want[b].size} logits "
                f"outside BF16_TOL, the worst at {worst:.2f} times it")
        err, n_out, worst = _near(zeroed[b], want[b])
        assert err > REL_L2 and n_out > BF16_MISS_FRAC * want[b].size, (
            f"{name} request {b}: the control (a slice zeroed) is within "
            f"the limits: relative L2 {err:.4f}, {n_out} logits outside")


def _near(got, want):
    """``got`` against ``want``: the relative L2 error, the count of
    elements outside BF16_TOL and the largest ratio of an element's error
    to its BF16_TOL allowance."""
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    ratio = np.abs(got - want) / (BF16_TOL["atol"]
                                  + BF16_TOL["rtol"] * np.abs(want))
    return err, int((ratio > 1).sum()), float(ratio.max())


def _strip_l(dims, shape, spec):
    n = 0
    while n < len(dims) and dims[n] == "L":
        n += 1
    return (dims[n:], shape[n:]), spec[n:]


@pytest.mark.parametrize("mesh", [m for m, _ in MESHES], ids=str)
def test_spec_for_equals_reference(runs, mesh):
    """On every ParamSpec of the reference's models (its stacked [n]
    layer axes included) and on each of the port's own leaves (the same
    spec once the reference's "L" axes are dropped)."""
    from repro_torch.configs import ARCHS
    real = runs["ranks22"][0]["specs"]          # the gloo world's mesh
    for name in ARCHS:
        for rules in ("TRAIN_RULES", "SERVE_RULES"):
            ref = runs["ref"][name, rules, mesh]
            on_ref, on_port = runs["fake_specs"][mesh, name, rules]
            assert on_ref == [spec for _, _, spec in ref], (name, rules)
            by_leaf = dict(_strip_l(*leaf) for leaf in ref)
            if mesh == (2, 2):
                assert real[name, rules] == on_port, (name, rules)
            for dims, shape, spec in on_port:
                assert by_leaf[dims, shape] == spec, (name, rules, dims)


def test_placements_follow_specs_and_refuse_a_crossed_order():
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    from repro_torch.distributed import sharding as shd
    mesh = _Mesh(("data", "model"), (2, 2))
    assert shd.placements_for(mesh, ("B", "SP", "G"), (4, 8, 3),
                              shd.SERVE_RULES) == [Shard(0), Shard(1)]
    assert shd.placements_for(mesh, ("G",), (3,)) == [Replicate(),
                                                      Replicate()]
    pod = _Mesh(("pod", "data", "model"), (2, 2, 2))
    assert shd.placements_for(pod, ("B", "D"), (8, 6), shd.SERVE_RULES) \
        == [Shard(0), Shard(0), Replicate()]
    # the experts over ("model", "data") on a (data, model) mesh: block
    # model * 2 + data, which DTensor reads from a strided data shard
    assert shd.placements_for(mesh, ("E", "DE", "F"), (4, 8, 8),
                              shd.TRAIN_RULES) == [
        _StridedShard(0, split_factor=2), Shard(0)]
    with shd.use_rules(shd.SERVE_RULES, mesh):
        assert shd.spec_for(("D",), (8,)) == (None,)
        x = torch.ones(2)
        assert shd.constrain(x, ("G",)) is x
    assert shd.spec_for(("D",), (8,), mesh) == (("data",),)


def test_reshard_tree_gives_each_rank_its_slice(runs):
    for res in runs["ranks22"]:
        assert res["reshard"]["bad"] == []
        assert res["reshard"]["split"] > 0


def test_remesh_restores_a_checkpoint_bit_equal(runs):
    res = runs["ranks22"][0]["remesh"]
    assert res["step"] == 7 and res["shape"] == (1, 1) and res["equal"]
    assert res["n"] > 10
    assert all(r["remesh"] is None for r in runs["ranks22"][1:])


def test_viable_mesh_shape_matches_reference():
    from repro.distributed.elastic import viable_mesh_shape as jvms
    from repro_torch.distributed.elastic import viable_mesh_shape
    for n in range(1, 600):
        for pref in (1, 4, 16):
            assert viable_mesh_shape(n, model_pref=pref) == \
                jvms(n, model_pref=pref), (n, pref)


@pytest.mark.parametrize("factor,quorum", [(2.0, 0.75), (1.01, 0.75),
                                           (1.5, 0.5)])
def test_skip_slow_reducer_matches_reference(factor, quorum):
    from repro.distributed.elastic import SkipSlowReducer as JReducer
    from repro_torch.distributed.elastic import SkipSlowReducer
    rng = np.random.default_rng(int(factor * 100))
    contributions = {h: ({"w": rng.standard_normal(3).astype(np.float32),
                          "b": [rng.standard_normal(2).astype(np.float32)]},
                         float(t))
                     for h, t in enumerate(rng.exponential(1.0, 6))}
    want, want_rep = JReducer(6, deadline_factor=factor,
                              min_quorum_frac=quorum).aggregate(
        3, contributions)
    got, rep = SkipSlowReducer(6, deadline_factor=factor,
                               min_quorum_frac=quorum).aggregate(
        3, contributions)
    assert dataclasses.asdict(rep) == dataclasses.asdict(want_rep)
    np.testing.assert_array_equal(got["w"], np.asarray(want["w"]))
    np.testing.assert_array_equal(got["b"][0], np.asarray(want["b"][0]))
    as_torch = {h: ({"w": torch.from_numpy(g["w"])}, t)
                for h, (g, t) in contributions.items()}
    got_t, _ = SkipSlowReducer(6, deadline_factor=factor,
                               min_quorum_frac=quorum).aggregate(3, as_torch)
    np.testing.assert_array_equal(got_t["w"].numpy(), got["w"])


def test_sharded_pool_refuses_what_stays_unsupported():
    """What the sharded pool still refuses: a top-k over local scores
    without the pooled fetch (decoder-only and encoder-decoder) and such
    a top-k beside a ``prefetch_fn`` (which would see only the slice).
    ``placements_for`` no longer refuses a crossed axis order: it names
    the reference's block order (a strided shard).  Every family builds
    over a pooled fetch in both modes (tests/test_torch_sharded_families.py
    decodes them)."""
    from repro_torch.core.pool import PooledFetch
    from repro_torch.core.topk import HierarchicalTopK
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import build_model

    class _Shard:
        size, rank = 2, 0

    fetch = PooledFetch(_Shard())
    for name in ("qwen2-1.5b", "zamba2-7b", "xlstm-125m", "whisper-small"):
        for mode in ("sac", "dense"):
            build_model(_cfg(name), fetch_fn=fetch, mode=mode, device="cpu")
    hier = HierarchicalTopK(_Shard(), 8)
    cfg = _cfg("qwen2-1.5b")
    m = build_model(cfg, topk_fn=hier, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    state = m.init_serve_state(1, 16)
    state["cache_len"].fill_(4)
    with pytest.raises(ValueError, match="needs the pooled fetch"):
        m.decode(params, state, torch.zeros(1, dtype=torch.int32))
    m = build_model(cfg, fetch_fn=fetch, topk_fn=hier, device="cpu",
                    opts=dict(prefetch_width=4,
                              prefetch_fn=lambda s, c: None))
    state = m.init_serve_state(1, 8, device_buffer=4)
    with pytest.raises(ValueError, match="takes no prefetch_fn"):
        m.decode(params, state, torch.zeros(1, dtype=torch.int32))
    w = _cfg("whisper-small")
    m = build_model(w, topk_fn=hier, device="cpu")
    wp = m.init(torch.Generator().manual_seed(0))
    st = m.init_serve_state(1, 8)
    st["cache_len"].fill_(8)
    with pytest.raises(ValueError, match="needs the pooled fetch"):
        m.decode(wp, st, torch.zeros(1, dtype=torch.int32))
    assert shd.placements_for(_Mesh(("data", "model"), (2, 2)),
                              ("E", "DE", "F"), (4, 8, 8),
                              shd.TRAIN_RULES)[0].split_factor == 2


def test_production_mesh_needs_its_world():
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(ValueError, match="256 ranks"):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="512 ranks"):
        make_production_mesh(multi_pod=True, device="cpu")


def test_chip_smoke_sharded_small_rehearses_on_cpu(runs):
    """chip_smoke.py's sharded small checks on the CPU: each rank's run
    (the pool split over two ranks) equals the unsharded run bit for bit
    (logits, hot tier, the two pool slices side by side)."""
    cs = _chip_smoke()
    for name in cs.SHARDED_SMALL:
        want = cs.small_runs(torch, cs.small_config(name),
                             devices=("cpu", "cpu"))[1]
        got = [r["chip_small"][name] for r in runs["ranks12"]]
        for g in got:
            assert all(torch.equal(a, b) for a, b in zip(g["logits"],
                                                         want["logits"]))
            assert cs._state_equal(torch, g["hot"], want["hot"])
        assert torch.equal(torch.cat([g["pool"] for g in got], 2),
                           want["pool"])
