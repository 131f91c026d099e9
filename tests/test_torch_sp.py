"""The sequence-parallel residual of the attention families
(``distributed/tp.py``'s ``seq`` plan: ``gather_seq``, the
reduce-scatter form of ``matmul`` / ``all_reduce``, ``on_slice``;
``TransformerLM.forward`` / ``prefill`` under ``use_rules``) against the
port's unsharded runs and the reference's GSPMD training step, on the
CPU.

The ranks are the processes of three ``gloo`` worlds, meshes (data 1,
model 2), (2, 2) and (1, 4), started as ``tests/test_torch_tp.py``
starts its worlds (its ``_join``, injected top-k and speculation tail).
Each rank takes its blocks of the weights (``bridge.shards_from_jax`` of
the reference's pytree of the port's drawn weights) and its lanes of a
batch made from a numpy seed, for reduced Qwen2, DeepSeek-V3.2 with its
experts and Gemma3:

- one ``TRAIN_RULES`` step's gradients (``make_step_grads``), recording
  the residual after layer 1;
- a ``SERVE_RULES`` prefill over the sharded pool with the warm-up plan
  (``warmup_w``), then ``STEPS`` teacher-forced decode steps from a pool
  of ``T + 8`` rows with the hot tier and the fetch pipeline (a
  score-independent selection and speculation tail injected), the
  prefill's slices written into the serve slices
  (``sharding.write_prefill_shard``);
- a prompt of ``T - 1`` positions, which does not split over ``model``.

The reference runs in one subprocess with four host devices: its loss
and gradients (``jax.value_and_grad`` of its ``make_loss_fn``) jitted
with the dry-run's ``TRAIN_RULES`` shardings at (2, 2), where its
``constrain(x, ("B", "S", "D"))`` splits the residual over ``model``
too.

What is held:
- each rank's residual after layer 1 is its ``S/m`` block of every lane
  (``REL_L2`` of the unsharded residual's block);
- the global loss within ``LOSS_REL`` and every gathered gradient leaf
  within ``GRAD_REL_L2`` of the unsharded step (``test_torch_fsdp.py``'s
  limits), and of the reference's GSPMD step within ``REF_GRAD_L2``
  (``test_torch_training.py``'s limit across the packages; the
  unsharded step is held to it too, as the baseline);
- the prefill's pools are ``S/m`` rows a rank, and the model ranks'
  slices joined equal the unsharded prefill's pools within ``REL_L2``;
  ``warm_idx`` equals the unsharded plan, the last position's logits
  are within ``test_torch_tp.py``'s limits;
- after a split prefill, the decode's logits within those limits and
  the hot tier's integer state, hits, misses and ``pf_*`` exactly the
  unsharded run's;
- at a world of one (a gloo group of this process alone) the step's
  gradients, the prefill and the decode bit for bit the unsharded
  path's;
- a sequence that does not split over the model ranks raises a
  ``ValueError``;
- the dry-run records ``residual_over_model`` by family, and a split
  prefill at (16, 16) allocates no tensor of the whole pool's shape.

The MoE batch seed (``SEEDS``) keeps every gate ``GATE_MARGIN`` from a
tie in the unsharded runs.
"""
import contextlib
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

from test_torch_tp import (REL_L2, _cfg, _inject_tail, _inject_topk, _join,
                           _tier_ints, _within, one_thread)  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ("qwen2-1.5b", "deepseek-v32-moe", "gemma3-12b")
MESHES = ((1, 2), (2, 2), (1, 4))
GSPMD_MESH = (2, 2)
B = 4
# prompt (and training row) length a config; every one splits over 4
# model ranks, and the MoE's short rows keep its gates few
SEQ = {"qwen2-1.5b": 16, "deepseek-v32-moe": 8, "gemma3-12b": 40}
STEPS = 2
WARM_W = 8
HOT_BUFFER = 24
GATE_MARGIN = 0.03
# the MoE config's batch seed: the first (counting from 0) whose
# unsharded step, prefill and decode keep every gate GATE_MARGIN from a
# tie (test_moe_seed_keeps_gates_off_ties holds it)
SEEDS = {"deepseek-v32-moe": 23}
# test_torch_fsdp.py's limits against the unsharded step, and
# test_torch_training.py's gradient limit across the packages
LOSS_REL = 1e-3
GRAD_REL_L2 = 2e-2
REF_GRAD_L2 = 5e-2


def _batch(name, seed):
    """Token rows [B, SEQ + STEPS + 1]: training tokens and labels from
    the first SEQ + 1, the prompts the first SEQ, the decode fed the
    next STEPS; prompt lengths SEQ, SEQ - 3, SEQ / 2, SEQ - 1."""
    T = SEQ[name]
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, _cfg(name).vocab,
                        (B, T + STEPS + 1)).astype(np.int32)
    lengths = np.array([T, T - 3, T // 2, T - 1], np.int32)
    return toks, lengths


def _rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm()).item()


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


# ---------------------------------------------------------------------------
# the runs, on one rank's lanes (or all of them, unsharded)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _first_residual(into: list):
    """The residual after the first attention layer of each forward or
    prefill (``transformer._layer_fwd``'s first result; the backward's
    recomputation of a checkpointed layer is not recorded)."""
    from repro_torch.models import transformer
    plain = transformer._layer_fwd

    def recorded(*args):
        out = plain(*args)
        if not into:
            into.append(out[0].detach().clone())
        return out
    transformer._layer_fwd = recorded
    try:
        yield into
    finally:
        transformer._layer_fwd = plain


def _train(cfg, params, toks, mesh):
    """One step's loss, gradients (gathered whole with ``mesh``) and the
    residual after layer 1."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import build_model
    from repro_torch.training.train_loop import make_step_grads
    m = build_model(cfg, device="cpu")
    batch = {"tokens": toks[:, :-STEPS - 1], "labels": toks[:, 1:-STEPS]}
    ctx = (contextlib.nullcontext() if mesh is None
           else shd.use_rules(shd.TRAIN_RULES, mesh))
    with ctx, _first_residual([]) as res:
        met, grads = make_step_grads(m)(params, batch)
        if mesh is not None:
            grads = shd.gather_params(grads, m.specs)
    return dict(loss=float(met["loss"]), grads=grads, residual=res[0])


def _serve(cfg, params, toks, lengths, mesh):
    """The prefill (pools, ``warm_idx``, logits, its residual after
    layer 1), then STEPS teacher-forced steps with the hot tier and the
    fetch pipeline from a pool of T + 8 rows (over the model axis with
    ``mesh``): each step's logits and the hot tier's integer state."""
    from repro_torch.core.pool import make_pooled_fetch, pool_write_prefill
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import build_model
    fetch = {} if mesh is None else dict(fetch_fn=make_pooled_fetch(mesh))
    m = build_model(cfg, mode="sac", device="cpu", topk_fn=_inject_topk,
                    opts=dict(warmup_w=WARM_W,
                              prefetch_width=cfg.sac.prefetch_width,
                              prefetch_fn=_inject_tail), **fetch)
    T = toks.shape[1] - STEPS - 1
    ctx = (contextlib.nullcontext() if mesh is None
           else shd.use_rules(shd.SERVE_RULES, mesh))
    out = {}
    with ctx:
        with _first_residual([]) as res:
            st, logits = m.prefill(params, toks[:, :T], lengths)
        out.update(residual=res[0], logits=[logits],
                   warm_idx=st.pop("warm_idx"),
                   pools={k: st[k] for k in ("kv_pool", "idx_pool")})
        state = m.init_serve_state(toks.shape[0], T + 8,
                                   device_buffer=HOT_BUFFER)
        state["cache_len"] = st["cache_len"].clone()
        if mesh is None:
            for k in ("kv_pool", "idx_pool"):
                pool_write_prefill(state[k], st[k])
        else:
            state = shd.shard_serve_state(state, mesh)
            shd.write_prefill_shard(state, st, mesh)
        out["tiers"] = []
        for i in range(STEPS):
            fed = toks[torch.arange(toks.shape[0]), lengths.long() + i]
            state, lg = m.decode(params, state, fed)
            out["logits"].append(lg)
            out["tiers"].append(_tier_ints(state))
        if mesh is not None and mesh.size(1) > 1:
            try:
                m.prefill(params, toks[:, :T - 1])
                out["uneven"] = None
            except ValueError as e:
                out["uneven"] = str(e)
    return out


def _seq_collectives(mesh):
    """The sequence plan's collectives on [2, 8, 3] f32 tensors, forward
    and backward, against what every rank can work out alone from all
    ranks' inputs (each drawn from a generator seeded by its model
    rank): ``gather_seq`` with a use replicated over the sequence's axes
    (backward: the rank's block of the one gradient) and with a
    rank-specific use (the block of the ranks' gradients' sum);
    ``all_reduce(..., scatter=True)`` over the sequence's axes (the
    block of the ranks' sum; backward: the ranks' block gradients
    joined) and over no axis (the block; the same backward).  The largest
    absolute error of each."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.tp import TensorParallel
    tp = TensorParallel(mesh, shd.SERVE_RULES).with_seq()
    m, j, axes = tp.seq.n, tp.seq.index, tp.seq.axes

    def drawn(rank):
        g = torch.Generator().manual_seed(100 + rank)
        return [torch.randn(2, 8, 3, generator=g) for _ in range(2)]
    ins = [drawn(r) for r in range(m)]         # each rank's (value, grad)
    whole = torch.randn(2, 8, 3, generator=torch.Generator().manual_seed(7))
    b = 8 // m
    blk = slice(j * b, (j + 1) * b)
    err = {}
    for name, use_axes in (("gather_replicated", ()),
                           ("gather_rank_specific", axes)):
        x = whole[:, blk].clone().requires_grad_()
        y = tp.gather_seq(x, use_axes)
        grads = ([ins[0][1]] * m if not use_axes
                 else [ins[r][1] for r in range(m)])
        y.backward(grads[j])
        err[name] = max(float((y - whole).abs().max()), float(
            (x.grad - sum(grads)[:, blk] / (1 if use_axes else m)).abs()
            .max()))
    for name, sum_axes in (("scatter_sum", axes), ("scatter_block", ())):
        x = ins[j][0].clone().requires_grad_()
        y = tp.all_reduce(x, sum_axes, scatter=True)
        want = sum(ins[r][0] for r in range(m)) if sum_axes else ins[j][0]
        y.backward(ins[j][1][:, blk])
        joined = torch.cat([ins[r][1][:, r * b:(r + 1) * b]
                            for r in range(m)], dim=1)
        err[name] = max(float((y - want[:, blk]).abs().max()),
                        float((x.grad - joined).abs().max()))
    return err


def _rank_job(mesh, p):
    from repro_torch.bridge import shards_from_jax
    from repro_torch.distributed import sharding as shd
    nd = mesh.size(0)
    d = mesh.get_local_rank("data")
    lanes = slice(d * B // nd, (d + 1) * B // nd)
    out = {"collectives": _seq_collectives(mesh)}
    for name in CONFIGS:
        cfg = _cfg(name)
        toks = torch.from_numpy(p["toks"][name])[lanes]
        lengths = torch.from_numpy(p["lengths"][name])[lanes]
        params = shards_from_jax(p["params"][name], cfg, mesh,
                                 shd.TRAIN_RULES, "cpu")
        res = dict(train=_train(cfg, params, toks, mesh))
        params = shards_from_jax(p["params"][name], cfg, mesh,
                                 shd.SERVE_RULES, "cpu")
        res["serve"] = _serve(cfg, params, toks, lengths, mesh)
        out[name] = res
    return out


def _rank_main(rank, world, init, shape, payload, out_dir):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        p = torch.load(payload, weights_only=False)
        torch.save(_rank_job(mesh, p), os.path.join(out_dir,
                                                    f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _start_world(tmp, shape, payload_path):
    name = f"sp{shape[0]}{shape[1]}"
    world = int(np.prod(shape))
    out_dir = tmp / name
    out_dir.mkdir()
    init = f"file://{tmp / (name + '.rendezvous')}"
    ctx = mp.start_processes(_rank_main, args=(world, init, shape,
                                               payload_path, str(out_dir)),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, out_dir, world


def _world_of_one(tmp, params, toks, lengths):
    """Both runs at a world of one (a gloo group of this process alone):
    every block whole, every collective and sequence split the
    identity."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import model_param_specs
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'one'}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        out = {}
        for name in CONFIGS:
            cfg = _cfg(name)
            specs = model_param_specs(cfg)
            out[name] = dict(
                train=_train(cfg, shd.shard_params(
                    params[name], specs, mesh, shd.TRAIN_RULES), toks[name],
                    mesh),
                serve=_serve(cfg, shd.shard_params(
                    params[name], specs, mesh, shd.SERVE_RULES), toks[name],
                    lengths[name], mesh))
        return out
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the reference: one subprocess with four host devices
# ---------------------------------------------------------------------------

_REFERENCE = textwrap.dedent("""
    import os, sys, pickle
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, sys.argv[3])
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.distributed import sharding as shd
    from repro.models.model import build_model
    from repro.training.train_loop import make_loss_fn
    from test_torch_sp import CONFIGS, GSPMD_MESH, STEPS
    from test_torch_tp import _cfg

    def as_jax(a):                        # bf16 crosses as its bits
        return jnp.asarray(a.view(jnp.bfloat16) if a.dtype == np.uint16
                           else a)

    def by_path(tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {"".join("/" + str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path): np.asarray(leaf, np.float32)
                for path, leaf in flat}

    inp = pickle.load(open(sys.argv[1], "rb"))
    mesh = Mesh(np.array(jax.devices()).reshape(GSPMD_MESH),
                ("data", "model"))
    out = {}
    for name in CONFIGS:
        cfg = _cfg(name, "jax")
        m = build_model(cfg)
        params = jax.tree.map(as_jax, inp["params"][name])
        toks = inp["toks"][name]
        batch = {"tokens": toks[:, :-STEPS - 1], "labels": toks[:, 1:-STEPS]}
        with shd.use_rules(shd.TRAIN_RULES, mesh):
            p_sh = shd.params_shardings(m.specs, mesh, rules=shd.TRAIN_RULES)
            b_sh = {k: NamedSharding(mesh, P(("data",), None))
                    for k in batch}
            fn = jax.jit(jax.value_and_grad(make_loss_fn(m), has_aux=True),
                         in_shardings=(p_sh, b_sh))
            with mesh:
                (_, met), grads = fn(
                    jax.device_put(params, p_sh),
                    jax.device_put({k: jnp.asarray(v)
                                    for k, v in batch.items()}, b_sh))
        out[name] = dict(loss=float(met["loss"]), grads=by_path(grads))
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


# ---------------------------------------------------------------------------
# everything once
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _gate_gaps(gaps):
    """The smallest (K-th - next) log-probability gap of every dispatch."""
    from repro_torch.models import moe
    orig = moe.top_k

    def top_k(probs, k):
        full, _ = orig(probs, k + 1)
        lp = torch.log(full.double())
        gaps.append(float((lp[..., k - 1] - lp[..., k]).min()))
        return orig(probs, k)
    moe.top_k = top_k
    try:
        yield
    finally:
        moe.top_k = orig


def _unsharded(name, params, toks, lengths):
    return dict(train=_train(_cfg(name), params, toks, None),
                serve=_serve(_cfg(name), params, toks, lengths, None))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.bridge import params_to_numpy
    from repro_torch.models.model import build_model
    tmp = tmp_path_factory.mktemp("sp")
    params, jparams, toks, lengths = {}, {}, {}, {}
    for name in CONFIGS:
        cfg = _cfg(name)
        params[name] = build_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        jparams[name] = params_to_numpy(params[name], cfg)
        toks[name], lengths[name] = _batch(name, SEEDS.get(name, 0))
    payload = dict(params=jparams, toks=toks, lengths=lengths)
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(payload, f)
    torch.save(payload, tmp / "payload.pt")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=f"{ROOT / 'tests'}:{ROOT / 'src'}")
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(tmp / "inputs.pkl"),
         str(tmp / "ref.pkl"), str(ROOT / "src")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        worlds = [_start_world(tmp, shape, str(tmp / "payload.pt"))
                  for shape in MESHES]
        t = {k: torch.from_numpy(v) for k, v in toks.items()}
        n = {k: torch.from_numpy(v) for k, v in lengths.items()}
        unsharded = {name: _unsharded(name, params[name], t[name], n[name])
                     for name in CONFIGS}
        one = _world_of_one(tmp, params, t, n)
        ranks = {shape: _join(*w) for shape, w in zip(MESHES, worlds)}
        out, _ = ref_proc.communicate(timeout=900)
        assert ref_proc.returncode == 0, out
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
    with open(tmp / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    return dict(unsharded=unsharded, one=one, ranks=ranks, ref=ref)


def _lanes(shape, rank):
    d = rank // shape[1]
    return slice(d * B // shape[0], (d + 1) * B // shape[0])


def _block(x, shape, rank, dim=1):
    """The model rank's block of dim ``dim`` of a whole tensor."""
    n = x.shape[dim] // shape[1]
    return x.narrow(dim, (rank % shape[1]) * n, n)


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_sequence_collectives_forward_and_backward(runs, shape):
    """``gather_seq`` and the reduce-scatter form of ``all_reduce`` give
    every rank its values and gradients (f32 sums in another order:
    within 1e-5)."""
    for r, res in enumerate(runs["ranks"][shape]):
        for name, err in res["collectives"].items():
            assert err <= 1e-5, (shape, r, name, err)


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("part", ["train", "serve"])
@pytest.mark.parametrize("name", CONFIGS)
def test_residual_is_the_rank_s_sequence_block(runs, name, part, shape):
    """After layer 1 of the training forward and of the prefill, each
    rank holds its lanes' S/m positions, near the unsharded residual's
    block."""
    want = runs["unsharded"][name][part]["residual"]
    for r, res in enumerate(runs["ranks"][shape]):
        got = res[name][part]["residual"]
        block = _block(want[_lanes(shape, r)], shape, r)
        assert got.shape == block.shape, (got.shape, block.shape)
        assert got.shape[1] == SEQ[name] // shape[1]
        err = _rel_l2(got, block)
        assert err <= REL_L2, (name, part, shape, r, err)


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("name", CONFIGS)
def test_train_step_near_unsharded(runs, name, shape):
    """The global loss within LOSS_REL and every gathered gradient leaf
    within GRAD_REL_L2 of the unsharded step."""
    want = runs["unsharded"][name]["train"]
    worst = (0.0, "")
    for r, res in enumerate(runs["ranks"][shape]):
        got = res[name]["train"]
        assert abs(got["loss"] - want["loss"]) <= LOSS_REL * abs(
            want["loss"]), (got["loss"], want["loss"])
        for (path, g), (_, w) in zip(_leaves(got["grads"]),
                                     _leaves(want["grads"])):
            if not w.abs().sum():
                assert not g.abs().sum(), path
                continue
            err = _rel_l2(g, w)
            worst = max(worst, (err, path))
            assert err <= GRAD_REL_L2, (name, shape, r, path, err)
    print(f"{name} {shape}: worst leaf {worst[0]:.4g} at {worst[1]}")


@pytest.mark.parametrize("name", CONFIGS)
def test_train_step_near_reference_gspmd(runs, name):
    """The (2, 2) ranks' loss and gradients against the reference's GSPMD
    step (its residual split over the sequence too), and the unsharded
    step's beside them, each leaf within REF_GRAD_L2."""
    from repro_torch.bridge import params_to_numpy
    ref = runs["ref"][name]
    for label, got in [("unsharded", runs["unsharded"][name]["train"])] + [
            (f"rank {r}", res[name]["train"])
            for r, res in enumerate(runs["ranks"][GSPMD_MESH])]:
        assert abs(got["loss"] - ref["loss"]) <= LOSS_REL * abs(ref["loss"])
        mine = dict(_leaves(params_to_numpy(got["grads"], _cfg(name))))
        worst = 0.0
        for path, w in ref["grads"].items():
            g = mine[path]
            g = (torch.from_numpy(g.view(np.int16)).view(torch.bfloat16)
                 .float() if g.dtype == np.uint16 else torch.from_numpy(g))
            w = torch.from_numpy(w)
            if not w.abs().sum():
                continue
            err = _rel_l2(g, w)
            worst = max(worst, err)
            assert err <= REF_GRAD_L2, (name, label, path, err)
        print(f"{name} {label}: worst leaf against the reference {worst:.4g}")


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_pools_are_the_rank_s_slice(runs, name, shape):
    """A rank's pools hold S/m rows; a data slice's model ranks' slices,
    joined in model-rank order, equal the unsharded pools of its lanes
    within REL_L2."""
    want = runs["unsharded"][name]["serve"]["pools"]
    ranks = runs["ranks"][shape]
    m = shape[1]
    for d in range(shape[0]):
        lanes = _lanes(shape, d * m)
        for k in ("kv_pool", "idx_pool"):
            parts = [ranks[d * m + j][name]["serve"]["pools"][k]
                     for j in range(m)]
            assert all(p.shape[2] == SEQ[name] // m for p in parts)
            err = _rel_l2(torch.cat(parts, dim=2).float(),
                          want[k][:, lanes].float())
            assert err <= REL_L2, (name, shape, d, k, err)


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_warm_idx_and_logits(runs, name, shape):
    """The warm-up plan equals the unsharded one on every rank; the last
    position's logits are within test_torch_tp.py's limits."""
    want = runs["unsharded"][name]["serve"]
    for r, res in enumerate(runs["ranks"][shape]):
        got, lanes = res[name]["serve"], _lanes(shape, r)
        assert torch.equal(got["warm_idx"], want["warm_idx"][:, lanes])
        w = want["logits"][0][lanes].float().numpy()
        g = got["logits"][0].float().numpy()
        for b in range(w.shape[0]):
            assert _within(g[b], w[b]), (name, shape, r, b)


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("name", CONFIGS)
def test_decode_after_split_prefill(runs, name, shape):
    """The teacher-forced steps after a split prefill: logits within the
    limits, the hot tier's integer state, hits, misses and pf_* each step
    exactly the unsharded run's."""
    want = runs["unsharded"][name]["serve"]
    for r, res in enumerate(runs["ranks"][shape]):
        got, lanes = res[name]["serve"], _lanes(shape, r)
        for i in range(1, STEPS + 1):
            w = want["logits"][i][lanes].float().numpy()
            g = got["logits"][i].float().numpy()
            for b in range(w.shape[0]):
                assert _within(g[b], w[b]), (name, shape, r, i, b)
        if SEQ[name] > HOT_BUFFER:     # (a short prompt is all resident)
            assert int(want["tiers"][-1][-4].sum()) > 0, "nothing warm"
        for step, (tg, tw) in enumerate(zip(got["tiers"], want["tiers"])):
            for j, (a, b) in enumerate(zip(tg, tw)):
                b = b[lanes] if b.dim() == 1 else b[:, lanes]
                assert torch.equal(a, b), (name, shape, r, step, j)


@pytest.mark.parametrize("name", CONFIGS)
def test_world_of_one_equals_unsharded(runs, name):
    """At model 1 the sequence is whole: gradients, prefill (pools,
    ``warm_idx``, logits) and the decode bit for bit the unsharded
    path's."""
    one, full = runs["one"][name], runs["unsharded"][name]
    assert one["train"]["loss"] == full["train"]["loss"]
    for (p, a), (_, b) in zip(_leaves(one["train"]["grads"]),
                              _leaves(full["train"]["grads"])):
        assert torch.equal(a, b), p
    for k in ("kv_pool", "idx_pool"):
        assert torch.equal(one["serve"]["pools"][k],
                           full["serve"]["pools"][k])
    assert torch.equal(one["serve"]["warm_idx"], full["serve"]["warm_idx"])
    for a, b in zip(one["serve"]["logits"], full["serve"]["logits"]):
        assert torch.equal(a, b)
    for ta, tb in zip(one["serve"]["tiers"], full["serve"]["tiers"]):
        assert all(torch.equal(a, b) for a, b in zip(ta, tb))


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_uneven_sequence_raises(runs, shape):
    """A prompt of T - 1 positions does not split over the model ranks:
    every rank's prefill raises a ValueError naming the split."""
    for res in runs["ranks"][shape]:
        for name in CONFIGS:
            msg = res[name]["serve"]["uneven"]
            assert msg is not None and "does not split" in msg, (name, msg)


def test_moe_seed_keeps_gates_off_ties(runs):
    gaps = []
    name = "deepseek-v32-moe"
    toks, lengths = _batch(name, SEEDS[name])
    from repro_torch.models.model import build_model
    params = build_model(_cfg(name), device="cpu").init(
        torch.Generator().manual_seed(0))
    with _gate_gaps(gaps):
        _unsharded(name, params, torch.from_numpy(toks),
                   torch.from_numpy(lengths))
    assert min(gaps) > GATE_MARGIN


# ---------------------------------------------------------------------------
# the dry-run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,kind,want", [
    ("qwen2-1.5b", "train_4k", "sequence"),
    ("qwen2-1.5b", "prefill_32k", "sequence"),
    ("qwen2-1.5b", "decode_32k", "replicated"),
    ("deepseek-v32", "prefill_32k", "sequence"),
    ("gemma3-12b", "train_4k", "sequence"),
    ("mixtral-8x22b", "prefill_32k", "sequence"),
    ("zamba2-7b", "prefill_32k", "replicated"),
    ("xlstm-125m", "train_4k", "replicated"),
    ("whisper-small", "train_4k", "replicated")])
def test_dryrun_records_the_residual_by_family(arch, kind, want):
    """``residual_over_model``: the attention families' train and prefill
    cells split the sequence; their decode (one token a lane), Zamba2,
    xLSTM and Whisper keep the residual whole.  The cell is built, not
    counted."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    with dryrun.fake_world(256):
        mesh = make_production_mesh(multi_pod=False, device="cpu")
        step, _, _, meta = dryrun.build_cell(arch, kind, mesh)
    assert step is not None, meta
    assert meta["residual_over_model"] == want


def test_split_prefill_allocates_no_whole_pool():
    """Qwen2-1.5B x prefill_32k at (16, 16) on ``meta``: the pools the
    step returns are the rank's slices of 2048 rows, and no operator of
    the step makes a tensor of the whole pools' shapes [L, B, S, d]."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from repro_torch.configs import SHAPES_BY_NAME
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    class Shapes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self.seen.add(tuple(t.shape))
            return out

    S = SHAPES_BY_NAME["prefill_32k"].seq_len
    with dryrun.fake_world(256):
        mesh = make_production_mesh(multi_pod=False, device="cpu")
        step, _, in_spec, meta = dryrun.build_cell("qwen2-1.5b",
                                                   "prefill_32k", mesh)
        with Shapes() as rec:
            state, _ = step(*in_spec)
    L, b, rows, d = state["kv_pool"].shape
    assert rows == S // 16 and state["idx_pool"].shape[2] == S // 16
    whole = {(L, b, S, d), (L, b, S, state["idx_pool"].shape[3])}
    assert not whole & rec.seen, whole & rec.seen
    assert meta["residual_over_model"] == "sequence"
