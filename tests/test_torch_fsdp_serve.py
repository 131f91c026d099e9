"""The serving path of a batch that does not split (the reference's
``long_500k`` cells, B = 1: ``SERVE_RULES`` plus ``D=("data",)``,
``repro/launch/dryrun.py:148-152``) on each rank's blocks, against the
port's unsharded run, on the CPU.

A ``gloo`` world at mesh (data 2, model 2): every rank holds its
``spec_for`` blocks of the weights, the d_model rows over ``data`` and
heads / hidden / vocab / experts over ``model`` (``bridge.
shards_from_jax``), the one request's lane replicated over ``data``
(``batch_axes=()``) and its pool sharded over ``model``
(``make_pooled_fetch``).  Each product with a row block takes its
columns of the input and sums the partial products over ``data``
(``distributed/tp.py::TensorParallel.matmul``); no weight moves.  It
prefills a prompt and decodes STEPS teacher-forced tokens with the hot
tier and the fetch pipeline (a score-independent selection and tail
injected), for reduced Qwen2 and reduced DeepSeek-V3.2 (MLA, the
indexer, 4 experts).

Held: at a world of one, bit for bit; at (2, 2), every rank's logits
within ``tests/test_torch_tp.py``'s limits a step (relative L2, logits
outside BF16_TOL), the hot tier's integer state and ``pf_*`` exactly the
unsharded run's; a control with ``data`` rank 1's ``wo`` blocks zeroed
misses both limits.
"""
import contextlib
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

CONFIGS = {"qwen2-1.5b": 24, "deepseek-v32": 8}     # prompt lengths
MESH = (2, 2)
STEPS = 4
HOT_BUFFER = 8
REL_L2 = 3e-2
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
BF16_MISS_FRAC, BF16_MISS_FACTOR = 0.1, 3.0
GATE_MARGIN = 0.03


def _cfg(name):
    from repro_torch.configs import get_config
    return get_config(name).reduced()


def _rules():
    from repro_torch.distributed import sharding as shd
    return dict(shd.SERVE_RULES, D=("data",))


def _inject_topk(scores, cache_len, k: int = 16):
    j = torch.arange(k, dtype=torch.int32)[None]
    t = cache_len[:, None]
    pos = (j * 7 + 3 * t) % torch.clamp(t, min=1)
    return pos.to(torch.int32), (j < t) & (j % 5 != 3)


def _inject_tail(scores, cache_len, w: int = 8):
    j = torch.arange(w, dtype=torch.int32)[None]
    t = cache_len[:, None]
    return ((j * 5 + t) % torch.clamp(t, min=1)).to(torch.int32), j < t


def _tokens(name, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, _cfg(name).vocab,
                        (1, CONFIGS[name] + STEPS)).astype(np.int32)


def _served(cfg, params, toks, mesh):
    """Prefill, then STEPS teacher-forced steps with the hot tier and
    the fetch pipeline: (logits each step, the hot tier's integer state
    and counters each step)."""
    from repro_torch.core.pool import make_pooled_fetch, pool_write_prefill
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import build_model
    T = toks.shape[1] - STEPS
    opts = dict(prefetch_width=cfg.sac.prefetch_width,
                prefetch_fn=_inject_tail)
    fetch = {}
    if mesh is not None:
        fetch = dict(fetch_fn=make_pooled_fetch(mesh, batch_axes=()))
        opts["batch_axes"] = ()
    m = build_model(cfg, mode="sac", device="cpu", topk_fn=_inject_topk,
                    opts=opts, **fetch)
    ctx = (contextlib.nullcontext() if mesh is None
           else shd.use_rules(_rules(), mesh))
    prompt = toks[:, :T]
    with ctx:
        st, logits = m.prefill(params, prompt)
        state = m.init_serve_state(1, T + 8, device_buffer=HOT_BUFFER)
        state["cache_len"] = st["cache_len"].clone()
        if mesh is None:
            for k in ("kv_pool", "idx_pool"):
                pool_write_prefill(state[k], st[k])
        else:       # the split prefill's slices into the serve slices
            state = shd.shard_serve_state(state, mesh)
            shd.write_prefill_shard(state, st, mesh)
        out, tiers = [logits], []
        for i in range(STEPS):
            state, logits = m.decode(params, state, toks[:, T + i])
            out.append(logits)
            tiers.append([t.clone() for t in state["hot_buf"]
                          if not t.is_floating_point()]
                         + [state[k].clone() for k in (
                             "pf_inserted", "pf_useful", "buf_hits",
                             "buf_misses")])
    return out, tiers


def _zero_wo(params, mesh):
    """``params`` with ``data`` rank 1's ``wo`` blocks zeroed."""
    if mesh.get_local_rank("data") != 1:
        return params
    return dict(params, segments=[[dict(p, attn=dict(
        p["attn"], wo=torch.zeros_like(p["attn"]["wo"]))) for p in seg]
        for seg in params["segments"]])


def _rank_job(mesh, payload):
    from repro_torch.bridge import shards_from_jax
    out = {}
    for name in CONFIGS:
        cfg = _cfg(name)
        params = shards_from_jax(payload["params"][name], cfg, mesh,
                                 _rules(), "cpu")
        toks = torch.from_numpy(payload["toks"][name])
        out[name] = dict(run=_served(cfg, params, toks, mesh),
                         control=_served(cfg, _zero_wo(params, mesh), toks,
                                         mesh)[0],
                         weight_bytes=sum(t.numel() * t.element_size()
                                          for t in _tensors(params)))
    return out


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _tensors(v)]
    return [tree]


def _rank_main(rank, world, init, shape, payload, out_dir):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        p = torch.load(payload, weights_only=False)
        torch.save(_rank_job(mesh, p), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _gap_seed(name, params):
    """The first token seed whose unsharded run keeps every MoE gate
    GATE_MARGIN from a tie."""
    from repro_torch.models import moe
    cfg = _cfg(name)
    if not cfg.n_experts:
        return 0
    orig = moe.top_k
    for seed in range(400):
        gaps = []

        def top_k(probs, k):
            full, _ = orig(probs, k + 1)
            lp = torch.log(full.double())
            gaps.append(float((lp[..., k - 1] - lp[..., k]).min()))
            return orig(probs, k)
        moe.top_k = top_k
        try:
            _served(cfg, params, torch.from_numpy(_tokens(name, seed)), None)
        finally:
            moe.top_k = orig
        if min(gaps) > GATE_MARGIN:
            return seed
    raise AssertionError(f"{name}: no token seed keeps the gates off ties")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.bridge import params_to_numpy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    tmp = tmp_path_factory.mktemp("fsdp_serve")
    params, payload = {}, dict(params={}, toks={})
    for name in CONFIGS:
        cfg = _cfg(name)
        params[name] = build_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        payload["params"][name] = params_to_numpy(params[name], cfg)
        payload["toks"][name] = _tokens(name, _gap_seed(name, params[name]))
    path = str(tmp / "payload.pt")
    torch.save(payload, path)
    world = int(np.prod(MESH))
    out_dir = tmp / "ranks"
    out_dir.mkdir()
    ctx = mp.start_processes(
        _rank_main, args=(world, f"file://{tmp / 'rendezvous'}", MESH, path,
                          str(out_dir)),
        nprocs=world, join=False, start_method="spawn")
    unsharded = {name: _served(_cfg(name), params[name],
                               torch.from_numpy(payload["toks"][name]), None)
                 for name in CONFIGS}
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'one'}",
                            rank=0, world_size=1)
    try:
        one = _rank_job(make_mesh((1, 1), ("data", "model"), device="cpu"),
                        payload)
    finally:
        dist.destroy_process_group()
    while not ctx.join(timeout=300):
        pass
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
             for r in range(world)]
    return dict(unsharded=unsharded, one=one, ranks=ranks)


def _near(got, want):
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    ratio = np.abs(got - want) / (BF16_TOL["atol"]
                                  + BF16_TOL["rtol"] * np.abs(want))
    return err, int((ratio > 1).sum()), float(ratio.max())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_world_of_one_equals_unsharded(runs, name):
    (logits, tiers), (ul, ut) = runs["one"][name]["run"], \
        runs["unsharded"][name]
    for a, b in zip(logits, ul):
        assert torch.equal(a, b), name
    for ta, tb in zip(tiers, ut):
        assert all(torch.equal(a, b) for a, b in zip(ta, tb)), name


@pytest.mark.parametrize("name", list(CONFIGS))
def test_rows_over_data_near_unsharded(runs, name):
    want, want_tiers = runs["unsharded"][name]
    for r, res in enumerate(runs["ranks"]):
        logits, tiers = res[name]["run"]
        for i, (g, w) in enumerate(zip(logits, want)):
            g, w = g[0].float().numpy(), w[0].float().numpy()
            err, n_out, worst = _near(g, w)
            assert (err <= REL_L2 and n_out <= BF16_MISS_FRAC * w.size
                    and worst <= BF16_MISS_FACTOR), (name, r, i, err, n_out,
                                                     worst)
            c = res[name]["control"][i][0].float().numpy()
            err, n_out, _ = _near(c, w)
            assert err > REL_L2 and n_out > BF16_MISS_FRAC * w.size, (
                name, r, i, "the control is within the limits", err, n_out)
        for step, (gt, wt) in enumerate(zip(tiers, want_tiers)):
            for j, (a, b) in enumerate(zip(gt, wt)):
                assert torch.equal(a, b), (name, r, step, j)


def test_rank_holds_its_row_blocks(runs):
    """At (2, 2) a rank holds about a quarter of every weight that has
    d_model rows (rows over ``data``, columns over ``model``)."""
    for name in CONFIGS:
        whole = runs["one"][name]["weight_bytes"]
        for r, res in enumerate(runs["ranks"]):
            assert res[name]["weight_bytes"] < 0.4 * whole, (name, r)
