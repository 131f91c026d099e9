"""The training step with the d_model rows split across ranks (FSDP /
ZeRO-3 under ``TRAIN_RULES``: ``distributed/tp.py``'s row gather and
autograd collectives, ``training/train_loop.py``'s gradient reduction)
against the port's unsharded step, on the CPU.

The ranks are the processes of three ``gloo`` worlds started by
``torch.multiprocessing`` at meshes (data 2, model 2), (4, 1) and
(1, 4).  Each rank takes its blocks of the weights under
``TRAIN_RULES`` (``bridge.shards_from_jax`` of the reference's pytree of
the port's drawn weights), its lanes of a batch made from a numpy seed,
and runs ``make_train_step`` under ``use_rules(TRAIN_RULES, mesh)``:
the d_model rows over ``data`` (gathered for each layer, the gradient
reduce-scattered), heads / hidden / vocab over ``model``, experts over
``(model, data)`` (reduced Mixtral: 4 experts; reduced DeepSeek-V3.2:
MLA, 4 experts).

What is held:
- at a world of one, two steps bit for bit: parameters, AdamW moments,
  loss and gradient norm;
- the global loss and the MoE loss within ``LOSS_REL``, the gradient
  norm within ``GRAD_REL_L2``; every gathered gradient leaf within
  ``GRAD_REL_L2`` and every gathered parameter
  after two steps within ``PARAM_REL_L2`` (relative L2) of the
  unsharded step, AdamW's moments within ``GRAD_REL_L2``;
- controls that must miss the gradient limit: the batch-axis gradient
  reduction skipped (the rows' reduce-scatter made a slice and no
  all-reduce), and the MoE block's output gradient summed over
  ``model`` too;
- every rank of a block's replicas holds the same block after the steps.

``GRAD_REL_L2`` is 2e-2, not 1e-2: the unsharded bf16 step itself misses
a float64 run of the same step by 1.3-1.7 % a leaf (reduced Qwen2 here;
Qwen2-1.5B's full step on an H100: 2.3 % at the median leaf, 3.2 % at
the worst), and the sharded step, whose partial sums cross in f32,
differs from it by up to 1.6 % (the k bias, whose gradient cancels over
positions to a small sum), so a limit of 1e-2 would sit inside that
rounding (``test_unsharded_step_rounding_spread`` records the first
figure).
"""
import contextlib
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

CONFIGS = ("qwen2-1.5b", "mixtral-8x22b", "deepseek-v32")
MOE = ("mixtral-8x22b", "deepseek-v32")
MESHES = ((2, 2), (4, 1), (1, 4))
B = 4
# tokens a lane: the MoE configs' short rows keep their gates few (16
# tokens a dispatch, each of which must clear GATE_MARGIN)
SEQ = {"qwen2-1.5b": 16, "mixtral-8x22b": 4, "deepseek-v32": 4}
STEPS = 2
LOSS_REL = 1e-3
GRAD_REL_L2 = 2e-2
PARAM_REL_L2 = 1e-2
GATE_MARGIN = 0.03


def _cfg(name):
    from repro_torch.configs import get_config
    return get_config(name).reduced()


def _opt():
    from repro_torch.training.optimizer import OptConfig
    return OptConfig(warmup_steps=1, total_steps=100)


def _batch(name, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, _cfg(name).vocab, (B, SEQ[name] + 1)).astype(
        np.int32)
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


def _rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm()).item()


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _skip_batch_reduction():
    """The control: no gradient sum over the batch axes (the rows'
    gather's backward a slice, ``reduce_grads`` the identity)."""
    from repro_torch.distributed import tp
    from repro_torch.distributed.sharding import block_of
    from repro_torch.training import train_loop
    rs, rg = tp.TensorParallel._reduce_scatter, train_loop.reduce_grads

    def local(self, g, axes, dim):
        n, i = block_of(axes, self.mesh, self.coord)
        b = g.shape[dim] // n
        return g.narrow(dim, i * b, b)
    tp.TensorParallel._reduce_scatter = local
    train_loop.reduce_grads = lambda grads, specs, plan: grads
    try:
        yield
    finally:
        tp.TensorParallel._reduce_scatter = rs
        train_loop.reduce_grads = rg


@contextlib.contextmanager
def _moe_sum_over_model():
    """The control: the MoE block's output gradient summed over
    ``model`` as well as the batch axes."""
    from repro_torch.distributed import tp
    orig = tp.TensorParallel.own_lanes

    def own_lanes(self, x):
        return orig(self, self.enter(x, ("model",)))
    tp.TensorParallel.own_lanes = own_lanes
    try:
        yield
    finally:
        tp.TensorParallel.own_lanes = orig


def _grads(m, params, batch):
    """The step's gradients (reduced over the batch axes), before AdamW."""
    from repro_torch.training.train_loop import make_step_grads
    return make_step_grads(m)(params, batch)[1]


def _steps(m, params, opt_state, batch):
    from repro_torch.training.train_loop import make_train_step
    step = make_train_step(m, _opt())
    metrics = []
    for _ in range(STEPS):
        params, opt_state, met = step(params, opt_state, batch)
        metrics.append({k: v.clone() for k, v in met.items()})
    return params, opt_state, metrics


def _unsharded(name, jp, seed):
    from repro_torch.bridge import params_from_jax
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import init_opt_state
    cfg = _cfg(name)
    m = build_model(cfg, device="cpu")
    params = params_from_jax(jp, cfg, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(name, seed).items()}
    grads = _grads(m, params, batch)
    p2, o2, met = _steps(m, params, init_opt_state(params), batch)
    return dict(grads=grads, params=p2, opt=o2, metrics=met)


def _rank_job(mesh, payload):
    from repro_torch.bridge import shards_from_jax
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import init_opt_state
    nd = mesh.size(0)
    d = mesh.get_local_rank("data")
    lanes = slice(d * B // nd, (d + 1) * B // nd)
    out = {}
    for name in CONFIGS:
        cfg = _cfg(name)
        m = build_model(cfg, device="cpu")
        params = shards_from_jax(payload["params"][name], cfg, mesh,
                                 shd.TRAIN_RULES, "cpu")
        batch = {k: torch.from_numpy(v[lanes])
                 for k, v in _batch(name, payload["seeds"][name]).items()}
        res = {}
        with shd.use_rules(shd.TRAIN_RULES, mesh):
            gather = lambda t: shd.gather_params(t, m.specs)  # noqa: E731
            res["grads"] = gather(_grads(m, params, batch))
            if mesh.size(0) > 1:        # a batch axis to skip
                with _skip_batch_reduction():
                    res["control_batch"] = gather(_grads(m, params, batch))
            if cfg.n_experts and mesh.size(1) > 1:
                with _moe_sum_over_model():
                    res["control_moe"] = gather(_grads(m, params, batch))
            p2, o2, met = _steps(m, params, init_opt_state(params), batch)
            res["blocks"] = p2
            res["params"] = gather(p2)
            res["opt"] = {k: gather(o2[k]) for k in ("m", "v")}
            res["metrics"] = met
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
        torch.save(_rank_job(mesh, p), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _start_world(tmp, shape, payload_path):
    name = f"mesh{shape[0]}{shape[1]}"
    world = int(np.prod(shape))
    out_dir = tmp / name
    out_dir.mkdir()
    init = f"file://{tmp / (name + '.rendezvous')}"
    ctx = mp.start_processes(_rank_main, args=(world, init, shape,
                                               payload_path, str(out_dir)),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, out_dir, world


def _join(ctx, out_dir, world):
    while not ctx.join(timeout=300):
        pass
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _world_of_one(tmp, payload):
    """The sharded step at a world of one (a gloo group of this process
    alone): every block whole, every collective the identity."""
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'one'}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        return _rank_job(mesh, payload)
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _gate_gaps(gaps):
    """Record the smallest (K-th - next) log-probability gap of every
    MoE dispatch (``moe.top_k`` sees the softmax)."""
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


def _moe_seed(name, jp):
    """The first batch seed whose unsharded steps keep every gate of
    every forward GATE_MARGIN from a tie (bf16 router logits tie now and
    then: a tie routes by rounding)."""
    for seed in range(400):
        gaps = []
        with _gate_gaps(gaps):
            _unsharded(name, jp, seed)
        if min(gaps) > GATE_MARGIN:
            return seed
    raise AssertionError(f"{name}: no batch seed keeps the gates off ties")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.bridge import params_to_numpy
    from repro_torch.models.model import build_model
    tmp = tmp_path_factory.mktemp("fsdp")
    payload = dict(params={}, seeds={})
    for name in CONFIGS:
        cfg = _cfg(name)
        params = build_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(1))
        payload["params"][name] = jp = params_to_numpy(params, cfg)
        payload["seeds"][name] = _moe_seed(name, jp) if name in MOE else 0
    path = str(tmp / "payload.pt")
    torch.save(payload, path)
    worlds = [_start_world(tmp, shape, path) for shape in MESHES]
    unsharded = {name: _unsharded(name, payload["params"][name],
                                  payload["seeds"][name])
                 for name in CONFIGS}
    one = _world_of_one(tmp, payload)
    ranks = {shape: _join(*w) for shape, w in zip(MESHES, worlds)}
    return dict(payload=payload, unsharded=unsharded, one=one, ranks=ranks)


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------


def _zero_drawn(path: str) -> bool:
    """A leaf ``init_params`` draws as zeros: the QKV biases."""
    return path.split("/")[-1] in ("bq", "bk", "bv")


def _check_tree(got, want, limit, what, skip=lambda path: False):
    """Every leaf within ``limit`` relative L2 (a leaf zero in ``want``:
    zero in ``got``, as the indexer's, which the training forward does
    not use), but those ``skip`` names; the worst error."""
    worst = 0.0
    for (path, g), (wpath, w) in zip(_leaves(got), _leaves(want)):
        assert path == wpath and g.shape == w.shape, (path, wpath)
        if skip(path):
            continue
        if not bool(w.any()):
            assert not bool(g.any()), (what, path)
            continue
        err = _rel_l2(g, w)
        worst = max(worst, err)
        assert err <= limit, (what, path, err)
    return worst


@pytest.mark.parametrize("name", CONFIGS)
def test_world_of_one_equals_unsharded(runs, name):
    one, full = runs["one"][name], runs["unsharded"][name]
    for key in ("grads", "params"):
        for (p, a), (_, b) in zip(_leaves(one[key]), _leaves(full[key])):
            assert torch.equal(a, b), (name, key, p)
    for k in ("m", "v"):
        for (p, a), (_, b) in zip(_leaves(one["opt"][k]),
                                  _leaves(full["opt"][k])):
            assert torch.equal(a, b), (name, k, p)
    for a, b in zip(one["metrics"], full["metrics"]):
        for k in ("loss", "grad_norm", "aux", "lr"):
            assert torch.equal(a[k], b[k]), (name, k)


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("name", CONFIGS)
def test_loss_and_grad_norm_near_unsharded(runs, name, shape):
    want = runs["unsharded"][name]["metrics"]
    for r, res in enumerate(runs["ranks"][shape]):
        for i, (a, b) in enumerate(zip(res[name]["metrics"], want)):
            for k, limit in (("loss", LOSS_REL), ("aux", LOSS_REL),
                             ("grad_norm", GRAD_REL_L2)):
                err = abs(float(a[k]) - float(b[k])) / max(abs(float(b[k])),
                                                           1e-30)
                assert err <= limit, (name, shape, r, i, k, err)


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("name", CONFIGS)
def test_gradients_near_unsharded(runs, name, shape):
    want = runs["unsharded"][name]["grads"]
    for r, res in enumerate(runs["ranks"][shape]):
        worst = _check_tree(res[name]["grads"], want, GRAD_REL_L2,
                            f"{name} {shape} rank {r}")
        print(f"{name} {shape} rank {r}: worst gradient rel L2 {worst:.4g}")


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("name", CONFIGS)
def test_params_and_moments_after_two_steps_near_unsharded(runs, name,
                                                           shape):
    """The parameters after two steps within PARAM_REL_L2, and AdamW's
    moments within GRAD_REL_L2, leaf by leaf.  The QKV biases, drawn as
    zeros, are all update: AdamW's first update of an element is the
    sign of its gradient, which rounding decides where the gradient sits
    near zero; they are held through their moments, which are smooth in
    the gradients."""
    want = runs["unsharded"][name]
    for r, res in enumerate(runs["ranks"][shape]):
        what = f"{name} {shape} rank {r}"
        _check_tree(res[name]["params"], want["params"], PARAM_REL_L2, what,
                    skip=_zero_drawn)
        for k in ("m", "v"):
            _check_tree(res[name]["opt"][k], want["opt"][k], GRAD_REL_L2,
                        f"{what} {k}")


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)], ids=str)
@pytest.mark.parametrize("name", CONFIGS)
def test_control_without_batch_reduction_misses(runs, name, shape):
    want = runs["unsharded"][name]["grads"]
    for r, res in enumerate(runs["ranks"][shape]):
        errs = [_rel_l2(g, w) for (p, g), (_, w) in zip(
            _leaves(res[name]["control_batch"]), _leaves(want))
            if bool(w.any())]
        assert max(errs) > GRAD_REL_L2, (name, shape, r, max(errs))


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=str)
@pytest.mark.parametrize("name", MOE)
def test_control_moe_backward_over_model_misses(runs, name, shape):
    want = runs["unsharded"][name]["grads"]
    for r, res in enumerate(runs["ranks"][shape]):
        errs = [_rel_l2(g, w) for (p, g), (_, w) in zip(
            _leaves(res[name]["control_moe"]), _leaves(want))
            if bool(w.any())]
        assert max(errs) > GRAD_REL_L2, (name, shape, r, max(errs))


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_replicas_hold_the_same_blocks(runs, shape):
    """After the steps, every rank that holds a block of a leaf holds the
    same values as the block's other replicas (the gathered leaves are
    equal on every rank), and its blocks are ``shard_params``' cut of
    the gathered whole."""
    ranks = runs["ranks"][shape]
    for name in CONFIGS:
        first = ranks[0][name]["params"]
        for r, res in enumerate(ranks[1:], 1):
            for (p, a), (_, b) in zip(_leaves(res[name]["params"]),
                                      _leaves(first)):
                assert torch.equal(a, b), (name, shape, r, p)


def test_moe_seeds_keep_gates_off_ties(runs):
    """No MoE gate of the unsharded steps sits within GATE_MARGIN of a
    tie (the K-th against the next expert's log-probability), so the
    sharded runs route every token alike."""
    for name in MOE:
        gaps = []
        with _gate_gaps(gaps):
            _unsharded(name, runs["payload"]["params"][name],
                       runs["payload"]["seeds"][name])
        assert min(gaps) > GATE_MARGIN, (name, min(gaps))


def test_unsharded_step_rounding_spread(runs):
    """The baseline of GRAD_REL_L2: reduced Qwen2's unsharded bf16
    gradients against a float64 run of the same step (every activation
    in f64), leaf by leaf; printed, and above 1e-2 at its largest."""
    from repro_torch.bridge import params_from_jax
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import tree_map
    from repro_torch.training.train_loop import make_grad_fn, to_device
    name = "qwen2-1.5b"
    cfg = _cfg(name)
    m = build_model(cfg, device="cpu")
    params = params_from_jax(runs["payload"]["params"][name], cfg, "cpu")
    batch = to_device(_batch(name), "cpu")
    dtype = transformer.DTYPE
    transformer.DTYPE = torch.float64
    try:
        _, exact = make_grad_fn(m)(tree_map(lambda t: t.double(), params),
                                   batch)
    finally:
        transformer.DTYPE = dtype
    errs = [_rel_l2(g, w) for (p, g), (_, w) in zip(
        _leaves(runs["unsharded"][name]["grads"]), _leaves(exact))
        if bool(w.any())]
    print("unsharded bf16 vs f64 gradients: max", max(errs), "median",
          sorted(errs)[len(errs) // 2])
    assert max(errs) > 1e-2
