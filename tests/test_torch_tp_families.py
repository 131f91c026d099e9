"""Tensor parallelism of the recurrent and encoder-decoder families
(``models/ssm.py``, ``models/encdec.py`` on a rank's blocks,
``distributed/tp.py``) against the port's unsharded run and the
reference's GSPMD run, on the CPU: Zamba2 here, xLSTM and Whisper in
``test_torch_tp_families_{xlstm,whisper}.py``, which share this file's
machinery.

The port's ranks are the processes of two ``gloo`` worlds started once
per module by ``torch.multiprocessing``, meshes (data 2, model 2) and
(data 1, model 4).  Each rank holds its block of every weight under
``SERVE_RULES`` (``bridge.shards_from_jax`` of the reference's pytree of
the port's drawn weights) and its lanes, and runs prefill and two
teacher-forced decode steps under ``use_rules(SERVE_RULES, mesh)`` with
one score-independent selection injected (the packages' indexer scores
round differently).  The reference runs in one subprocess with four host
devices: its parameters placed by ``params_shardings`` on each mesh, its
prefill and decode ``jax.jit``-compiled under the same rules at (2, 2),
the residual stream at each layer's input norm read by a
``jax.debug.callback`` (the port's by wrapping its ``rms_norm``).

Configs: reduced Zamba2 (two heads: at model 4 ``w_in``'s 290 columns
stay whole, d_inner splits into half heads, ``Hm`` stays whole and the
SSM state splits its state dim N), and a Zamba2 of ``d_model`` 256 (8
heads, ``w_in`` 1064 columns: blocks of 266 cut the fused z / x / B / C
/ dt boundaries; the state splits by heads).

What is held, for each config at each mesh:
- each rank's blocks of the weights equal the reference's addressable
  shards value for value, and its ``rec_*`` after the decode is the
  block the reference's ``_rec_pspec`` layout puts on the device at its
  coordinate (the index of the reference's shard, cut from the port's
  unsharded state, within ``REL_L2``);
- the residual stream at each layer's input (prefill and each decode
  step) within ``REL_L2`` of the port's unsharded run and of the
  reference's GSPMD run at the first ``FAMILY["tight"]`` records (the
  embedding and the first two layers' outputs), and within the family's
  whole-model decode limit at every layer (random layers amplify a
  rounding: the reference differs from its own one-device run by 5 % at
  reduced Zamba2's last prefill layer); the logits within the family's
  whole-model limits (``FAMILY["limits"]``) of both; controls with model
  rank 1's ``w_out`` blocks zeroed miss both;
- the hot tier's integer state, hits, misses and ``pf_*`` exactly the
  unsharded run's (Zamba2's shared layer);
- one layer of each recurrent kind (and Whisper's encoder layer) in f32,
  forward and backward on the rank's blocks, and its decode on the
  rank's block of the state, within ``F32_REL`` of the unsharded layer
  (every collective's gradient, including the whole ``Hm`` leaves of a
  rank that runs part of a head);
- inside the TP world at (2, 2): sparse equals dense bit for bit when
  top-k covers the context; at a world of one, the TP path equals the
  unsharded path bit for bit (serving and a training step);
- at (2, 2), a ``TRAIN_RULES`` step: the loss within ``LOSS_REL`` and
  each gathered gradient leaf within ``GRAD_REL_L2`` of the unsharded
  step (``FAMILY["train"]``'s config), beside a control without the
  batch-axis reduction that must miss.  Reduced Zamba2's bf16 step is
  held in f32 only: its layer-1 ``D_skip`` gradient (norm 0.09, a sum
  that cancels over positions) is 8 % from the unsharded bf16 step at
  (2, 2) and at (1, 2) alike, while the f32 layer check holds it to
  5e-7; over eight batches the bf16 gaps have the size of the unsharded
  step's own when it rounds as a rank does
  (``test_torch_tp_control.py``).
"""
import contextlib
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
B = 4
MESHES = ((2, 2), (1, 4))
GSPMD_MESH = (2, 2)
STEPS = 2
HOT_BUFFER = 24
REL_L2 = 3e-2
F32_REL = 1e-5
LOSS_REL, GRAD_REL_L2 = 1e-3, 5e-2
# the whole model's training step in f32 (every activation): the TP
# step's gradient leaves from the unsharded step's (5.3e-5 at worst,
# reduced Zamba2's first ``A_log``)
F32_GRAD_REL = 5e-4
# config -> (arch, replacements of its reduced config); the prompt
# lengths (Whisper: frames) and the whole-model limits of the logits
# (relative L2: prefill, decode) are the family's
FAMILY = dict(
    configs={"zamba2": ("zamba2-7b", {}),
             "zamba2-d256": ("zamba2-7b", dict(d_model=256, n_heads=8,
                                               n_kv_heads=8, head_dim=32))},
    prompt=30, limits=(0.15, 0.5), tight=3, train="zamba2-d256",
    w_out="w_out")


def _cfg(fam, name: str, package: str = "torch"):
    if package == "torch":
        from repro_torch.configs import get_config
    else:
        from repro.configs import get_config
    arch, repl = fam["configs"][name]
    return dataclasses.replace(get_config(arch).reduced(), **repl)


def inject_topk(scores, cache_len, k: int = 16):
    """A score-independent selection with invalid lanes (the reference
    script's formula too)."""
    j = torch.arange(k, dtype=torch.int32)[None]
    t = cache_len[:, None]
    pos = (j * 7 + 3 * t) % torch.clamp(t, min=1)
    return pos.to(torch.int32), (j < t) & (j % 5 != 3)


def inject_tail(scores, cache_len, w: int = 8):
    j = torch.arange(w, dtype=torch.int32)[None]
    t = cache_len[:, None]
    return ((j * 5 + t) % torch.clamp(t, min=1)).to(torch.int32), j < t


def inputs(fam, name: str, seed: int = 0):
    """(tokens [B, T + STEPS], lengths [B], frames or None): prompts
    padded by the STEPS tokens the decode is then fed."""
    cfg = _cfg(fam, name)
    T = fam["prompt"]
    rng = np.random.default_rng(seed)
    if cfg.enc_dec:
        frames = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
        toks = rng.integers(0, cfg.vocab, (B, STEPS)).astype(np.int32)
        return toks, np.full((B,), T, np.int32), frames
    toks = rng.integers(0, cfg.vocab, (B, T + STEPS)).astype(np.int32)
    return toks, np.array([T, T - 3, T // 2, T - 1], np.int32), None


# ---------------------------------------------------------------------------
# the port's runs
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def residuals(into: list):
    """While open, the input of every layer's norm of the residual stream
    (``transformer.rms_norm``, ``encdec.rms_norm``) is put on ``into``."""
    from repro_torch.models import encdec, transformer
    plain = transformer.rms_norm

    def recorded(x, gamma, *a):
        into.append(x.detach().float().clone())
        return plain(x, gamma, *a)
    transformer.rms_norm = encdec.rms_norm = recorded
    try:
        yield into
    finally:
        transformer.rms_norm = encdec.rms_norm = plain


def _ctx(mesh, rules=None):
    from repro_torch.distributed import sharding as shd
    if mesh is None:
        return contextlib.nullcontext()
    return shd.use_rules(rules or shd.SERVE_RULES, mesh)


def _fed(toks, lengths, i):
    if toks.shape[1] == STEPS:          # the encoder-decoder's tokens
        return toks[:, i]
    return toks[torch.arange(toks.shape[0]), lengths.long() + i]


def serve(cfg, params, inp, mesh, *, mode="sac", topk=inject_topk,
          buffer=0, prefetch=False, record=False, k=None):
    """Prefill, then STEPS teacher-forced decode steps (the pool sharded
    over ``model`` with ``mesh``); (logits, residual records per step
    or None, the state after, the hot tier's integer state each step)."""
    from repro_torch.core.pool import make_pooled_fetch
    from repro_torch.distributed.sharding import shard_serve_state
    from repro_torch.models.model import build_model
    toks, lengths, frames = inp
    if k is not None:
        cfg = dataclasses.replace(cfg, sac=dataclasses.replace(cfg.sac,
                                                               topk=k))
    fetch = ({} if mesh is None or not cfg.has_attention
             else dict(fetch_fn=make_pooled_fetch(mesh)))
    opts = (dict(prefetch_width=cfg.sac.prefetch_width,
                 prefetch_fn=inject_tail) if prefetch else None)
    m = build_model(cfg, mode=mode, device="cpu", topk_fn=topk, opts=opts,
                    **fetch)
    logits, recs, tiers = [], [], []
    with _ctx(mesh):
        rec = []
        with residuals(rec) if record else contextlib.nullcontext():
            if cfg.enc_dec:
                st, lg = m.prefill(params, frames.bfloat16())
            else:
                st, lg = m.prefill(params, toks, lengths)
                logits.append(lg)
        recs.append(rec)
        if buffer:
            state = m.init_serve_state(toks.shape[0], toks.shape[1],
                                       device_buffer=buffer)
            for key in ("kv_pool", "idx_pool"):
                state[key].copy_(st[key])
            state["cache_len"] = st["cache_len"].clone()
            st = state
        if mesh is not None:
            st = shard_serve_state(st, mesh)
        for i in range(STEPS):
            rec = []
            with residuals(rec) if record else contextlib.nullcontext():
                st, lg = m.decode(params, st, _fed(toks, lengths, i))
            recs.append(rec)
            logits.append(lg)
            if buffer:
                tiers.append([t for t in st["hot_buf"]
                              if not t.is_floating_point()] + [
                    st[k].clone() for k in ("pf_inserted", "pf_useful",
                                            "buf_hits", "buf_misses")])
    return logits, (recs if record else None), st, tiers


def rec_leaves(state) -> list:
    """The ``rec_*`` leaves of a serve state, in key and tree order."""
    out = []

    def walk(t):
        if isinstance(t, (tuple, list)):
            for x in t:
                walk(x)
        else:
            out.append(t)
    for key in sorted(k for k in state if k.startswith("rec_")):
        walk(state[key])
    return out


def _zero_w_out(fam, params, mesh):
    """``params`` with model rank 1's ``w_out`` blocks (Whisper's
    attention ``wo``: ``FAMILY["w_out"]``) zeroed: the control."""
    if mesh.get_local_rank("model") != 1:
        return params

    def walk(t, key=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return torch.zeros_like(t) if key == fam["w_out"] else t
    return walk(params)


def _grads(m, params, batch):
    from repro_torch.training.train_loop import make_step_grads
    return make_step_grads(m)(params, batch)


@contextlib.contextmanager
def f32_model():
    """While open, the models' activation dtype is f32 (the embedding's
    and the frames' cast): with f32 weights every product runs in f32."""
    from repro_torch.models import encdec, transformer
    dtype = transformer.DTYPE
    transformer.DTYPE = encdec.DTYPE = torch.float32
    try:
        yield
    finally:
        transformer.DTYPE = encdec.DTYPE = dtype


def _f32_grads(m, params, batch):
    from repro_torch.training.optimizer import tree_map
    with f32_model():
        return _grads(m, tree_map(lambda t: t.float(), params),
                      {k: v.float() if v.is_floating_point() else v
                       for k, v in batch.items()})


def train_batch(fam, name, lanes=slice(None)):
    cfg = _cfg(fam, name)
    rng = np.random.default_rng(1)
    t = rng.integers(0, cfg.vocab, (B, 17)).astype(np.int32)
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    if cfg.enc_dec:
        batch["frames"] = rng.standard_normal(
            (B, fam["prompt"], cfg.d_model)).astype(np.float32)
    out = {k: torch.from_numpy(v[lanes]) for k, v in batch.items()}
    if "frames" in out:
        out["frames"] = out["frames"].bfloat16()
    return out


@contextlib.contextmanager
def skip_batch_reduction():
    """The training control: no gradient sum over the batch axes."""
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


# ---------------------------------------------------------------------------
# one layer in f32: forward, backward, decode
# ---------------------------------------------------------------------------


def layer_cases(cfg):
    """(kind, specs, forward(p, x, cfg), decode(p, x, cfg, state) or
    None, the per-lane state shapes) of each recurrent kind of ``cfg``
    (Whisper: its encoder layer)."""
    from repro_torch.models import encdec, ssm
    from repro_torch.models.layers import attn_param_specs, mlp_param_specs
    if cfg.ssm_state:
        d_inner, nh, hd, N = ssm.mamba2_dims(cfg)
        return [("mamba2", ssm.mamba2_param_specs(cfg),
                 lambda p, x, c: ssm.mamba2_block(p, x, c, chunk=8)[0],
                 ssm.mamba2_decode, [(nh, N, hd), (3, d_inner)])]
    if cfg.xlstm:
        nh, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
        return [("mlstm", ssm.mlstm_param_specs(cfg), ssm.mlstm_block,
                 ssm.mlstm_decode, [(nh, hd, hd), (nh, hd), (nh,)]),
                ("slstm", ssm.slstm_param_specs(cfg), ssm.slstm_block,
                 ssm.slstm_decode, [(cfg.d_model,)] * 4)]
    specs = {"ln1": encdec._norm(cfg), "ln2": encdec._norm(cfg),
             "attn": attn_param_specs(cfg), "mlp": mlp_param_specs(cfg)}
    return [("enc_layer", specs, lambda p, x, c: encdec._enc_layer(p, x, c)
             - x, None, [])]


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float()


def layer_inputs(cfg, kind, specs, shapes):
    """f32 weights (the per-head and norm leaves moved off their init),
    input, loss weights and a random state, from seeds."""
    from repro_torch.models.layers import init_params
    g = torch.Generator().manual_seed(5)
    p = _f32(init_params(specs, torch.Generator().manual_seed(0), "cpu"))
    for k in ("A_log", "dt_bias", "D_skip", "norm_g"):
        if k in p:
            p[k] = p[k] + 0.1 * torch.randn(p[k].shape, generator=g)
    x = torch.randn((B, 16, cfg.d_model), generator=g)
    w = torch.randn((B, 16, cfg.d_model), generator=g)
    state = [torch.randn((B,) + s, generator=g) * 0.3 for s in shapes]
    if kind == "mlstm":
        state[2] = state[2] - 1.0        # the stabiliser m
    if kind == "slstm":
        state[2] = state[2].abs() + 0.5  # the normaliser n
    return p, x, w, state


def run_layer_case(cfg, case, mesh=None):
    """The layer's (output, its input's gradient, each weight's gradient
    gathered whole, decode output, decode state) in f32 on this rank's
    blocks (whole with no mesh)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.tp import rank_view
    kind, specs, fwd, dec, shapes = case
    p, x, w, state = layer_inputs(cfg, kind, specs, shapes)
    with _ctx(mesh):
        c = rank_view(cfg, {}, ()) if mesh is not None else cfg
        if mesh is not None:
            p = shd.shard_params(p, specs)
        live = {k: (v.detach().requires_grad_() if isinstance(v, torch.Tensor)
                    else {kk: vv.detach().requires_grad_()
                          for kk, vv in v.items()}) for k, v in p.items()}
        xg = x.detach().requires_grad_()
        out = fwd(live, xg, c)
        (out.double() * w).sum().backward()
        grads = {k: (v.grad if isinstance(v, torch.Tensor)
                     else {kk: vv.grad for kk, vv in v.items()})
                 for k, v in live.items()}
        if mesh is not None:
            grads = shd.gather_params(grads, specs)
        d_out = d_state = None
        if dec is not None:
            st = state
            if mesh is not None:
                tp = c.tp
                st = []
                for t in state:
                    blk = tp.rec_block(list(t.shape), 0)
                    if blk is not None:
                        axis, s = blk
                        n = t.shape[axis] // s.n
                        t = t.narrow(axis, s.index * n, n)
                    st.append(t)
            with torch.no_grad():
                d_out, d_state = dec(p, x[:, 0], c, tuple(st))
    return out.detach(), xg.grad, grads, d_out, d_state


# ---------------------------------------------------------------------------
# a rank's work
# ---------------------------------------------------------------------------


def rank_job(fam, mesh, payload):
    from repro_torch.bridge import (params_from_jax, params_to_numpy,
                                    shards_from_jax)
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import build_model
    nd = mesh.size(0)
    d = mesh.get_local_rank("data")
    lanes = slice(d * B // nd, (d + 1) * B // nd)
    out = {}
    for name, jp in payload["params"].items():
        cfg = _cfg(fam, name)
        params = shards_from_jax(jp, cfg, mesh, shd.SERVE_RULES, "cpu")
        m = build_model(cfg, device="cpu")
        cut = shd.shard_params(params_from_jax(jp, cfg, "cpu"), m.specs,
                               mesh, shd.SERVE_RULES)
        inp = tuple(None if a is None else torch.from_numpy(a[lanes])
                    for a in payload["inputs"][name])
        res = {"shards": params_to_numpy(params, cfg)}
        res["cut_equal"] = all(torch.equal(a, b) for a, b in zip(
            _tensors(cut), _tensors(params)))
        logits, recs, st, _ = serve(cfg, params, inp, mesh, record=True)
        res.update(logits=logits, recs=recs, rec=rec_leaves(st))
        res["control"] = serve(cfg, _zero_w_out(fam, params, mesh), inp,
                               mesh, record=True)[:2]
        if cfg.sac.enabled and not cfg.enc_dec:
            res["hot"] = serve(cfg, params, inp, mesh, buffer=HOT_BUFFER,
                               prefetch=True)
            res["hot"] = (res["hot"][0], res["hot"][3])
        res["layers"] = [run_layer_case(cfg, c, mesh)
                         for c in layer_cases(cfg)]
        if mesh.size(0) == 2:
            if cfg.sac.enabled:
                res["sparse_dense"] = [
                    serve(cfg, params, inp, mesh, mode=mode, topk=None,
                          k=64)[0] for mode in ("sac", "dense")]
            if name == fam["train"]:
                res["train"] = train_rank(fam, name, jp, mesh, lanes)
        out[name] = res
    return out


def train_rank(fam, name, jp, mesh, lanes):
    from repro_torch.bridge import shards_from_jax
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import build_model
    cfg = _cfg(fam, name)
    m = build_model(cfg, device="cpu")
    params = shards_from_jax(jp, cfg, mesh, shd.TRAIN_RULES, "cpu")
    batch = train_batch(fam, name, lanes)
    with shd.use_rules(shd.TRAIN_RULES, mesh):
        met, g = _grads(m, params, batch)
        with skip_batch_reduction():
            _, gc = _grads(m, params, batch)
        _, g32 = _f32_grads(m, params, batch)
        return dict(loss=float(met["loss"]),
                    grads=shd.gather_params(g, m.specs),
                    control=shd.gather_params(gc, m.specs),
                    f32=shd.gather_params(g32, m.specs))


def _tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for k in tree for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree]


def _rank_main(rank, world, init, shape, payload, out_dir, module):
    torch.set_num_threads(1)
    import importlib
    from repro_torch.launch.mesh import make_mesh
    fam = importlib.import_module(module).FAMILY
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        p = torch.load(payload, weights_only=False)
        torch.save(rank_job(fam, mesh, p),
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _start_world(tmp, shape, payload, module):
    name = f"mesh{shape[0]}{shape[1]}"
    world = int(np.prod(shape))
    out_dir = tmp / name
    out_dir.mkdir()
    init = f"file://{tmp / (name + '.rendezvous')}"
    ctx = mp.start_processes(_rank_main, args=(world, init, shape, payload,
                                               str(out_dir), module),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, out_dir, world


def _join(ctx, out_dir, world):
    while not ctx.join(timeout=300):
        pass
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# the reference: one subprocess with four host devices
# ---------------------------------------------------------------------------

_REFERENCE = textwrap.dedent("""
    import os, sys, pickle, importlib
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, sys.argv[3])
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.distributed import sharding as shd
    from repro.models import dsa as jdsa, encdec as jenc, transformer as jtr
    from repro.models.model import build_model
    import test_torch_tp_families as t
    FAMILY = importlib.import_module(sys.argv[4]).FAMILY
    devs = np.array(jax.devices())
    from repro.launch.dryrun import serve_state_shardings

    def inject_topk(scores, cache_len, k=16):    # inject_topk's formula
        j = jnp.arange(k, dtype=jnp.int32)[None]
        c = cache_len[:, None]
        pos = (j * 7 + 3 * c) % jnp.maximum(c, 1)
        return pos.astype(jnp.int32), (j < c) & (j % 5 != 3)
    # the encoder-decoder never calls its topk_fn: its selection is
    # dsa.topk_select, replaced alike
    jdsa.topk_select = lambda scores, cache_len, k: inject_topk(
        scores, cache_len)

    rec = []
    plain = jtr.rms_norm

    def recorded(x, g, *a, **k):
        jax.debug.callback(lambda v: rec.append(np.asarray(v, np.float32)),
                           x)
        return plain(x, g, *a, **k)
    jtr.rms_norm = jenc.rms_norm = recorded

    def bits(a):
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype.name == "bfloat16" else a

    def by_path(tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return [("".join("/" + str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path), leaf) for path, leaf in flat]

    def as_jax(a):
        return jnp.asarray(a.view(jnp.bfloat16) if a.dtype == np.uint16
                           else a)

    inp = pickle.load(open(sys.argv[1], "rb"))
    out = {}
    for name in FAMILY["configs"]:
        cfg = t._cfg(FAMILY, name, "jax")
        params = jax.tree.map(as_jax, inp["params"][name])
        m = build_model(cfg, mode="sac", topk_fn=inject_topk)
        toks, lengths, frames = inp["inputs"][name]
        toks, lengths = jnp.asarray(toks), jnp.asarray(lengths)
        for shape in t.MESHES:
            mesh = Mesh(devs.reshape(shape), ("data", "model"))
            with shd.use_rules(shd.SERVE_RULES, mesh):
                placed = jax.device_put(
                    params, shd.params_shardings(m.specs, mesh))
                out[name, shape, "shards"] = [
                    {p: bits(next(s.data for s in leaf.addressable_shards
                                  if s.device == d))
                     for p, leaf in by_path(placed)} for d in devs]
                if shape != t.GSPMD_MESH:
                    continue
                with mesh:
                    if cfg.enc_dec:
                        st, logits = jax.jit(m.prefill)(
                            placed, jnp.asarray(frames, jnp.bfloat16))
                        tf = []
                    else:
                        st, logits = jax.jit(m.prefill)(placed, toks,
                                                         lengths)
                        tf = [logits]
                    jax.effects_barrier()
                    recs = [list(rec)]
                    rec.clear()
                    dec = jax.jit(m.decode)
                    for i in range(t.STEPS):
                        tok = (toks[:, i] if cfg.enc_dec
                               else toks[jnp.arange(t.B), lengths + i])
                        st, logits = dec(placed, st, tok)
                        jax.effects_barrier()
                        tf.append(logits)
                        recs.append(list(rec))
                        rec.clear()
            out[name, "tf"] = [np.asarray(x, np.float32) for x in tf]
            out[name, "recs"] = recs
        recs_st = {k: v for k, v in st.items() if k.startswith("rec_")}
        for shape in t.MESHES:       # the reference's layout of rec_*
            mesh = Mesh(devs.reshape(shape), ("data", "model"))
            shard = serve_state_shardings(jax.eval_shape(lambda: st), mesh,
                                          t.B)
            out[name, shape, "rec_index"] = [
                [[(s.start or 0, s.stop) for s in sh.devices_indices_map(
                    leaf.shape)[d]] for sh, leaf in zip(
                    jax.tree.leaves({k: v for k, v in shard.items()
                                     if k.startswith("rec_")}),
                    jax.tree.leaves(recs_st))]
                for d in devs]
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


# ---------------------------------------------------------------------------
# everything once
# ---------------------------------------------------------------------------


def start(fam, module: str, tmp):
    """The module's runs: the reference subprocess and the two gloo
    worlds started, the unsharded runs and the world of one made here
    meanwhile."""
    from repro_torch.bridge import params_to_numpy
    from repro_torch.models.model import build_model
    params, jparams, ins = {}, {}, {}
    for name in fam["configs"]:
        cfg = _cfg(fam, name)
        params[name] = build_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        jparams[name] = params_to_numpy(params[name], cfg)
        ins[name] = inputs(fam, name)
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(dict(inputs=ins, params=jparams), f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=f"{ROOT / 'tests'}:{ROOT / 'src'}")
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(tmp / "inputs.pkl"),
         str(tmp / "ref.pkl"), str(ROOT / "src"), module],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        path = str(tmp / "payload.pt")
        torch.save(dict(params=jparams, inputs=ins), path)
        worlds = [_start_world(tmp, shape, path, module) for shape in MESHES]
        unsharded, layers = {}, {}
        for name in fam["configs"]:
            cfg = _cfg(fam, name)
            inp = tuple(None if a is None else torch.from_numpy(a)
                        for a in ins[name])
            lg, recs, st, _ = serve(cfg, params[name], inp, None,
                                    record=True)
            unsharded[name] = dict(logits=lg, recs=recs, state=st)
            if cfg.sac.enabled and not cfg.enc_dec:
                h = serve(cfg, params[name], inp, None, buffer=HOT_BUFFER,
                          prefetch=True)
                unsharded[name]["hot"] = (h[0], h[3])
            layers[name] = [run_layer_case(cfg, c) for c in layer_cases(cfg)]
        tm = build_model(_cfg(fam, fam["train"]), device="cpu")
        tb = train_batch(fam, fam["train"])
        train = {fam["train"]: _grads(tm, params[fam["train"]], tb),
                 "f32": _f32_grads(tm, params[fam["train"]], tb)[1]}
        one = world_of_one(fam, tmp, params, ins)
        ranks = {shape: _join(*w) for shape, w in zip(MESHES, worlds)}
        out, _ = ref_proc.communicate(timeout=900)
        assert ref_proc.returncode == 0, out
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
    with open(tmp / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    return dict(params=params, inputs=ins, unsharded=unsharded,
                layers=layers, train=train, one=one, ranks=ranks, ref=ref)


def world_of_one(fam, tmp, params, ins):
    """The TP path at a world of one (a gloo group of this process
    alone): serving each config and the training step."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'one'}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        out = {}
        for name in fam["configs"]:
            cfg = _cfg(fam, name)
            m = build_model(cfg, device="cpu")
            cut = shd.shard_params(params[name], m.specs, mesh,
                                   shd.SERVE_RULES)
            inp = tuple(None if a is None else torch.from_numpy(a)
                        for a in ins[name])
            lg, _, st, _ = serve(cfg, cut, inp, mesh)
            out[name] = dict(logits=lg, state=st)
            if cfg.sac.enabled and not cfg.enc_dec:
                h = serve(cfg, cut, inp, mesh, buffer=HOT_BUFFER,
                          prefetch=True)
                out[name]["hot"] = (h[0], h[3])
        name = fam["train"]
        m = build_model(_cfg(fam, name), device="cpu")
        with shd.use_rules(shd.TRAIN_RULES, mesh):
            cut = shd.shard_params(params[name], m.specs)
            out["train"] = _grads(m, cut, train_batch(fam, name))
        return out
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the checks, shared by the three modules
# ---------------------------------------------------------------------------


def lanes_of(shape, rank):
    d = rank // shape[1]
    return slice(d * B // shape[0], (d + 1) * B // shape[0])


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def check_shards(fam, runs, name, shape):
    """Each rank's weight blocks equal the reference's addressable shards;
    its ``rec_*`` after the decode is the reference's shard index of the
    port's unsharded state, within the family's decode limit (the state
    carries the depth's amplified rounding, as the logits do)."""
    ref = runs["ref"][name, shape, "shards"]
    whole = rec_leaves(runs["unsharded"][name]["state"])
    for r, res in enumerate(runs["ranks"][shape]):
        got = dict(_leaves(res[name]["shards"]))
        assert res[name]["cut_equal"], (name, shape, r)
        assert set(got) == set(ref[r]), (name, shape, r)
        for path, want in ref[r].items():
            np.testing.assert_array_equal(got[path], want,
                                          err_msg=f"{name} {shape} {r} {path}")
        index = runs["ref"][name, shape, "rec_index"][r]
        assert len(index) == len(whole) == len(res[name]["rec"])
        for i, (w, g, ix) in enumerate(zip(whole, res[name]["rec"], index)):
            block = w[tuple(slice(a, b) for a, b in ix)]
            assert tuple(g.shape) == tuple(block.shape), (
                name, shape, r, i, tuple(g.shape), tuple(block.shape))
            err = rel(g.float(), block.float())
            assert err <= fam["limits"][1], (name, shape, r, i, err)


def check_residuals(fam, runs, name, shape):
    """The residual stream at each layer's input, prefill and each decode
    step: within REL_L2 of the unsharded run's and of the reference GSPMD
    run's at the first ``tight`` layers (the embedding and the first two
    layers' outputs), and within the family's decode limit of both at
    every layer (random layers amplify a rounding with depth); the
    control's after its first layer outside REL_L2."""
    full = runs["unsharded"][name]["recs"]
    refr = runs["ref"][name, "recs"]
    deep = fam["limits"][1]
    for r, res in enumerate(runs["ranks"][shape]):
        lanes = lanes_of(shape, r)
        ctrl = res[name]["control"][1]
        for step, (got, want, jw) in enumerate(zip(res[name]["recs"], full,
                                                   refr)):
            assert len(got) == len(want) == len(jw), (name, shape, r, step)
            for i, (g, w, j) in enumerate(zip(got, want, jw)):
                lim = REL_L2 if i < fam["tight"] else deep
                for key, x in (("unsharded", w), ("reference", j)):
                    if tuple(x.shape) != tuple(w.shape):
                        continue        # the reference's final norm: all S
                    err = rel(g, x[lanes])
                    assert err <= lim, (key, name, shape, r, step, i, err)
            err = rel(ctrl[step][2], want[2][lanes])
            assert err > REL_L2, ("control", name, shape, r, step, err)


def check_logits(fam, runs, name, shape):
    """Each rank's logits within the family's limits of the unsharded
    run's and the reference GSPMD run's, a lane at a time; the control
    outside."""
    pre, dec = fam["limits"]
    cfg = _cfg(fam, name)
    for key, wants in (("unsharded", [x.float().numpy() for x in
                                      runs["unsharded"][name]["logits"]]),
                       ("reference", runs["ref"][name, "tf"])):
        for r, res in enumerate(runs["ranks"][shape]):
            lanes = lanes_of(shape, r)
            for step, (got, want) in enumerate(zip(res[name]["logits"],
                                                   wants)):
                lim = pre if step == 0 and not cfg.enc_dec else dec
                ctrl = res[name]["control"][0][step]
                for b in range(got.shape[0]):
                    w = want[lanes][b]
                    err = rel(got[b].float(), w)
                    assert err <= lim, (key, name, shape, r, step, b, err)
                    assert rel(ctrl[b].float(), w) > lim, (
                        "control", key, name, shape, r, step, b)


def check_hot(runs, name, shape):
    logits, tiers = runs["unsharded"][name]["hot"]
    for r, res in enumerate(runs["ranks"][shape]):
        lanes = lanes_of(shape, r)
        got_l, got_t = res[name]["hot"]
        for step, (gt, wt) in enumerate(zip(got_t, tiers)):
            for j, (g, w) in enumerate(zip(gt, wt)):
                w = w[lanes] if w.dim() == 1 else w[:, lanes]
                assert torch.equal(g, w), (name, shape, r, step, j)


def check_layers(runs, name, shape):
    """Every rank's f32 layer (forward, input and weight gradients,
    decode output and its block of the new state) within F32_REL."""
    cfg = _cfg(runs["fam"], name)
    for r, res in enumerate(runs["ranks"][shape]):
        for case, got, want in zip(layer_cases(cfg), res[name]["layers"],
                                   runs["layers"][name]):
            kind = case[0]
            out, gx, grads, d_out, d_state = got
            assert rel(out, want[0]) <= F32_REL, (kind, shape, r, "out")
            assert rel(gx, want[1]) <= F32_REL, (kind, shape, r, "dx")
            for (path, g), (_, w) in zip(_leaves(grads), _leaves(want[2])):
                assert rel(g, w) <= F32_REL, (kind, shape, r, path,
                                              rel(g, w))
            if d_out is None:
                continue
            assert rel(d_out, want[3]) <= F32_REL, (kind, shape, r, "decode")
            for i, (g, w) in enumerate(zip(d_state, want[4])):
                # the rank's block of the whole new state
                idx = [slice(None)] * w.dim()
                for ax in range(1, w.dim()):
                    if g.shape[ax] != w.shape[ax]:
                        n = g.shape[ax]
                        k = r % shape[1]
                        idx[ax] = slice(k * n, (k + 1) * n)
                assert rel(g, w[tuple(idx)]) <= F32_REL, (kind, shape, r,
                                                          "state", i)


def check_world_of_one(runs, name):
    one, full = runs["one"][name], runs["unsharded"][name]
    for a, b in zip(one["logits"], full["logits"]):
        assert torch.equal(a, b), name
    for a, b in zip(rec_leaves(one["state"]), rec_leaves(full["state"])):
        assert torch.equal(a, b), name
    if "hot" in full:
        for a, b in zip(one["hot"][0], full["hot"][0]):
            assert torch.equal(a, b), name
        for ta, tb in zip(one["hot"][1], full["hot"][1]):
            assert all(torch.equal(a, b) for a, b in zip(ta, tb)), name


def check_train_world_of_one(runs):
    (m1, g1), (m0, g0) = runs["one"]["train"], runs["train"][
        runs["fam"]["train"]]
    assert torch.equal(m1["loss"], m0["loss"])
    for (p, a), (_, b) in zip(_leaves(g1), _leaves(g0)):
        assert torch.equal(a, b), p


def check_train(runs):
    name = runs["fam"]["train"]
    met, want = runs["train"][name]
    want = [(p, w.double()) for p, w in _leaves(want)]
    live = [i for i, (_, w) in enumerate(want) if bool(w.any())]

    def errors(tree):
        got = [g for _, g in _leaves(tree)]
        return {want[i][0]: float((got[i].double() - want[i][1]).norm()
                                  / want[i][1].norm()) for i in live}
    worst_control = 0.0
    for r, res in enumerate(runs["ranks"][(2, 2)]):
        got = res[name]["train"]
        assert abs(got["loss"] - float(met["loss"])) <= LOSS_REL * abs(
            float(met["loss"])), (r, got["loss"], float(met["loss"]))
        over = {p: e for p, e in errors(got["grads"]).items()
                if e > GRAD_REL_L2}
        assert not over, (r, over)
        worst_control = max(worst_control,
                            max(errors(got["control"]).values()))
    assert worst_control > GRAD_REL_L2, worst_control


def check_train_f32(runs):
    """The TP step in f32 at (2, 2): every gathered gradient leaf within
    F32_GRAD_REL of the unsharded f32 step (the bf16 steps differ by
    rounding alone)."""
    name = runs["fam"]["train"]
    want = [(p, w.double()) for p, w in _leaves(runs["train"]["f32"])]
    for r, res in enumerate(runs["ranks"][(2, 2)]):
        got = [g for _, g in _leaves(res[name]["train"]["f32"])]
        for (path, w), g in zip(want, got):
            if bool(w.any()):
                err = float((g.double() - w).norm() / w.norm())
                assert err <= F32_GRAD_REL, (r, path, err)


def make_runs(fam, module, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(module)
    runs = start(fam, module, tmp)
    runs["fam"] = fam
    return runs


# ---------------------------------------------------------------------------
# Zamba2
# ---------------------------------------------------------------------------

NAMES = list(FAMILY["configs"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return make_runs(FAMILY, "test_torch_tp_families", tmp_path_factory)


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("name", NAMES)
def test_shards_and_rec_equal_reference_blocks(runs, name, shape):
    check_shards(FAMILY, runs, name, shape)


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("name", NAMES)
def test_residual_per_layer_near_unsharded_and_reference(runs, name, shape):
    check_residuals(FAMILY, runs, name, shape)


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("name", NAMES)
def test_logits_within_whole_model_limits(runs, name, shape):
    check_logits(FAMILY, runs, name, shape)


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("name", NAMES)
def test_hot_tier_state_exact(runs, name, shape):
    check_hot(runs, name, shape)


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("name", NAMES)
def test_layer_f32_forward_backward_decode(runs, name, shape):
    check_layers(runs, name, shape)


@pytest.mark.parametrize("name", NAMES)
def test_sparse_equals_dense_in_tp_world(runs, name):
    for r, res in enumerate(runs["ranks"][(2, 2)]):
        sac, dense = res[name]["sparse_dense"]
        for a, b in zip(sac, dense):
            assert torch.equal(a, b), (name, r)


@pytest.mark.parametrize("name", NAMES)
def test_world_of_one_equals_unsharded(runs, name):
    check_world_of_one(runs, name)


def test_train_step_world_of_one_bit_equal(runs):
    check_train_world_of_one(runs)


def test_train_step_near_unsharded_with_control(runs):
    check_train(runs)


def test_train_step_f32_equals_unsharded(runs):
    check_train_f32(runs)


def test_rec_block_follows_the_reference_layout():
    """``tp.rec_block`` puts ``model`` where the reference's
    ``_rec_pspec`` does on the leaf's global shape (found by the port's
    own lane axis), and refuses a layout that would put the lanes or
    ``model`` on a stacked layer axis: Zamba2-7B's ``zamba_super`` SSM
    state ``[13, 6, B, 112, 64, 64]`` with 13 lanes in all at model 2."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.tp import TensorParallel
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    with dryrun.fake_world(2):
        mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
        tp = TensorParallel(mesh, shd.SERVE_RULES, ("data",))
        axis, split = tp.rec_block([13, 6, 8, 112, 64, 64], 2)
        assert axis == 3 and split.n == 2 and split.index == 0
        assert dryrun._rec_pspec((13, 6, 8, 112, 64, 64), 8, 2) == [
            None, None, "__B__", "model", None, None]
        # xLSTM-125M's stabiliser m [3, 3, B, 4] over model 2: its heads
        assert tp.rec_block([3, 3, 8, 4], 2)[0] == 3
        with pytest.raises(ValueError, match="stacked|batch on axis 0"):
            tp.rec_block([13, 6, 13, 112, 64, 64], 2)


def test_mamba2_backward_finite_past_exp_overflow():
    """The SSD's intra-chunk decay overflows above the diagonal once a
    chunk's summed dt * A passes 88 (a 128-token chunk of Zamba2-7B's
    random weights does): the reference's where(mask, exp(seg), 0) then
    has a NaN gradient; the port's masks the exponent first, so its
    forward is the same and its gradient finite."""
    from repro_torch.models import ssm
    from repro_torch.models.layers import init_params
    cfg = _cfg(FAMILY, "zamba2")
    p = init_params(ssm.mamba2_param_specs(cfg),
                    torch.Generator().manual_seed(0), "cpu")
    p["dt_bias"] = torch.full_like(p["dt_bias"], 8.0)     # dt ~ 8 a token
    p = {k: v.detach().requires_grad_() for k, v in p.items()}
    x = torch.randn((2, 32, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)).bfloat16()
    out, _ = ssm.mamba2_block(p, x, cfg)
    out.float().square().sum().backward()
    assert torch.isfinite(out.float()).all()
    for k, v in p.items():
        assert torch.isfinite(v.grad.float()).all(), k
    # the reference's decay, built as it builds it, has the same values
    cum = torch.cumsum(torch.full((32,), -8.0), 0)
    seg = cum[:, None] - cum[None, :]
    lower = torch.ones((32, 32), dtype=torch.bool).tril()
    assert torch.isinf(torch.exp(seg)).any()
    assert torch.equal(torch.where(lower, torch.exp(seg), 0.0),
                       torch.exp(torch.where(lower, seg, -torch.inf)))
