"""State-space and recurrent blocks (``repro/models/ssm.py``): Mamba2
(the chunked SSD scan of Zamba2's backbone) and xLSTM (mLSTM matrix
memory, sLSTM scalar memory), as plain PyTorch: the reference has no
kernel for them.

Mamba2 follows the state-space-duality formulation: within a chunk the
output is computed quadratically (here for all chunks at once), and the
state is carried from chunk to chunk by a loop, as the reference's
``lax.scan`` carries it.  A prompt of S positions is cut into
``max(S // chunk, 1)`` chunks of equal length, so S must divide evenly
once it reaches two chunks (the reference fails there too).  The
``*_decode`` functions take one token per request and return the new
recurrent state; the model writes it back into the serve state.

Over a tensor-parallel rank (a config view with ``tp``,
``distributed/tp.py``) each block runs on the rank's blocks of the
weights, which need not be whole heads:

- Mamba2: the rank's columns of the fused ``w_in`` projection (z, x, B,
  C, dt) are all-gathered over ``model`` (one collective; its backward
  reduce-scatters), and the rank keeps z and x of its d_inner block, the
  whole B and C, and dt of the heads its block touches.  The SSD is
  independent along head_dim, so a block that cuts a head needs nothing
  more.  The gated ``rms_norm`` runs over the whole d_inner
  (``tp.rms_norm``: one all-reduce of the squared sums) and ``w_out``'s
  row block is summed over ``model``.  Decode runs on the rank's block of
  the SSM state (``tp.rec_block``): its heads (its own columns), or,
  where the heads do not split, its block of the state dim N (the conv
  output all-gathered, the partial outputs summed over ``model``).
- mLSTM: q, k, v and the output gate are column blocks, ``w_out`` a row
  block, the output norm distributed.  A block that is part of a head
  has its head's q and k all-gathered (prefill) or, at decode, where the
  state splits C's key axis, q, k and v all-gathered and the key axis's
  partial products ``q C`` and ``q n`` summed over ``model`` (the
  normaliser taken after the sum).
- sLSTM: each unit needs its z, i, f and o and every step's ``h @
  r_zifo`` the whole h, so every step all-gathers the rank's block of
  the gates (one collective a step) and every rank carries the whole
  state; decode all-gathers the rank's block of the state first.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.tp import Split, _memo, tp_of
from repro_torch.models.layers import ParamSpec, rms_norm


def _softplus(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) without a threshold."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


# ---------------------------------------------------------------------------
# Mamba2 (zamba2 backbone)
# ---------------------------------------------------------------------------


def mamba2_dims(cfg):
    d_inner = 2 * cfg.d_model
    head_d = 64
    n_heads = d_inner // head_d
    return d_inner, n_heads, head_d, cfg.ssm_state


def mamba2_param_specs(cfg) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    d_inner, nh, hd, N = mamba2_dims(cfg)
    return {
        "w_in": ParamSpec((d, 2 * d_inner + 2 * N + nh), ("D", "F")),  # x,z,B,C,dt
        "conv": ParamSpec((4, d_inner), ("C4", "F"), scale=0.5),
        "A_log": ParamSpec((nh,), ("Hm",), init="zeros"),
        "dt_bias": ParamSpec((nh,), ("Hm",), init="zeros"),
        "D_skip": ParamSpec((nh,), ("Hm",), init="ones"),
        "norm_g": ParamSpec((d_inner,), ("F",), init="ones"),
        "w_out": ParamSpec((d_inner, d), ("F", "D")),
    }


def _block_heads(lo: int, hi: int, hd: int) -> Tuple[int, int, int, int]:
    """(h0, h1, d0, d1): the heads ``[h0, h1)`` a block ``[lo, hi)`` of a
    fused head dim touches, and its columns ``[d0, d1)`` within each
    (whole heads, or a part of one head)."""
    w = hi - lo
    if w % hd == 0:
        return lo // hd, hi // hd, 0, hd
    if hd % w == 0:
        return lo // hd, lo // hd + 1, lo % hd, lo % hd + w
    raise ValueError(f"a block [{lo}, {hi}) of heads of {hd} is neither "
                     "whole heads nor a part of one head")


def _box(tp, got, whole):
    """[(lo, hi)] of each dim: this rank's block of a state whose per-lane
    dims are ``whole``, held as ``got`` (a dim that differs is split over
    ``model``)."""
    out = []
    for g, w in zip(got, whole):
        i = 0 if g == w else tp.coord["model"]
        out.append((i * g, (i + 1) * g))
    return out


@dataclasses.dataclass(frozen=True)
class MambaLayout:
    """A rank's Mamba2 blocks: ``w_in``'s columns, the d_inner block of
    ``conv`` / ``norm_g`` / ``w_out``, the heads of ``A_log`` / ``dt_bias``
    / ``D_skip``, and ``heads`` (h0, h1, d0, d1) of the d_inner block."""
    w_in: Split
    f: Split
    hm: Split
    heads: Tuple[int, int, int, int]


def mamba_layout(cfg) -> MambaLayout:
    return _memo(cfg, "mamba2", _mamba_layout)


def _mamba_layout(cfg) -> MambaLayout:
    tp = tp_of(cfg)
    d_inner, nh, hd, N = mamba2_dims(cfg)
    f = tp.split(("F", "D"), (d_inner, cfg.d_model), 0)
    return MambaLayout(
        tp.split(("D", "F"), (cfg.d_model, 2 * d_inner + 2 * N + nh), 1), f,
        tp.split(("Hm",), (nh,), 0), _block_heads(*f.bounds(d_inner), hd))


def _head_params(p, cfg, h0: int, h1: int):
    """(dt_bias, A_log, D_skip) of the heads [h0, h1): the rank's block
    where ``Hm`` is split (it must be those heads), else a slice of the
    whole, whose rank-specific use starts here."""
    tp, lay = tp_of(cfg), mamba_layout(cfg)
    names, nh = ("dt_bias", "A_log", "D_skip"), mamba2_dims(cfg)[1]
    if lay.hm.n > 1:
        if lay.hm.bounds(nh) != (h0, h1):
            raise ValueError(f"the rank runs heads [{h0}, {h1}), its Hm "
                             f"block is {lay.hm.bounds(nh)}")
        return tuple(p[k] for k in names)
    return tuple(tp.enter(p[k], lay.f.axes)[h0:h1] for k in names)


def _mamba2_project(p, x, cfg, heads=None):
    """The rank's pieces of the fused projection: z and x of its d_inner
    block, B and C whole, dt (through softplus) and A of the heads
    ``heads`` (by default its block's), and their ``D_skip``."""
    tp, lay = tp_of(cfg), mamba_layout(cfg)
    d_inner, nh, hd, N = mamba2_dims(cfg)
    shape = (cfg.d_model, 2 * d_inner + 2 * N + nh)
    zx = tp.matmul(tp.enter(x, lay.w_in.axes), p["w_in"], ("D", "F"), shape)
    if lay.w_in.n > 1:       # every rank uses its own part of the whole
        zx = tp.all_gather(zx, lay.w_in.axes, reduce=lay.f.n > 1)
    else:
        zx = tp.enter(zx, lay.f.axes)
    f0, f1 = lay.f.bounds(d_inner)
    h0, h1 = heads or lay.heads[:2]
    o = 2 * d_inner + 2 * N
    z, xs = zx[..., f0:f1], zx[..., d_inner + f0:d_inner + f1]
    Bc, Cc = zx[..., 2 * d_inner:2 * d_inner + N], zx[..., 2 * d_inner + N:o]
    dt_bias, A_log, D_skip = _head_params(p, cfg, h0, h1)
    dt = _softplus(zx[..., o + h0:o + h1].float() + dt_bias.float())
    A = -torch.exp(A_log.float())                               # [nh] < 0
    return z, xs, Bc, Cc, dt, A, D_skip


def _causal_conv(xs, conv_w, state=None):
    """Depthwise causal conv, kernel 4.  xs: [B, S, F]; ``state`` the
    last 3 inputs [B, 3, F] (zeros when None).  The four products are
    summed in the reference's order (a Python ``sum`` from 0)."""
    B, S, Fd = xs.shape
    k = conv_w.shape[0]
    pad = (torch.zeros((B, k - 1, Fd), dtype=xs.dtype, device=xs.device)
           if state is None else state)
    xp = torch.cat([pad, xs], dim=1)
    out = sum(xp[:, i:i + S, :] * conv_w[i] for i in range(k))
    return F.silu(out), xp[:, S:, :]


def mamba2_block(p, x, cfg, *, chunk: int = 256):
    """Prefill SSD pass.  x: [B, S, D] -> ([B, S, D], last_state
    [B, nh, N, hd] f32)."""
    B, S, D = x.shape
    d_inner, nh, hd, N = mamba2_dims(cfg)
    n_chunks = max(S // chunk, 1)
    Lc = S // n_chunks
    if n_chunks * Lc != S:
        raise ValueError(
            f"mamba2_block: a prompt of {S} positions is cut into "
            f"max(S // chunk, 1) = {n_chunks} chunks of {Lc} (chunk = "
            f"{chunk}), which leaves {S - n_chunks * Lc}; S must be a "
            f"multiple of S // (S // chunk) once S >= 2 * chunk")
    tp, lay = tp_of(cfg), mamba_layout(cfg)
    z, xs, Bc, Cc, dt, A, D_skip = _mamba2_project(p, x, cfg)
    xs, _ = _causal_conv(xs, p["conv"])
    h0, h1, d0, d1 = lay.heads            # the rank's heads and columns
    nh, hd = h1 - h0, d1 - d0
    xh = xs.reshape(B, S, nh, hd).float()

    xh_c = xh.reshape(B, n_chunks, Lc, nh, hd)
    B_c = Bc.reshape(B, n_chunks, Lc, N).float()
    C_c = Cc.reshape(B, n_chunks, Lc, N).float()
    dt_c = dt.reshape(B, n_chunks, Lc, nh)                      # [B,c,L,nh]
    cum = torch.cumsum(dt_c * A, dim=2)                         # within-chunk

    # intra-chunk quadratic part, every chunk at once.  Above the
    # diagonal exp(seg) can overflow to inf: the exponent is masked to
    # -inf first, so the forward is the reference's where(mask, exp(seg),
    # 0) bit for bit and the backward never forms 0 * inf (the
    # reference's gradient is NaN once a chunk's decay passes e^88)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]         # [B,c,L,L,nh]
    lower = torch.ones((Lc, Lc), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(lower[:, :, None], seg,
                                  torch.full((), -math.inf,
                                             device=x.device)))
    del seg
    G = torch.einsum("bcln,bcmn->bclm", C_c, B_c)               # [B,c,L,L]
    # dt on B's side (the reference's scan hands dt_c to its body under
    # the name dA_j)
    M = G[..., None] * decay * dt_c[:, :, None, :, :]           # [B,c,L,L,nh]
    del decay
    y = torch.einsum("bclmh,bcmhd->bclhd", M, xh_c)
    del M
    # each chunk's own contribution to the state it hands on
    chunk_decay = torch.exp(cum[:, :, -1:, :] - cum)            # [B,c,L,nh]
    wB = B_c[:, :, :, None, :] * (dt_c * chunk_decay)[..., None]
    dS = torch.einsum("bclhn,bclhd->bchnd", wB, xh_c)           # [B,c,nh,N,hd]
    # the carried state: the state entering chunk j, a loop over chunks
    last = torch.exp(cum[:, :, -1, :])                          # [B,c,nh]
    state = torch.zeros((B, nh, N, hd), dtype=torch.float32,
                        device=x.device)
    states_in = []
    for j in range(n_chunks):
        states_in.append(state)
        state = state * last[:, j, :, None, None] + dS[:, j]
    states_in = torch.stack(states_in, 1)                       # [B,c,nh,N,hd]
    y = y + torch.einsum("bcln,bchnd->bclhd", C_c,
                         states_in) * torch.exp(cum)[..., None]
    y = y.reshape(B, S, nh, hd)
    y = y + xh * D_skip.float()[None, None, :, None]
    y = y.reshape(B, S, nh * hd).to(x.dtype)
    y = tp.rms_norm(y * F.silu(z), p["norm_g"], lay.f.axes, d_inner)
    return tp.matmul(y, p["w_out"], ("F", "D"), (d_inner, D),
                     lay.f.axes), state


def mamba2_decode(p, x, cfg, state):
    """One-token update.  x: [B, D]; state: (ssm [B, nh, N, hd] f32,
    conv [B, 3, F]) -> (out [B, D], new state).  Over a tensor-parallel
    rank the state is its block (``tp.rec_block``): the SSM state's heads
    of its d_inner block, or all heads and its block of N; the conv
    state's d_inner block."""
    ssm_state, conv_state = state
    B, D = x.shape
    d_inner, nh, hd, N = mamba2_dims(cfg)
    tp, lay = tp_of(cfg), mamba_layout(cfg)
    (h0, h1), (n0, n1), (d0, d1) = _box(tp, ssm_state.shape[1:],
                                        (nh, N, hd))
    own = (h0, h1, d0, d1) == lay.heads      # the state of its own columns
    if not own and (h0, h1, d0, d1) != (0, nh, 0, hd):
        raise ValueError(f"an SSM state block of heads [{h0}, {h1}) and "
                         f"columns [{d0}, {d1}): neither the rank's own "
                         f"columns {lay.heads} nor every head's")
    z, xs, Bc, Cc, dt, A, D_skip = _mamba2_project(p, x[:, None, :], cfg,
                                                   (h0, h1))
    xs, conv_state = _causal_conv(xs, p["conv"], conv_state)
    if not own:                                  # every head's columns
        xs = tp.all_gather(xs, lay.f.axes)
    xh = xs.reshape(B, h1 - h0, d1 - d0).float()
    dt0 = dt[:, 0]                                              # [B,nh]
    dA = torch.exp(dt0 * A)
    Bf = Bc[:, 0, n0:n1].float()                                # [B,N]
    Cf = Cc[:, 0, n0:n1].float()
    ssm_state = ssm_state * dA[..., None, None] + \
        Bf[:, None, :, None] * (dt0[..., None] * xh)[:, :, None, :]
    y = torch.einsum("bn,bhnd->bhd", Cf, ssm_state)
    if n1 - n0 < N:                 # partial sums over the rank's block of N
        y = tp.all_reduce(y, ("model",))
    y = y + xh * D_skip.float()[None, :, None]
    y = y.reshape(B, (h1 - h0) * (d1 - d0))
    if not own:
        y = y[:, slice(*lay.f.bounds(d_inner))]
    y = y.to(x.dtype)
    y = tp.rms_norm(y * F.silu(z[:, 0]), p["norm_g"], lay.f.axes, d_inner)
    return tp.matmul(y, p["w_out"], ("F", "D"), (d_inner, D),
                     lay.f.axes), (ssm_state, conv_state)


def mamba2_state_shape(cfg, B):
    d_inner, nh, hd, N = mamba2_dims(cfg)
    return ((B, nh, N, hd), (B, 3, d_inner))


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory) + sLSTM (scalar memory)
# ---------------------------------------------------------------------------


def mlstm_param_specs(cfg) -> Dict[str, ParamSpec]:
    d, nh = cfg.d_model, cfg.n_heads
    return {
        "wq": ParamSpec((d, d), ("D", "H")),
        "wk": ParamSpec((d, d), ("D", "H")),
        "wv": ParamSpec((d, d), ("D", "H")),
        "wi": ParamSpec((d, nh), ("D", "Hm")),
        "wf": ParamSpec((d, nh), ("D", "Hm")),
        "wo_gate": ParamSpec((d, d), ("D", "H")),
        "w_out": ParamSpec((d, d), ("H", "D")),
        "norm_g": ParamSpec((d,), ("H",), init="ones"),
    }


def mlstm_layout(cfg) -> Tuple[Split, Split, Tuple[int, int, int, int]]:
    """(H split of ``wq`` / ``wk`` / ``wv`` / ``wo_gate`` / ``w_out`` /
    ``norm_g``, Hm split of ``wi`` / ``wf``, (h0, h1, d0, d1) of the H
    block) of an mLSTM layer on a rank."""
    return _memo(cfg, "mlstm", _mlstm_layout)


def _mlstm_layout(cfg):
    tp, d, nh = tp_of(cfg), cfg.d_model, cfg.n_heads
    q = tp.split(("D", "H"), (d, d), 1)
    return q, tp.split(("D", "Hm"), (d, nh), 1), \
        _block_heads(*q.bounds(d), d // nh)


def _mlstm_gates(p, x, cfg, h0: int, h1: int):
    """The forget and input gates' logs [..., h1 - h0] of heads [h0, h1):
    from the rank's ``wf`` / ``wi`` block where ``Hm`` is split (its own
    heads), else from the whole, whose rank-specific use starts here."""
    tp, (q, hm, _) = tp_of(cfg), mlstm_layout(cfg)
    d, nh = cfg.d_model, cfg.n_heads
    xe = tp.enter(x, hm.axes)
    lf, li = (tp.matmul(xe, p[k], ("D", "Hm"), (d, nh)) for k in ("wf", "wi"))
    if hm.n > 1:
        if hm.bounds(nh) != (h0, h1):
            raise ValueError(f"the rank runs heads [{h0}, {h1}), its Hm "
                             f"block is {hm.bounds(nh)}")
    else:
        lf, li = (tp.enter(t, q.axes)[..., h0:h1] for t in (lf, li))
    return F.logsigmoid(lf.float()), li.float()


def _mlstm_out(p, x, y, cfg):
    """The rank's H block of the cell output y [..., cols] -> the layer's
    [..., D]: the norm over the whole d, the output gate, ``w_out``'s row
    block summed over the H axes."""
    tp, (q, _, _) = tp_of(cfg), mlstm_layout(cfg)
    d = cfg.d_model
    y = tp.rms_norm(y, p["norm_g"], q.axes, d)
    o = torch.sigmoid(tp.matmul(tp.enter(x, q.axes), p["wo_gate"],
                                ("D", "H"), (d, d)))
    return tp.matmul(y * o, p["w_out"], ("H", "D"), (d, d), q.axes)


def mlstm_block(p, x, cfg):
    """Parallel (prefill) mLSTM: decayed linear attention. x: [B, S, D].
    Over a tensor-parallel rank: its heads, or, where its block is part
    of a head, that head's whole q and k (all-gathered) and its block of
    v."""
    B, S, D = x.shape
    nh = cfg.n_heads
    hd = D // nh
    tp, (qs, _, (h0, h1, d0, d1)) = tp_of(cfg), mlstm_layout(cfg)
    xe = tp.enter(x, qs.axes)
    q, k, v = (tp.matmul(xe, p[w], ("D", "H"), (D, D))
               for w in ("wq", "wk", "wv"))
    if d1 - d0 < hd:                          # its head's whole q and k
        qk = tp.all_gather(torch.stack([q, k]), qs.axes, reduce=True)
        q, k = qk[..., h0 * hd:h1 * hd].unbind(0)
    nh = h1 - h0
    q = q.reshape(B, S, nh, hd).float() / math.sqrt(hd)
    k = k.reshape(B, S, nh, hd).float() / math.sqrt(hd)
    v = v.reshape(B, S, nh, d1 - d0).float()
    logf, logi = _mlstm_gates(p, x, cfg, h0, h1)
    Fc = torch.cumsum(logf, dim=1)
    # D_ts = exp(F_t - F_s + i_s), stabilised, causal
    logD = Fc[:, :, None, :] - Fc[:, None, :, :] + logi[:, None, :, :]
    lower = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    logD = torch.where(lower[None, :, :, None], logD,
                       torch.full((), -math.inf, device=x.device))
    m = logD.amax(dim=2, keepdim=True)
    scores = torch.einsum("bthd,bshd->btsh", q, k) * torch.exp(logD - m)
    norm = torch.maximum(scores.sum(2).abs(), torch.exp(-m[:, :, 0, :]))
    y = torch.einsum("btsh,bshd->bthd", scores, v) / norm[..., None]
    return _mlstm_out(p, x, y.reshape(B, S, -1).to(x.dtype), cfg)


def mlstm_decode(p, x, cfg, state):
    """Recurrent mLSTM step. state: (C [B,nh,hd,hd], n [B,nh,hd], m [B,nh]).
    Over a tensor-parallel rank the state is its block (``tp.rec_block``):
    its heads (its own columns), or every head's block of C's and n's key
    axis (q, k and v all-gathered; ``q C`` and ``q n`` summed over
    ``model`` before the normaliser)."""
    C, n, mprev = state
    B, D = x.shape
    nh = cfg.n_heads
    hd = D // nh
    tp, (qs, _, heads) = tp_of(cfg), mlstm_layout(cfg)
    (h0, h1), (k0, k1), (e0, e1) = _box(tp, C.shape[1:], (nh, hd, hd))
    own = (h0, h1, k0, k1) == heads
    if (e0, e1) != (0, hd) or not (own or (h0, h1) == (0, nh)):
        raise ValueError(f"an mLSTM state block of heads [{h0}, {h1}), "
                         f"keys [{k0}, {k1}), values [{e0}, {e1})")
    xe = tp.enter(x, qs.axes)
    q, k, v = (tp.matmul(xe, p[w], ("D", "H"), (D, D))
               for w in ("wq", "wk", "wv"))
    if not own:
        q, k, v = tp.all_gather(torch.stack([q, k, v]), qs.axes).reshape(
            3, B, nh, hd)[:, :, h0:h1].unbind(0)
        q, k = q[..., k0:k1], k[..., k0:k1]
    shape = (B, h1 - h0, -1)
    q = q.reshape(shape).float() / math.sqrt(hd)
    k = k.reshape(shape).float() / math.sqrt(hd)
    v = v.reshape(shape).float()
    logf, logi = _mlstm_gates(p, x, cfg, h0, h1)
    m_new = torch.maximum(logf + mprev, logi)
    fg = torch.exp(logf + mprev - m_new)
    ig = torch.exp(logi - m_new)
    C = C * fg[..., None, None] + ig[..., None, None] * (k[..., :, None]
                                                         * v[..., None, :])
    n = n * fg[..., None] + ig[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.einsum("bhd,bhd->bh", q, n)
    if k1 - k0 < hd:                  # partial sums over the key block
        nd = tp.all_reduce(torch.cat([num, den[..., None]], -1), ("model",))
        num, den = nd[..., :hd], nd[..., hd]
    den = torch.maximum(den.abs(), torch.exp(-m_new))
    y = (num / den[..., None]).reshape(B, -1)
    if not own:
        y = y[:, slice(*qs.bounds(D))]
    return _mlstm_out(p, x, y.to(x.dtype), cfg), (C, n, m_new)


def slstm_param_specs(cfg) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    return {
        "w_zifo": ParamSpec((d, 4 * d), ("D", "F")),
        "r_zifo": ParamSpec((d, 4 * d), ("D", "F"), scale=0.5),
        "norm_g": ParamSpec((d,), ("H",), init="ones"),
        "w_out": ParamSpec((d, d), ("H", "D")),
    }


def slstm_layout(cfg) -> Tuple[Split, Split]:
    """(F split of ``w_zifo`` / ``r_zifo``, H split of ``norm_g`` /
    ``w_out``) of an sLSTM layer on a rank."""
    return _memo(cfg, "slstm", _slstm_layout)


def _slstm_layout(cfg):
    tp, d = tp_of(cfg), cfg.d_model
    return (tp.split(("D", "F"), (d, 4 * d), 1),
            tp.split(("H", "D"), (d, d), 0))


def _slstm_step(rz, carry, xw_t, dtype, tp, w: Split):
    """One sLSTM step from ``xw_t`` = the rank's columns of (x_t @
    w_zifo) in f32 and the whole carry; ``rz(h)`` is h @ the rank's
    ``r_zifo`` block.  The gates' blocks are all-gathered (one collective
    a step); every rank carries the whole state."""
    h, c, n, m = carry                                          # [B,D] f32
    g = tp.all_gather(xw_t + rz(tp.enter(h.to(dtype), w.axes)), w.axes)
    z, i, f, o = torch.chunk(g.float(), 4, dim=-1)
    m_new = torch.maximum(f + m, i)
    ig = torch.exp(i - m_new)
    fg = torch.exp(f + m - m_new)
    c = fg * c + ig * torch.tanh(z)
    n = fg * n + ig
    h = torch.sigmoid(o) * c / torch.clamp(n, min=1e-6)
    return (h, c, n, m_new)


def _slstm_in(p, x, cfg):
    """(the rank's columns of x @ w_zifo in f32, h -> h @ its r_zifo
    block, the splits)."""
    tp, (w, u) = tp_of(cfg), slstm_layout(cfg)
    d = cfg.d_model
    xw = tp.matmul(tp.enter(x, w.axes), p["w_zifo"], ("D", "F"),
                   (d, 4 * d)).float()
    return xw, tp.product(p["r_zifo"], ("D", "F"), (d, 4 * d)), w, u


def _slstm_out(p, h, cfg, u: Split):
    """The whole h [..., D] -> the layer's output: the norm over d (whole
    on every rank), the rank's H block of it through ``w_out``'s row
    block, summed over the H axes."""
    tp, d = tp_of(cfg), cfg.d_model
    if u.n == 1:
        return tp.matmul(rms_norm(h, p["norm_g"]), p["w_out"], ("H", "D"),
                         (d, d))
    hf = tp.enter(h, u.axes).float()
    lo, hi = u.bounds(d)
    hn = (hf * torch.rsqrt(hf.square().mean(dim=-1, keepdim=True) + 1e-6)
          ).to(h.dtype)[..., lo:hi] * p["norm_g"]
    return tp.matmul(hn, p["w_out"], ("H", "D"), (d, d), u.axes)


def slstm_block(p, x, cfg):
    """Sequential sLSTM over time (the reference's ``lax.scan``): a loop
    over the S positions.  x: [B, S, D]."""
    B, S, D = x.shape
    tp = tp_of(cfg)
    xw, rz, w, u = _slstm_in(p, x, cfg)                         # [B,S,4D]
    carry = tuple(torch.zeros((B, D), dtype=torch.float32, device=x.device)
                  for _ in range(4))
    hs = []
    for t in range(S):
        carry = _slstm_step(rz, carry, xw[:, t], x.dtype, tp, w)
        hs.append(carry[0])
    return _slstm_out(p, torch.stack(hs, 1).to(x.dtype), cfg, u)


def slstm_decode(p, x, cfg, state):
    """One step.  Over a tensor-parallel rank the state (h, c, n, m) is
    its block of the units (``tp.rec_block``): all-gathered whole first,
    the rank's block of the new state kept."""
    tp, D = tp_of(cfg), cfg.d_model
    (lo, hi), = _box(tp, state[0].shape[1:], (D,))
    if hi - lo < D:
        state = tuple(tp.all_gather(torch.stack(state), ("model",)))
    xw, rz, w, u = _slstm_in(p, x, cfg)
    new = _slstm_step(rz, state, xw, x.dtype, tp, w)
    y = _slstm_out(p, new[0].to(x.dtype), cfg, u)
    return y, tuple(t[:, lo:hi] for t in new)
