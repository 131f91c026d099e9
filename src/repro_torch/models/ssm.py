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
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

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


def _mamba2_project(p, x, cfg):
    d_inner, nh, hd, N = mamba2_dims(cfg)
    zxbcdt = x @ p["w_in"]
    z, xs, Bc, Cc, dt = torch.split(zxbcdt, [d_inner, d_inner, N, N, nh],
                                    dim=-1)
    dt = _softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())                          # [nh] < 0
    return z, xs, Bc, Cc, dt, A


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
    z, xs, Bc, Cc, dt, A = _mamba2_project(p, x, cfg)
    xs, _ = _causal_conv(xs, p["conv"])
    xh = xs.reshape(B, S, nh, hd).float()

    xh_c = xh.reshape(B, n_chunks, Lc, nh, hd)
    B_c = Bc.reshape(B, n_chunks, Lc, N).float()
    C_c = Cc.reshape(B, n_chunks, Lc, N).float()
    dt_c = dt.reshape(B, n_chunks, Lc, nh)                      # [B,c,L,nh]
    cum = torch.cumsum(dt_c * A, dim=2)                         # within-chunk

    # intra-chunk quadratic part, every chunk at once.  Above the
    # diagonal exp(seg) can overflow to inf: a where, never a 0/1 product
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]         # [B,c,L,L,nh]
    lower = torch.ones((Lc, Lc), dtype=torch.bool, device=x.device).tril()
    decay = torch.where(lower[:, :, None], torch.exp(seg),
                        torch.zeros((), device=x.device))
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
    y = y + xh * p["D_skip"].float()[None, None, :, None]
    y = y.reshape(B, S, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm_g"])
    return y @ p["w_out"], state


def mamba2_decode(p, x, cfg, state):
    """One-token update.  x: [B, D]; state: (ssm [B, nh, N, hd] f32,
    conv [B, 3, F]) -> (out [B, D], new state)."""
    ssm_state, conv_state = state
    B, D = x.shape
    d_inner, nh, hd, N = mamba2_dims(cfg)
    z, xs, Bc, Cc, dt, A = _mamba2_project(p, x[:, None, :], cfg)
    xs, conv_state = _causal_conv(xs, p["conv"], conv_state)
    xh = xs.reshape(B, nh, hd).float()
    dt0 = dt[:, 0]                                              # [B,nh]
    dA = torch.exp(dt0 * A)
    Bf = Bc[:, 0].float()                                       # [B,N]
    Cf = Cc[:, 0].float()
    ssm_state = ssm_state * dA[..., None, None] + \
        Bf[:, None, :, None] * (dt0[..., None] * xh)[:, :, None, :]
    y = torch.einsum("bn,bhnd->bhd", Cf, ssm_state)
    y = y + xh * p["D_skip"].float()[None, :, None]
    y = y.reshape(B, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z[:, 0]), p["norm_g"])
    return y @ p["w_out"], (ssm_state, conv_state)


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


def _mlstm_qkv(p, x, nh, hd):
    """q, k (scaled by 1/sqrt(hd)) and v in f32, [..., nh, hd]; the
    forget and input gates' logs [..., nh]."""
    shape = (*x.shape[:-1], nh, hd)
    q = (x @ p["wq"]).reshape(shape).float() / math.sqrt(hd)
    k = (x @ p["wk"]).reshape(shape).float() / math.sqrt(hd)
    v = (x @ p["wv"]).reshape(shape).float()
    logf = F.logsigmoid((x @ p["wf"]).float())
    logi = (x @ p["wi"]).float()
    return q, k, v, logf, logi


def mlstm_block(p, x, cfg):
    """Parallel (prefill) mLSTM: decayed linear attention. x: [B, S, D]."""
    B, S, D = x.shape
    nh = cfg.n_heads
    hd = D // nh
    q, k, v, logf, logi = _mlstm_qkv(p, x, nh, hd)
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
    y = rms_norm(y.reshape(B, S, D).to(x.dtype), p["norm_g"])
    o = torch.sigmoid(x @ p["wo_gate"])
    return (y * o) @ p["w_out"]


def mlstm_decode(p, x, cfg, state):
    """Recurrent mLSTM step. state: (C [B,nh,hd,hd], n [B,nh,hd], m [B,nh])."""
    C, n, mprev = state
    B, D = x.shape
    nh = cfg.n_heads
    hd = D // nh
    q, k, v, logf, logi = _mlstm_qkv(p, x, nh, hd)
    m_new = torch.maximum(logf + mprev, logi)
    fg = torch.exp(logf + mprev - m_new)
    ig = torch.exp(logi - m_new)
    C = C * fg[..., None, None] + ig[..., None, None] * (k[..., :, None]
                                                         * v[..., None, :])
    n = n * fg[..., None] + ig[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", q, n).abs(),
                        torch.exp(-m_new))
    y = (num / den[..., None]).reshape(B, D).to(x.dtype)
    y = rms_norm(y, p["norm_g"])
    o = torch.sigmoid(x @ p["wo_gate"])
    return (y * o) @ p["w_out"], (C, n, m_new)


def slstm_param_specs(cfg) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    return {
        "w_zifo": ParamSpec((d, 4 * d), ("D", "F")),
        "r_zifo": ParamSpec((d, 4 * d), ("D", "F"), scale=0.5),
        "norm_g": ParamSpec((d,), ("H",), init="ones"),
        "w_out": ParamSpec((d, d), ("H", "D")),
    }


def _slstm_step(p, carry, xw_t, dtype):
    """One sLSTM step from ``xw_t`` = (x_t @ w_zifo) in f32."""
    h, c, n, m = carry                                          # [B,D] f32
    g = xw_t + h.to(dtype) @ p["r_zifo"]
    z, i, f, o = torch.chunk(g.float(), 4, dim=-1)
    m_new = torch.maximum(f + m, i)
    ig = torch.exp(i - m_new)
    fg = torch.exp(f + m - m_new)
    c = fg * c + ig * torch.tanh(z)
    n = fg * n + ig
    h = torch.sigmoid(o) * c / torch.clamp(n, min=1e-6)
    return (h, c, n, m_new)


def slstm_block(p, x, cfg):
    """Sequential sLSTM over time (the reference's ``lax.scan``): a loop
    over the S positions.  x: [B, S, D]."""
    B, S, D = x.shape
    xw = (x @ p["w_zifo"]).float()                              # [B,S,4D]
    carry = tuple(torch.zeros((B, D), dtype=torch.float32, device=x.device)
                  for _ in range(4))
    hs = []
    for t in range(S):
        carry = _slstm_step(p, carry, xw[:, t], x.dtype)
        hs.append(carry[0])
    y = torch.stack(hs, 1).to(x.dtype)
    return rms_norm(y, p["norm_g"]) @ p["w_out"]


def slstm_decode(p, x, cfg, state):
    new = _slstm_step(p, state, (x @ p["w_zifo"]).float(), x.dtype)
    y = rms_norm(new[0].to(x.dtype), p["norm_g"]) @ p["w_out"]
    return y, new
