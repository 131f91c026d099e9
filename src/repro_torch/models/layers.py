"""Shared model layers (``repro/models/layers.py``): the parameter
system, norms, RoPE, SwiGLU, the GQA projections, the chunked causal
attention of prefill (full or sliding-window) and the dense MLP.

Parameters are plain dictionaries of tensors.  Every leaf is declared by
a ``ParamSpec`` with the reference's shape, logical dims and init rule;
``materialize`` draws it from an explicit ``torch.Generator`` directly
in its own dtype on its own device (no f32 temporary of a large stack).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

DTYPE = torch.bfloat16


# ---------------------------------------------------------------------------
# parameter system
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    dims: Tuple[str, ...]            # logical dim names, len == len(shape)
    init: str = "normal"             # normal | zeros | ones
    scale: float = 1.0
    dtype: Any = DTYPE

    def materialize(self, generator: torch.Generator,
                    device) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        std = self.scale / math.sqrt(max(fan_in, 1))
        t = torch.randn(self.shape, generator=generator, dtype=self.dtype,
                        device=device)
        return t.mul_(std)


def init_params(specs, generator: torch.Generator, device):
    """Materialize a nested dict/list of ParamSpec, leaves in order."""
    if isinstance(specs, ParamSpec):
        return specs.materialize(generator, device)
    if isinstance(specs, dict):
        return {k: init_params(v, generator, device) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return [init_params(v, generator, device) for v in specs]
    raise TypeError(f"not a ParamSpec tree: {type(specs)}")


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, ties broken by the LOWER index first.
    ``torch.topk`` leaves tie order unspecified, so this is a stable
    descending sort cut at k."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# ---------------------------------------------------------------------------
# norms / activations / rope
# ---------------------------------------------------------------------------


def rms_norm(x, gamma, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def swiglu(x, w_gate, w_up, w_down):
    return (torch.nn.functional.silu(x @ w_gate) * (x @ w_up)) @ w_down


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, hd] or [..., S, hd]; positions: [..., S]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                    # [hd/2]
    ang = positions[..., None].float() * freqs                 # [..., S, hd/2]
    if x.dim() == ang.dim() + 1:                               # head axis
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def attn_param_specs(cfg, prefix_scale=1.0) -> Dict[str, ParamSpec]:
    d, nh, nkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": ParamSpec((d, nh * hd), ("D", "H")),
        "wk": ParamSpec((d, nkv * hd), ("D", "KV")),
        "wv": ParamSpec((d, nkv * hd), ("D", "KV")),
        "wo": ParamSpec((nh * hd, d), ("H", "D"), scale=prefix_scale),
    }
    if cfg.qkv_bias:
        p["bq"] = ParamSpec((nh * hd,), ("H",), init="zeros")
        p["bk"] = ParamSpec((nkv * hd,), ("KV",), init="zeros")
        p["bv"] = ParamSpec((nkv * hd,), ("KV",), init="zeros")
    return p


def qkv_proj(p, x, cfg, positions):
    """x: [B, S, D] -> q [B, S, nh, hd], k/v [B, S, nkv, hd] with RoPE."""
    B, S, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, nh, hd)
    k = k.reshape(B, S, nkv, hd)
    v = v.reshape(B, S, nkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def repeat_kv(k, n_rep: int):
    """[B, S, nkv, hd] -> [B, S, nkv * n_rep, hd], each KV head repeated
    n_rep times in place (``jnp.repeat`` on the head axis)."""
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def blocked_causal_attention(q, k, v, *, chunk: int = 1024,
                             window: int = 0) -> torch.Tensor:
    """Memory-bounded causal attention: a loop over KV chunks with an
    online softmax.  q,k,v: [B, S, H, hd] (k/v already head-repeated).
    ``window`` > 0 enables sliding-window masking.  S is cut into
    ``S // (S // chunk)``-long chunks, as the reference cuts it (a
    length that does not divide evenly fails there too)."""
    B, S, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    n_chunks = max(S // chunk, 1)
    chunk = S // n_chunks
    qf = (q.float() * scale).transpose(1, 2)                   # [B,H,S,hd]
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    kc = kf.reshape(B, H, n_chunks, chunk, hd)
    vc = vf.reshape(B, H, n_chunks, chunk, hd)
    q_pos = torch.arange(S, device=q.device)
    m = torch.full((B, H, S), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, S, hd), dtype=torch.float32, device=q.device)
    for j in range(n_chunks):
        k_pos = j * chunk + torch.arange(chunk, device=q.device)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kc[:, :, j])
        mask = q_pos[:, None] >= k_pos[None, :]
        if window:
            mask &= (q_pos[:, None] - k_pos[None, :]) < window
        s = s.masked_fill(~mask[None, None], -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                   vc[:, :, j])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)                     # [B,S,H,hd]


def dense_attention_block(p, x, cfg, positions, *, window: int = 0):
    """Full prefill attention for one GQA layer. x: [B, S, D] ->
    (out [B, S, D], (k, v) [B, S, nkv, hd], k roped)."""
    B, S, _ = x.shape
    q, k, v = qkv_proj(p, x, cfg, positions)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    out = blocked_causal_attention(q, repeat_kv(k, n_rep),
                                   repeat_kv(v, n_rep), window=window)
    return out.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"], (k, v)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_param_specs(cfg) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamSpec((d, f), ("D", "F")),
        "w_up": ParamSpec((d, f), ("D", "F")),
        "w_down": ParamSpec((f, d), ("F", "D")),
    }


def mlp_block(p, x):
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])
