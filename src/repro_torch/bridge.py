"""Weight and serve-state bridge between the reference's JAX pytrees and
the port's.

``params_from_jax(tree, cfg, device)`` takes the reference's parameter
pytree as numpy arrays (``jax.tree.map(np.asarray, params)``, made by the
caller) and returns the port's parameters: the same ``ParamSpec`` shapes
and dtypes, with each segment's stacked ``[n, ...]`` leaves split into a
list of n dicts, and an inner stack (Zamba2's ``{"mamba_layers": [n, a,
...]}``, xLSTM's ``{"mlstm": [n, 3, ...], "slstm": [n, ...]}``) into an
inner list.  An ``lg_super`` segment (Gemma3) is nested one level deeper
in the reference, ``{"local": [n, r, ...], "global": [n, ...]}``; it
becomes the port's flat list in pool-layer order, super-block i's local
layers 0..r-1 then its global layer.  Zamba2's top-level ``"shared"``
attention layer crosses as one dict.  An encoder-decoder (Whisper)
has ``embed``, the ``enc`` and ``dec`` stacks (lists in the port),
``final_norm`` and ``lm_head``.  bf16 crosses as its raw 16 bits
(``arr.view(np.uint16)`` then ``.view(torch.bfloat16)``), so nothing
here imports JAX or ``ml_dtypes``.  ``params_to_numpy`` is the inverse
(bf16 leaves come back as uint16 bit patterns), for round-trip checks;
``state_from_jax`` and ``state_to_numpy`` do the same for serve states
(any keys: the decoder-only models' pools, hot tier and ``rec_*``, an
encoder-decoder's ``self_kv`` and ``dec_len``).  ``shards_from_jax``
gives one rank of a tensor-parallel mesh its blocks of the reference's
parameters: the values ``jax.device_put(p, params_shardings(specs,
mesh, rules))`` places on the device at the rank's coordinate;
``opt_state_from_jax`` gives it its blocks of the reference's AdamW
state (``m`` and ``v`` in the parameters' layout, f32, as the
reference's dry-run shards them with the parameters' shardings).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import hisparse
from repro_torch.models.encdec import encdec_param_specs
from repro_torch.models.layers import ParamSpec
from repro_torch.models.transformer import build_segments, model_param_specs


def _to_torch(arr, spec: ParamSpec, device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if spec.dtype == torch.bfloat16:
        if arr.dtype.itemsize != 2:
            raise TypeError(f"expected bf16 (or its uint16 bits), got "
                            f"{arr.dtype}")
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy()).to(spec.dtype)
    if tuple(t.shape) != tuple(spec.shape):
        raise ValueError(f"shape {tuple(t.shape)} != spec {spec.shape}")
    return t.to(device)


def tree_from_numpy(tree, spec, device):
    """A reference subtree (numpy leaves) -> the port's, for any subtree
    of ``ParamSpec`` leaves: a list spec takes element j of the subtree's
    stacked leaves for its entry j."""
    if isinstance(spec, ParamSpec):
        return _to_torch(tree, spec, device)
    if isinstance(spec, list):
        return [tree_from_numpy(_map(lambda a, _j=j: np.asarray(a)[_j],
                                     tree), s, device)
                for j, s in enumerate(spec)]
    return {k: tree_from_numpy(tree[k], s, device) for k, s in spec.items()}


def _retype(spec, dtype):
    """A ParamSpec tree with every leaf's dtype ``dtype`` (None: as is)."""
    if dtype is None:
        return spec
    if isinstance(spec, ParamSpec):
        return dataclasses.replace(spec, dtype=dtype)
    if isinstance(spec, dict):
        return {k: _retype(v, dtype) for k, v in spec.items()}
    return [_retype(v, dtype) for v in spec]


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device="cuda", dtype=None) -> Dict[str, Any]:
    """Reference pytree (numpy leaves) -> the port's parameter dict (with
    ``dtype``, every leaf in it: an AdamW moment's f32)."""
    if cfg.enc_dec:
        return {k: tree_from_numpy(tree[k], s, device)
                for k, s in _retype(encdec_param_specs(cfg), dtype).items()}
    specs = _retype(model_param_specs(cfg), dtype)
    out: Dict[str, Any] = {
        k: tree_from_numpy(tree[k], specs[k], device)
        for k in ("embed", "final_norm", "lm_head", "shared") if k in specs}
    segments: List[List[Dict[str, Any]]] = []
    for seg, seg_tree, seg_specs in zip(build_segments(cfg),
                                        tree["segments"], specs["segments"]):
        if seg.kind == "lg_super":
            seg_tree = _lg_flat(seg, seg_tree)
        segments.append(tree_from_numpy(seg_tree, seg_specs, device))
    out["segments"] = segments
    return out


def shards_from_jax(tree: Dict[str, Any], cfg: ModelConfig, mesh, rules,
                    device="cuda", dtype=None) -> Dict[str, Any]:
    """Reference pytree (numpy leaves) -> this rank's blocks of the port's
    parameters on ``mesh`` under ``rules`` (``sharding.shard_params``,
    cut on the host, then moved to ``device``)."""
    from repro_torch.distributed.sharding import shard_params
    whole = params_from_jax(tree, cfg, "cpu", dtype)
    specs = (encdec_param_specs(cfg) if cfg.enc_dec
             else model_param_specs(cfg))
    return _map_tensors(lambda t: t.to(device),
                        shard_params(whole, specs, mesh, rules))


def opt_state_from_jax(tree: Dict[str, Any], cfg: ModelConfig, mesh, rules,
                       device="cuda") -> Dict[str, Any]:
    """The reference's AdamW state (``{"m", "v", "step"}``, numpy
    leaves) -> this rank's: its blocks of ``m`` and ``v`` (f32, cut as
    ``shards_from_jax`` cuts the parameters) and the step."""
    out = {k: shards_from_jax(tree[k], cfg, mesh, rules, device,
                              torch.float32) for k in ("m", "v")}
    out["step"] = torch.as_tensor(np.asarray(tree["step"]),
                                  dtype=torch.int32, device=device)
    return out


def _map_tensors(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tensors(fn, v) for v in tree]
    return fn(tree)


def _lg_flat(seg, seg_tree):
    """An ``lg_super`` segment's ``{"local": [n, r, ...], "global": [n,
    ...]}`` as one [n * (r + 1), ...] stack in the port's pool-layer
    order: super-block i's local layers 0..r-1, then its global layer."""
    def flat(local, glob):
        local, glob = np.asarray(local), np.asarray(glob)
        return np.concatenate([local, glob[:, None]], 1).reshape(
            -1, *glob.shape[1:])
    return _map2(flat, seg_tree["local"], seg_tree["global"])


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """bf16 as its uint16 bits and e4m3 as its uint8 bits (numpy has
    neither dtype)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    return t.numpy()


def _numpy_tree(item):
    """Port parameters -> numpy: a list becomes one stack on a new
    leading axis, as the reference stacks layers for its scan."""
    if isinstance(item, torch.Tensor):
        return item if item.is_meta else _to_numpy(item)
    if isinstance(item, dict):
        return {k: _numpy_tree(v) for k, v in item.items()}
    return _stack([_numpy_tree(v) for v in item])


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], torch.Tensor):          # meta: shapes only
        return torch.stack(trees)
    return np.stack(trees)


def params_to_numpy(params: Dict[str, Any],
                    cfg: ModelConfig) -> Dict[str, Any]:
    """The port's parameters -> the reference's layout as numpy arrays
    (each segment's list stacked on a leading [n] axis and its inner
    lists on a second one; an ``lg_super`` segment split into its
    ``local`` [n, r] and ``global`` [n] stacks; an encoder-decoder's
    ``enc`` and ``dec`` lists stacked; bf16 as uint16 bits).  ``meta``
    leaves (``param_shapes``, the dry-run's per-rank trees) stay
    ``meta`` tensors, stacked alike: the reference's layout of shapes."""
    if cfg.enc_dec:
        return {k: _numpy_tree(v) for k, v in params.items()}
    out = {k: _numpy_tree(params[k])
           for k in ("embed", "final_norm", "lm_head", "shared")
           if k in params}
    out["segments"] = []
    for seg, layers in zip(build_segments(cfg), params["segments"]):
        stacked = _numpy_tree(layers)
        if seg.kind == "lg_super":
            a = seg.kv_per_iter
            sup = _map(lambda x: x.reshape(seg.n, a, *x.shape[1:]), stacked)
            stacked = {"local": _map(lambda x: x[:, :-1], sup),
                       "global": _map(lambda x: x[:, -1], sup)}
        out["segments"].append(stacked)
    return out


# ---------------------------------------------------------------------------
# serve states
# ---------------------------------------------------------------------------


def state_from_jax(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """A reference serve state with numpy leaves (``jax.tree.map(
    np.asarray, state)``; bf16 and e4m3 leaves in ``ml_dtypes``' types,
    read by their bits) -> the port's: the same keys and layouts, tuples
    kept (``rec_*``), the hot tier as ``hisparse.BufferState``."""
    def conv(x):
        if isinstance(x, tuple):
            return type(x)(*map(conv, x)) if hasattr(x, "_fields") \
                else tuple(map(conv, x))
        arr = np.ascontiguousarray(np.asarray(x))
        name = arr.dtype.name
        if name == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        elif name == "float8_e4m3fn":
            t = torch.from_numpy(arr.view(np.uint8).copy()).view(
                torch.float8_e4m3fn)
        else:
            t = torch.from_numpy(arr.copy())
        return t.to(device)

    out = {k: conv(v) for k, v in tree.items()}
    if "hot_buf" in out:
        out["hot_buf"] = hisparse.BufferState(*out["hot_buf"])
    return out


def state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """The port's serve state -> numpy leaves (bf16 as uint16 bits, e4m3
    as uint8 bits), tuples kept: the inverse of ``state_from_jax``."""
    def conv(x):
        if isinstance(x, tuple):
            return tuple(map(conv, x))
        return _to_numpy(x)
    return {k: conv(v) for k, v in state.items()}
