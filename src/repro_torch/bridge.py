"""Weight bridge between the reference's JAX parameters and the port's.

``params_from_jax(tree, cfg, device)`` takes the reference's parameter
pytree as numpy arrays (``jax.tree.map(np.asarray, params)``, made by the
caller) and returns the port's parameters: the same ``ParamSpec`` shapes
and dtypes, with each segment's stacked ``[n, ...]`` leaves split into n
per-layer dicts.  bf16 crosses as its raw 16 bits (``arr.view(np.uint16)``
then ``.view(torch.bfloat16)``), so nothing here imports JAX or
``ml_dtypes``.  ``params_to_numpy`` is the inverse (bf16 leaves come back
as uint16 bit patterns), for round-trip checks.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamSpec
from repro_torch.models.transformer import model_param_specs


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


def _convert(tree, spec, device):
    if isinstance(spec, ParamSpec):
        return _to_torch(tree, spec, device)
    return {k: _convert(tree[k], s, device) for k, s in spec.items()}


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device="cuda") -> Dict[str, Any]:
    """Reference pytree (numpy leaves) -> the port's parameter dict."""
    specs = model_param_specs(cfg)
    out: Dict[str, Any] = {
        k: _to_torch(tree[k], specs[k], device)
        for k in ("embed", "final_norm", "lm_head")}
    segments: List[List[Dict[str, Any]]] = []
    for seg_tree, seg_specs in zip(tree["segments"], specs["segments"]):
        layers = []
        for i, layer_spec in enumerate(seg_specs):
            layer_tree = _map(lambda a, _i=i: np.asarray(a)[_i], seg_tree)
            layers.append(_convert(layer_tree, layer_spec, device))
        segments.append(layers)
    out["segments"] = segments
    return out


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's parameters -> the reference's layout as numpy arrays
    (segments re-stacked on a leading [n] axis; bf16 as uint16 bits)."""
    def stack(layers):
        first = layers[0]
        if isinstance(first, dict):
            return {k: stack([l[k] for l in layers]) for k in first}
        return np.stack([_to_numpy(t) for t in layers])

    out = {k: _to_numpy(params[k]) for k in ("embed", "final_norm",
                                              "lm_head")}
    out["segments"] = [stack(layers) for layers in params["segments"]]
    return out
