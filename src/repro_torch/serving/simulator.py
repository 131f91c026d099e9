"""Cost profiles of the serving simulator (``repro/serving/simulator.py``).

Only ``ModelProfile`` and ``profile_from_config`` are here, copied from
the reference: the port's ``Engine`` advances its virtual clock with
them.  The rest of the simulator (the event loop, the backend profiles
and the engine-timeline replay) waits for a later slice of the port.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """Decode/prefill cost constants for one served model."""
    name: str
    n_attn_layers: int
    topk: int
    entry_bytes: int
    weights_bytes_per_gpu: float      # resident weights read per step
    hbm_bw_Bps: float = 4.0e12        # H20
    flops_per_gpu: float = 148e12     # H20 bf16 dense
    flops_eff: float = 0.45
    active_params: float = 37e9       # per-token FLOPs = 2 * this
    n_lanes: int = 8                  # DP-attention width

    @property
    def base_step_s(self) -> float:
        return self.weights_bytes_per_gpu / self.hbm_bw_Bps

    def per_token_compute_s(self) -> float:
        """Marginal decode compute per token across the whole server
        (MoE/FFN is TP over all GPUs; attention DP over lanes)."""
        flops = 2 * self.active_params \
            + 2 * self.n_attn_layers * self.topk * self.entry_bytes  # attn
        return flops / (self.n_lanes * self.flops_per_gpu * self.flops_eff)

    def prefill_s(self, ctx: int) -> float:
        """Compute-bound prefill of a ctx-token prompt on one lane group."""
        flops = 2 * self.active_params * ctx \
            + self.n_attn_layers * self.topk * ctx * 600  # indexer+sparse attn
        return flops / (self.n_lanes * self.flops_per_gpu * self.flops_eff)

    def kv_bytes_per_token(self) -> float:
        return self.n_attn_layers * self.entry_bytes


def profile_from_config(cfg: ModelConfig, **kw) -> ModelProfile:
    entry = cfg.kv_bytes_per_token_layer
    quant = 0.5 if cfg.name.startswith("deepseek") else 2.0  # AWQ-4bit paper
    weights = cfg.param_count() * quant / kw.pop("n_gpus", 8)
    return ModelProfile(
        name=cfg.name, n_attn_layers=max(cfg.n_attn_layers, 1),
        topk=cfg.sac.topk, entry_bytes=entry,
        weights_bytes_per_gpu=weights,
        active_params=cfg.active_param_count(), **kw)
