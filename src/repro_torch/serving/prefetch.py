"""Fetch pipeline: speculative prefetch + prefill warm-up planning
(``repro/serving/prefetch.py``).

The host half of the pipeline that hides the per-step top-k miss
fetches behind compute:

  - :class:`FetchPlanner` builds the **prefill warm-up plan**: the hot
    tier of a freshly placed request is seeded from (a) the trailing
    pages of the radix-reused prefix and (b) the top-scoring prompt
    entries per layer, emitted by ``prefill`` (scored against the last
    prompt position).  The plan is built on the host and moved to the
    planner's device once; the engine applies it with
    ``hisparse.warm_lane`` (insert-without-read), so results never
    change.
  - **Speculative per-step prefetch** runs on the device inside
    ``sac.sparse_attend`` (``dsa.topk_select_with_tail``): ranks
    [k, k+w) of the step's indexer scores are warm-inserted for step
    t+1.  :func:`analytic_prefetch` is the simulator's counterpart.
  - The issued/exposed split lives in the shared host substrate
    (``transfer.PipelineModel`` + ``traffic.OverlapQueue``).

Everything here changes traffic and timing only: decoded tokens are
bit-identical with the pipeline on or off.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import kv_layer_windows


@dataclasses.dataclass
class WarmupPlan:
    """One request's prefill warm-up: per-layer positions to seed."""

    idx: torch.Tensor       # [L, w_total] int32 pool positions
    valid: torch.Tensor     # [L, w_total] bool


class FetchPlanner:
    """Host-side planner for the fetch pipeline of one serving engine.

    The planner owns no device state: it turns host facts (radix match
    length, prompt length) plus the prefill's warm-candidate tensor into
    the index plan ``hisparse.warm_lane`` applies, on ``device``.
    """

    def __init__(self, cfg: ModelConfig, *, n_layers: int,
                 device="cuda"):
        self.cfg = cfg
        self.sac = cfg.sac
        self.n_layers = max(n_layers, 1)
        self.device = torch.device(device)
        wins = kv_layer_windows(cfg)
        self.layer_windows = (wins + [0] * self.n_layers)[:self.n_layers]

    def warmup_plan(self, warm_idx: Optional[torch.Tensor],
                    matched_tokens: int, prompt_len: int
                    ) -> Optional[WarmupPlan]:
        """Merge score-based and radix-based warm-up candidates.

        warm_idx: [L, w] per-layer top-scoring prompt positions (from
        ``prefill``; lanes of -1 mark masked-out candidates on windowed
        layers; None when score warm-up is off); matched_tokens is the
        radix prefix hit (page-aligned).  Duplicates across the two
        sources are fine: ``warm_insert`` skips resident positions.  The
        one host read is of ``warm_idx``; the plan goes to the device
        in one copy per tensor.
        """
        r = min(max(int(self.sac.warmup_radix), 0), prompt_len)
        parts_idx, parts_valid = [], []
        if warm_idx is not None and warm_idx.shape[-1]:
            scores_idx = warm_idx.cpu().numpy().astype(np.int32)
            parts_idx.append(np.maximum(scores_idx, 0))
            parts_valid.append(scores_idx >= 0)
        if r:
            # trailing positions of the reused prefix (layer-agnostic);
            # lanes below the match length are invalid, and windowed
            # layers only get positions their decode mask
            # (pos > cache_len - window) can still select
            pos = np.arange(matched_tokens - r, matched_tokens)
            valid = pos >= 0
            wins = np.asarray(self.layer_windows)[:, None]    # [L, 1]
            in_window = (wins == 0) | (pos[None, :] > prompt_len - wins)
            pos = np.clip(pos, 0, max(prompt_len - 1, 0))
            parts_idx.append(
                np.broadcast_to(pos[None, :], (self.n_layers, r))
                .astype(np.int32))
            parts_valid.append(valid[None, :] & in_window)
        if not parts_idx:
            return None
        idx = np.concatenate(parts_idx, axis=1)
        valid = np.concatenate(parts_valid, axis=1)
        if not valid.any():
            return None
        return WarmupPlan(idx=torch.from_numpy(idx).to(self.device),
                          valid=torch.from_numpy(valid).to(self.device))


def cap_warmup(plan: Optional[WarmupPlan], width: int
               ) -> Optional[WarmupPlan]:
    """Cap a warm-up plan at ``width`` valid lanes per layer.

    The warm-up arbitration path (``BudgetArbiter.grant_warmup``): lanes
    are kept best-first (score-based seeds precede the radix tail), so a
    budget cut drops the least certain seeds first.  Returns None when
    nothing survives (skipping the warm burst never changes tokens).
    """
    if plan is None or width >= plan.idx.shape[1]:
        return plan
    if width <= 0:
        return None
    keep = torch.cumsum(plan.valid.to(torch.int32), dim=1) <= width
    valid = plan.valid & keep
    if not bool(valid.any()):
        return None
    return WarmupPlan(idx=plan.idx, valid=valid)


# ---------------------------------------------------------------------------
# analytic counterpart (serving/simulator.py)
# ---------------------------------------------------------------------------


def analytic_prefetch(base_hit: float, width: int, topk: int,
                      *, churn_cover: float = 0.25,
                      spill_frac: float = 0.5) -> Tuple[float, float]:
    """Analytic model of speculative prefetch, mirroring the engine.

    The hot tier's misses are the *entrants* of each step's top-k;
    speculation over ranks [k, k+width) catches the fraction of entrants
    that were already near the cut the step before — modeled as
    ``cover = width / (width + churn_cover * topk)`` (deep entrants
    jumping from far below the cut stay misses).  The caught entrants
    (``useful = cover * miss * topk`` per layer per step) were all
    warm-inserted, plus a spill of speculation that never lands
    (``spill_frac * width * miss`` — resident candidates are skipped
    in-graph, so a stable top-k issues almost nothing); issued entries =
    useful + spill, which keeps the schema invariant ``prefetched >=
    useful`` (wasted >= 0) that the engine measures in-graph.

    Returns ``(hit', issued_entries_per_layer_step)`` with
    ``(hit' - base_hit) * topk <= issued``; ``hit' >= base_hit``
    always; calibrated loosely against the engine-measured drift trace
    in tests/test_prefetch.py.
    """
    base_hit = min(max(base_hit, 0.0), 1.0)
    if width <= 0 or topk <= 0:
        return base_hit, 0.0
    miss = 1.0 - base_hit
    cover = width / (width + churn_cover * topk)
    useful = cover * miss * topk
    hit2 = base_hit + useful / topk       # == 1 - miss * (1 - cover)
    issued = useful + spill_frac * width * miss
    return hit2, issued


def analytic_warmup(warmup_entries: int, topk: int, buf: int,
                    *, precision: float = 0.7) -> float:
    """Analytic model of prefill warm-up's cold-start miss reduction.

    A freshly placed request's first decode step starts with an empty hot
    tier — every top-k read is a miss — unless prefill warm-up seeded it
    (FetchPlanner.warmup_plan + ``hisparse.warm_lane``).  The seeds are
    the top-``warmup_entries`` prompt positions by indexer score against
    the *last prompt position* — a proxy for the first decode query —
    plus radix-reused tail pages, so only a ``precision`` fraction of
    the seeded coverage lands in the actual first top-k.  At most
    ``buf`` seeds fit the tier and at most ``topk`` can be demand-hit.

    Returns the modeled first-step hit rate (0 when warm-up is off);
    monotone non-decreasing in ``warmup_entries`` — the simulator-side
    twin of the engine's measured cold-start reduction
    (tests/test_arbiter.py asserts both directions).
    """
    if warmup_entries <= 0 or topk <= 0 or buf <= 0:
        return 0.0
    cover = min(warmup_entries, buf, topk) / topk
    return cover * min(max(precision, 0.0), 1.0)
