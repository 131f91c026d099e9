"""ShareGPT-like synthetic request traces (paper §5: 512 requests sampled
from ShareGPT, context 16K-128K, output fixed per experiment)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    request_id: int
    arrival_s: float
    context_len: int
    output_len: int
    prompt_tokens: Optional[np.ndarray] = None   # only for the real engine
    # -- shared-prefix workload annotation (radix prefix cache) --
    # requests in the same group share their first prefix_len prompt
    # tokens; the simulator's analytic radix twin keys its cache on the
    # group id, the engine sees the real shared tokens
    prefix_group: Optional[int] = None
    prefix_len: int = 0
    # -- filled by the runtime --
    dispatch_s: float = -1.0
    first_token_s: float = -1.0
    finish_s: float = -1.0
    pool_device: int = -1
    generated: int = 0
    # worst single inter-token gap (s) — the metric chunked prefill
    # exists to bound: a monolithic prefill splicing into the batch
    # stalls every decoding request for a whole prompt's compute, which
    # per-request MEAN TBT averages away
    tbt_max_s: float = 0.0
    # the engine flushes the slot's decoded token stream here at finish
    # (seed token + decoded ids) — the bit-identity property tests
    # compare these across chunk schedules and disaggregation modes
    out_tokens: Optional[List[int]] = None

    @property
    def ttft_s(self) -> float:
        """Dispatch-to-first-token (the paper's fixed-concurrency TTFT:
        closed-loop slot wait is not the backend's latency)."""
        start = self.dispatch_s if self.dispatch_s >= 0 else self.arrival_s
        return self.first_token_s - start

    @property
    def ttft_arrival_s(self) -> float:
        return self.first_token_s - self.arrival_s

    @property
    def tbt_s(self) -> float:
        if self.generated <= 1:
            return 0.0
        return (self.finish_s - self.first_token_s) / (self.generated - 1)


def sharegpt_trace(n_requests: int, *, context_len: int, output_len: int,
                   seed: int = 0, arrival_rate: float = float("inf"),
                   ctx_jitter: float = 0.1,
                   vocab: int = 0) -> List[Request]:
    """Deterministic trace: contexts jittered +-ctx_jitter around the sweep
    point (ShareGPT lengths vary), arrivals poisson (inf rate = all at 0)."""
    rng = np.random.default_rng(seed)
    reqs = []
    t = 0.0
    for i in range(n_requests):
        if np.isfinite(arrival_rate):
            t += rng.exponential(1.0 / arrival_rate)
        ctx = int(context_len * (1 + ctx_jitter * (rng.random() * 2 - 1)))
        ctx = max(ctx, 16)      # clamp BEFORE generating the prompt so
        out = max(1, int(output_len))   # len(prompt) == context_len always
        prompt = (rng.integers(0, vocab, size=ctx).astype(np.int32)
                  if vocab else None)
        reqs.append(Request(i, t, ctx, out, prompt))
    return reqs


def shared_prefix_trace(n_requests: int, *, prefix_len: int,
                        suffix_len: int, output_len: int,
                        reuse_p: float = 0.7, seed: int = 0,
                        arrival_rate: float = float("inf"),
                        vocab: int = 0) -> List[Request]:
    """Shared-prefix workload (the radix prefix cache's regime: system
    prompts, few-shot templates, multi-turn history).

    Each request reuses an existing prefix group with probability
    ``reuse_p`` (uniform over live groups) or founds a new one; its
    prompt is the group's ``prefix_len`` shared tokens plus a private
    ``suffix_len``-token tail.  With ``vocab`` set, real token arrays
    are generated so the ENGINE's radix tree sees literal sharing; the
    simulator's analytic twin keys on ``prefix_group`` alone."""
    rng = np.random.default_rng(seed)
    prefixes: List[Optional[np.ndarray]] = []
    reqs = []
    t = 0.0
    for i in range(n_requests):
        if np.isfinite(arrival_rate):
            t += rng.exponential(1.0 / arrival_rate)
        if prefixes and rng.random() < reuse_p:
            g = int(rng.integers(len(prefixes)))
        else:
            g = len(prefixes)
            prefixes.append(
                rng.integers(0, vocab, size=prefix_len).astype(np.int32)
                if vocab else None)
        prompt = None
        if vocab:
            tail = rng.integers(0, vocab, size=suffix_len).astype(np.int32)
            prompt = np.concatenate([prefixes[g], tail])
        reqs.append(Request(i, t, prefix_len + suffix_len,
                            max(1, int(output_len)), prompt,
                            prefix_group=g, prefix_len=prefix_len))
    return reqs


SUMMARY_KEYS = (
    "n_done", "throughput_tok_s", "throughput_req_s",
    "ttft_mean_s", "ttft_p50_s", "ttft_p99_s",
    "ttft_arrival_mean_s", "ttft_arrival_p50_s", "ttft_arrival_p99_s",
    "tbt_mean_s", "tbt_p50_s", "tbt_p99_s",
    "tbt_max_p50_s", "tbt_max_p99_s",
    "slo_ttft_attainment", "slo_tbt_attainment",
)


def diurnal_trace(n_requests: int, *, prefix_len: int, suffix_len: int,
                  output_len: int, base_rate: float, seed: int = 0,
                  reuse_p: float = 0.7, n_tenants: int = 1,
                  period_s: float = 120.0, diurnal_amp: float = 0.5,
                  burst_p: float = 0.0, burst_size: int = 8,
                  ctx_tail_alpha: float = 0.0, max_ctx_mult: float = 8.0,
                  vocab: int = 0) -> List[Request]:
    """Open-loop production workload generator (PR 8): the shared-prefix
    trace extended with the arrival/length structure a serving system is
    actually judged on.

      - **diurnal arrivals**: instantaneous rate = ``base_rate * (1 +
        diurnal_amp * sin(2*pi*t/period_s))`` — sampled by thinning, so
        peaks genuinely pack requests closer than troughs.
      - **bursts**: with probability ``burst_p`` per arrival, a clump of
        ``burst_size`` requests lands at (nearly) the same instant — the
        regime where chunked prefill vs monolithic prefill separates.
      - **heavy-tailed contexts**: ``ctx_tail_alpha > 0`` multiplies the
        suffix by a Pareto(alpha) draw capped at ``max_ctx_mult`` — a few
        long-context stragglers amid many short requests.
      - **multi-tenant prefix groups**: each request belongs to one of
        ``n_tenants`` tenants; prefix reuse only happens *within* a
        tenant (tenants never share radix prefixes).

    Deterministic per seed.  With ``vocab`` set, real token arrays are
    generated (engine mode); otherwise the analytic twin keys on
    ``prefix_group``."""
    rng = np.random.default_rng(seed)
    peak = base_rate * (1.0 + abs(diurnal_amp))
    tenant_prefixes: List[List[Optional[np.ndarray]]] = [
        [] for _ in range(max(1, n_tenants))]
    group_of: dict = {}     # (tenant, local_g) -> global group id
    reqs: List[Request] = []
    t = 0.0
    pending_burst = 0
    while len(reqs) < n_requests:
        if pending_burst > 0:
            pending_burst -= 1
            t += 1e-4       # burst members land ~together
        else:
            # thinning: candidate arrivals at the peak rate, accepted
            # with probability rate(t)/peak -> inhomogeneous poisson
            while True:
                t += rng.exponential(1.0 / peak)
                rate = base_rate * (1.0 + diurnal_amp
                                    * np.sin(2 * np.pi * t / period_s))
                if rng.random() * peak < max(rate, 0.0):
                    break
            if burst_p > 0.0 and rng.random() < burst_p:
                pending_burst = max(0, int(burst_size) - 1)
        tenant = int(rng.integers(len(tenant_prefixes)))
        prefixes = tenant_prefixes[tenant]
        if prefixes and rng.random() < reuse_p:
            local_g = int(rng.integers(len(prefixes)))
        else:
            local_g = len(prefixes)
            prefixes.append(
                rng.integers(0, vocab, size=prefix_len).astype(np.int32)
                if vocab else None)
            group_of[(tenant, local_g)] = len(group_of)
        g = group_of[(tenant, local_g)]
        sfx = suffix_len
        if ctx_tail_alpha > 0.0:
            mult = min(1.0 + rng.pareto(ctx_tail_alpha), max_ctx_mult)
            sfx = max(1, int(suffix_len * mult))
        prompt = None
        if vocab:
            tail = rng.integers(0, vocab, size=sfx).astype(np.int32)
            prompt = np.concatenate([prefixes[local_g], tail])
        reqs.append(Request(len(reqs), t, prefix_len + sfx,
                            max(1, int(output_len)), prompt,
                            prefix_group=g, prefix_len=prefix_len))
    return reqs


def summarize(reqs: List[Request], *, slo_ttft_s: float = 0.0,
              slo_tbt_s: float = 0.0) -> dict:
    """Full summary over finished requests.  ALWAYS returns the complete
    ``SUMMARY_KEYS`` set (zeros when nothing finished) so sweep/gate
    consumers can index percentiles on empty cells without KeyError.

    TTFT is reported both dispatch-anchored (``ttft_*`` — the paper's
    fixed-concurrency metric) and arrival-anchored (``ttft_arrival_*``
    — the honest open-loop metric that includes queueing delay).  With
    ``slo_ttft_s``/``slo_tbt_s`` > 0 the SLO-attainment fractions are
    the share of finished requests meeting the target (arrival-anchored
    TTFT; per-request mean TBT)."""
    done = [r for r in reqs if r.finish_s >= 0]
    if not done:
        return {k: 0.0 for k in SUMMARY_KEYS}
    total_tokens = sum(r.generated for r in done)
    span = max(r.finish_s for r in done) - min(r.arrival_s for r in done)
    ttfts = np.array([r.ttft_s for r in done])
    ttfts_arr = np.array([r.ttft_arrival_s for r in done])
    tbts = np.array([r.tbt_s for r in done if r.generated > 1])
    tbts_max = np.array([r.tbt_max_s for r in done if r.generated > 1])
    slo_ttft = (float(np.mean(ttfts_arr <= slo_ttft_s))
                if slo_ttft_s > 0 else 0.0)
    slo_tbt = (float(np.mean(tbts <= slo_tbt_s))
               if slo_tbt_s > 0 and len(tbts) else 0.0)
    return {
        "n_done": len(done),
        "throughput_tok_s": total_tokens / max(span, 1e-9),
        "throughput_req_s": len(done) / max(span, 1e-9),
        "ttft_mean_s": float(ttfts.mean()),
        "ttft_p50_s": float(np.percentile(ttfts, 50)),
        "ttft_p99_s": float(np.percentile(ttfts, 99)),
        "ttft_arrival_mean_s": float(ttfts_arr.mean()),
        "ttft_arrival_p50_s": float(np.percentile(ttfts_arr, 50)),
        "ttft_arrival_p99_s": float(np.percentile(ttfts_arr, 99)),
        "tbt_mean_s": float(tbts.mean()) if len(tbts) else 0.0,
        "tbt_p50_s": float(np.percentile(tbts, 50)) if len(tbts) else 0.0,
        "tbt_p99_s": float(np.percentile(tbts, 99)) if len(tbts) else 0.0,
        "tbt_max_p50_s": (float(np.percentile(tbts_max, 50))
                          if len(tbts_max) else 0.0),
        "tbt_max_p99_s": (float(np.percentile(tbts_max, 99))
                          if len(tbts_max) else 0.0),
        "slo_ttft_attainment": slo_ttft,
        "slo_tbt_attainment": slo_tbt,
    }
