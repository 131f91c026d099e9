"""Config system for the SAC framework.

Every architecture in the assigned pool is expressed as a ``ModelConfig``.
``ShapeConfig`` describes the assigned input shapes (train_4k / prefill_32k /
decode_32k / long_500k).  ``SACConfig`` carries the paper's technique knobs
(lightning indexer dims, top-k, HiSparse device buffer, pool backend).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# SAC (the paper's technique) configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SACConfig:
    """DeepSeek-Sparse-Attention + SAC disaggregated-cache knobs."""

    enabled: bool = True
    topk: int = 2048                 # DSA default top-k (paper §2.1)
    d_idx: int = 64                  # lightning indexer head dim
    n_idx_heads: int = 4             # lightning indexer heads
    device_buffer_size: int = 6144   # HiSparse hot-buffer entries/request (paper §5.5)
    page_size: int = 16              # tokens per pool page
    pool_backend: str = "pooled_hbm"  # pooled_hbm | host_dram
    interleave: bool = True          # CXL-device interleaving (paper §4.3.3)
    overlap_fetch: bool = False      # beyond-paper: double-buffered fetch
    kv_quant: Optional[str] = None   # beyond-paper: None | "int8" pool quantization

    # --- fetch pipeline (serving/prefetch.py) ---
    prefetch_width: int = 512        # speculative entries/layer/step beyond
                                     # top-k (ranks [k, k+w) of the indexer
                                     # scores warm the hot tier for step t+1)
    warmup_entries: int = 1024       # prefill warm-up: top-scoring prompt
                                     # entries seeded per layer per request
    warmup_radix: int = 512          # prefill warm-up: trailing tokens of the
                                     # radix-reused prefix seeded per layer
    pipeline_depth: int = 2          # double-buffered fetch queues/device
    overlap_frac: float = 0.85       # fraction of step compute a queued
                                     # fetch can hide behind

    # --- fabric budget arbiter (serving/arbiter.py) ---
    arbiter: bool = False            # cross-request prefetch budget
                                     # arbitration (per-device link pressure
                                     # shrinks speculative widths)
    link_budget_frac: float = 1.0    # fraction of the pipeline hide window
                                     # speculation may fill per device
    min_prefetch_width: int = 0      # granted-width floor under saturation
    score_margin: float = 1.0        # score-threshold speculation: tail
                                     # entries within margin*(s_max - s_k)
                                     # of the k-th demand score qualify;
                                     # < 0 = pure rank window [k, k+w)
    layer_sizing: str = "uniform"    # hot-tier slot apportioning across
                                     # layers: "uniform" | "windowed"
                                     # (LayerSizer prior: windowed layers
                                     # capped at their selectable window)

    # --- PR 4: the closed control loop ---
    placement: Optional[str] = None  # pool placement policy override
                                     # (core/placement.py): None = the
                                     # interleave default; "pressure_aware"
                                     # lands new requests on the least-
                                     # pressured fabric link
    precision_weighted: bool = False  # arbiter grants split per-request by
                                      # measured prefetch precision instead
                                      # of uniformly (serving/arbiter.py)
    resize_interval: int = 0         # decode steps between online LayerSizer
                                     # re-apportionings of the hot tier from
                                     # measured per-layer miss rates (0=off)
    resize_epsilon: float = 0.0      # resize hysteresis: skip the online
                                     # re-apportioning when no layer's
                                     # per-interval miss rate moved by more
                                     # than this since the last sizer
                                     # EVALUATION (skipped intervals keep
                                     # the reference, so slow drift
                                     # accumulates until it crosses the
                                     # epsilon; 0 = re-evaluate every
                                     # interval, the PR 4 behavior)

    # --- PR 5: radix prefix cache lifecycle (serving/radix.py) ---
    radix_headroom_frac: float = 0.05
                                     # pool free-page fraction per device
                                     # below which request finish evicts
                                     # LRU cached prefixes (0 = only evict
                                     # when placement actually fails)

    # --- PR 6: hot-prefix replication / page dedup / radix admission ---
    replicate_prefixes: bool = False  # copy hot cached prefixes to the
                                      # least-pressured pool device when
                                      # the owning link's pressure gap
                                      # pays back the one-time copy cost
    replicate_horizon_steps: int = 64  # decode steps over which a
                                       # replica's per-step pressure
                                       # relief must amortize its copy
                                       # cost before replication fires
    dedup_pages: bool = False         # refcount-share matched prefix
                                      # pages between the radix cache and
                                      # live slots instead of holding
                                      # private pool copies
    radix_admission: bool = False     # admit waiting requests by expected
                                      # prefix reuse (match length) rather
                                      # than FCFS

    # --- PR 7: CXL fabric topology (core/fabric.py) ---
    topology: Optional[str] = None   # fabric spec: None = flat star (one
                                     # dedicated host port per device;
                                     # bit-identical to the pre-PR 7 flat
                                     # per-device accounting), or
                                     # "tree:NxS" / "multi_switch:NxS" /
                                     # "mesh:NxP" — traffic is then
                                     # charged per link SEGMENT and
                                     # placement/grants read bottleneck-
                                     # segment pressure along each path
    warmup_pressure_seed: bool = False  # seed the placement pressure feed
                                     # from BOOKED demand during the
                                     # window before the first decode
                                     # step only (wave-1 admissions herd
                                     # onto the prefix owner while the
                                     # feed is still silent; always-on
                                     # seeding regresses under dedup —
                                     # see benchmarks/locality_sweep.py)
    replica_reads: bool = False      # re-pick the least-pressured replica
                                     # of a request's cached prefix every
                                     # STEP (bottleneck-segment pressure)
                                     # instead of freezing the copy
                                     # choice at placement time

    # --- PR 8: continuous batching + disaggregated prefill ---
    prefill_chunk_tokens: int = 0    # > 0: splice a prompt in over
                                     # ceil(ctx/chunk) bounded chunks
                                     # interleaved with decode steps
                                     # instead of stalling the batch in
                                     # _fill_slots (0 = monolithic).
                                     # Scheduling-only: decoded tokens
                                     # are bit-identical to monolithic
    disagg_prefill: bool = False     # disaggregated mode: prefill runs
                                     # on separate lanes (its own loop on
                                     # the shared wall clock), writes KV
                                     # to the pool device, and decode
                                     # adopts the slot via a handoff
                                     # record once prefill completes
    prefill_lanes: int = 2           # concurrent prefill lanes of the
                                     # disaggregated prefill engine

    # --- PR 10: shared admission policy (serving/policy/admission.py) ---
    admission: Optional[str] = None  # queue-ordering policy: None keeps
                                     # the legacy mapping (radix when
                                     # radix_admission is on, else fcfs);
                                     # "fcfs" | "radix" | "edf"
    slo_ttft_s: float = 0.0          # TTFT SLO target (seconds): EDF
                                     # admission orders by arrival_s +
                                     # slo_ttft_s; also the default
                                     # attainment target reported by
                                     # summarize()
    shed_queue_depth: int = 0        # > 0 (EDF only): drop the arrived
                                     # backlog beyond this many earliest-
                                     # deadline waiting requests — shed
                                     # requests never decode, keeping
                                     # admitted deadlines reachable under
                                     # saturation


# ---------------------------------------------------------------------------
# Model architecture configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm | mla
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None   # default: d_model // n_heads
    qkv_bias: bool = False           # qwen2
    rope_theta: float = 1e6

    # --- MoE ---
    n_experts: int = 0
    topk_experts: int = 0

    # --- sliding window / local:global attention ---
    sliding_window: int = 0          # 0 = full attention (mixtral: 4096)
    local_global_ratio: int = 0      # gemma3: 5 local per 1 global
    local_window: int = 1024         # window for "local" layers

    # --- SSM / recurrent ---
    ssm_state: int = 0               # zamba2 Mamba2 state size
    shared_attn_every: int = 0       # zamba2: shared attention block period
    xlstm: bool = False              # xlstm: sLSTM+mLSTM blocks, no attention

    # --- encoder-decoder (whisper) ---
    enc_dec: bool = False
    n_enc_layers: int = 0

    # --- MLA (deepseek) ---
    mla: bool = False
    kv_lora_rank: int = 512          # latent KV dim
    qk_rope_dim: int = 64
    q_lora_rank: int = 1536

    # --- early fusion VLM (chameleon) ---
    vlm: bool = False

    sac: SACConfig = dataclasses.field(default_factory=SACConfig)

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def has_attention(self) -> bool:
        return not self.xlstm

    @property
    def kv_bytes_per_token_layer(self) -> int:
        """bf16 KV bytes per token per attention layer."""
        if self.mla:
            return 2 * (self.kv_lora_rank + self.qk_rope_dim)
        return 2 * 2 * self.n_kv_heads * self.hd

    @property
    def n_attn_layers(self) -> int:
        if self.xlstm:
            return 0
        if self.shared_attn_every:
            return self.n_layers // self.shared_attn_every
        if self.enc_dec:
            return self.n_layers  # decoder self+cross handled separately
        return self.n_layers

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd, nh, nkv = self.hd, self.n_heads, self.n_kv_heads
        emb = v * d
        if self.xlstm:
            per = 8 * d * d  # qkv/if gates + proj, rough
            return emb + self.n_layers * per
        attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
        if self.mla:
            attn = (d * self.q_lora_rank + self.q_lora_rank * nh * (hd + self.qk_rope_dim)
                    + d * (self.kv_lora_rank + self.qk_rope_dim)
                    + self.kv_lora_rank * nh * (hd + hd) + nh * hd * d)
        if self.n_experts:
            mlp = self.n_experts * 3 * d * f
        else:
            mlp = 3 * d * f
        per_layer = attn + mlp
        if self.ssm_state:  # mamba2 layers are ~6 d^2
            per_layer = 6 * d * d
            n_shared = self.n_layers // max(self.shared_attn_every, 1) if self.shared_attn_every else 0
            return emb + self.n_layers * per_layer + n_shared * (attn + 3 * d * f)
        total_layers = self.n_layers + (self.n_enc_layers if self.enc_dec else 0)
        return emb + total_layers * per_layer

    def active_param_count(self) -> int:
        if not self.n_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense = self.param_count() - self.n_experts * 3 * d * f * self.n_layers
        return dense + self.topk_experts * 3 * d * f * self.n_layers

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests.

        Layer counts respect each family's structural period: xlstm stacks
        groups of 4 (3 mLSTM + 1 sLSTM); gemma-style local:global keeps one
        super-block (reduced to 1 local + 1 global); zamba keeps two
        supers + a tail layer to exercise every segment kind.
        """
        if self.xlstm:
            n_layers = 4
        elif self.local_global_ratio:
            n_layers = 2                      # one (1 local + 1 global) super
        elif self.shared_attn_every:
            n_layers = 5                      # 2 supers of 2 + 1 tail
        else:
            n_layers = min(self.n_layers, 2)
        return dataclasses.replace(
            self,
            n_layers=n_layers,
            n_enc_layers=min(self.n_enc_layers, 2) if self.enc_dec else 0,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            n_experts=min(self.n_experts, 4),
            topk_experts=min(self.topk_experts, 2),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            shared_attn_every=2 if self.shared_attn_every else 0,
            local_global_ratio=1 if self.local_global_ratio else 0,
            kv_lora_rank=32, qk_rope_dim=16, q_lora_rank=48,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            local_window=32,
            sac=dataclasses.replace(self.sac, topk=16, d_idx=8, n_idx_heads=2,
                                    device_buffer_size=32, page_size=4,
                                    prefetch_width=8, warmup_entries=8,
                                    warmup_radix=8),
        )


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode
    grad_accum: int = 1              # microbatches inside train_step


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}
