"""Deterministic synthetic LM data pipeline.

Every batch is a pure function of (seed, step) — restart-safe: the
checkpoint stores the data cursor (step), restore resumes the exact
stream.  Sharded generation: each host materializes only its slice
(single-host here, but the index math is per-shard).
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _rng(seed: int, step: int, shard: int = 0) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed, step, shard]))


def synthetic_batch(cfg: ModelConfig, batch: int, seq_len: int, *,
                    seed: int = 0, step: int = 0, shard: int = 0,
                    n_shards: int = 1) -> Dict[str, np.ndarray]:
    """Markov-ish token stream (zipfian unigram + local repeats) so the
    model has actual structure to learn; labels are next-token."""
    rng = _rng(seed, step, shard)
    b = batch // n_shards
    if cfg.enc_dec:
        from repro_torch.models.encdec import MAX_DEC
        frames = rng.standard_normal((b, seq_len, cfg.d_model),
                                     dtype=np.float32) * 0.02
        toks = _token_stream(rng, b, MAX_DEC + 1, cfg.vocab)
        return {"frames": frames, "tokens": toks[:, :-1],
                "labels": toks[:, 1:]}
    toks = _token_stream(rng, b, seq_len + 1, cfg.vocab)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _token_stream(rng, b: int, n: int, vocab: int) -> np.ndarray:
    # zipf over a capped alphabet + 25% copy-previous structure
    alpha = min(vocab, 4096)
    base = rng.zipf(1.3, size=(b, n)) % alpha
    copy = rng.random((b, n)) < 0.25
    toks = base.astype(np.int64)
    toks[:, 1:] = np.where(copy[:, 1:], toks[:, :-1], toks[:, 1:])
    return toks.astype(np.int32)


def batch_iterator(cfg: ModelConfig, shape: ShapeConfig, *, seed: int = 0,
                   start_step: int = 0, batch_override: int = 0,
                   seq_override: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    B = batch_override or shape.global_batch
    S = seq_override or shape.seq_len
    while True:
        yield synthetic_batch(cfg, B, S, seed=seed, step=step)
        step += 1
