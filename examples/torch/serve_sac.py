"""End-to-end serving on the PyTorch/CUDA port (``examples/serve_sac.py``):
continuous batching over the SAC cache with real pool reads/writes, radix
prefix reuse, and fabric accounting; then the same workload on the
cluster simulator at paper scale.

    PYTHONPATH=src python examples/torch/serve_sac.py              # card
    PYTHONPATH=src python examples/torch/serve_sac.py --device cpu

On the CPU the engine serves ``get_config("qwen2-1.5b").reduced()``
exactly, as the reference does; on the card the indexer is widened to 32
dims (its kernel takes d_idx a multiple of 16, the reduced config has 8).
The simulator's numbers are its modeled clock (8 x H20), not a
measurement.
"""
import argparse
import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import sharegpt_trace
from repro_torch.serving.simulator import (SimConfig, default_backends,
                                           profile_from_config, simulate)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # ---- real engine (reduced model) ----
    cfg = get_config("qwen2-1.5b").reduced()
    if torch.device(args.device).type == "cuda":
        cfg = dataclasses.replace(cfg, sac=dataclasses.replace(cfg.sac,
                                                               d_idx=32))
    eng = Engine(cfg, slots=4, max_ctx=96, backend="cxl", device=args.device)
    reqs = sharegpt_trace(8, context_len=40, output_len=8, seed=0,
                          ctx_jitter=0.2, vocab=cfg.vocab)
    out = eng.run(reqs)
    print(f"== real engine (reduced qwen2, CXL backend, {args.device}) ==")
    for k in ("n_done", "throughput_tok_s", "engine_steps",
              "radix_hit_tokens", "fabric_time_s"):
        print(f"  {k}: {out[k]}")

    # ---- cluster simulator at paper scale (DeepSeek-V3.2, 8xH20) ----
    print("\n== simulator: Round-2, ctx=64K, concurrency 64 ==")
    model = profile_from_config(get_config("deepseek-v32"))
    backends = default_backends()
    trace = sharegpt_trace(256, context_len=65536, output_len=1024, seed=1)
    for name in ("cxl", "rdma", "dram", "hbm"):
        r = simulate(trace, model, backends[name], SimConfig(concurrency=64))
        print(f"  {name:>5}: {r['throughput_tok_s']:7.0f} tok/s   "
              f"ttft {r['ttft_mean_s']:6.2f}s   tbt {r['tbt_mean_s']*1e3:5.1f}ms")
    return out


if __name__ == "__main__":
    main()
