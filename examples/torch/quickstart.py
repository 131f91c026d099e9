"""Quickstart on the PyTorch/CUDA port (``examples/quickstart.py``):
build a SAC-served model, prefill, decode with top-k fetching, and
inspect what moved over the fabric.

    PYTHONPATH=src python examples/torch/quickstart.py              # card
    PYTHONPATH=src python examples/torch/quickstart.py --device cpu

On the CPU it takes ``get_config("deepseek-v32").reduced()`` exactly, as
the reference does, and the kernels' plain versions.  On the card the
indexer kernel needs d_idx a multiple of 16, where the reduced config
has 8, so the example widens the indexer to 32 dims (as ``chip_smoke.py``'s
``small_config``); every other width is the reduced config's.
"""
import argparse
import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.core.transfer import CXL, RDMA
from repro_torch.models.model import build_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # 1. pick an architecture (any of the 10 assigned + deepseek-v32)
    cfg = get_config("deepseek-v32").reduced()   # tiny variant
    if torch.device(args.device).type == "cuda":  # the indexer kernel's
        cfg = dataclasses.replace(cfg, sac=dataclasses.replace(cfg.sac,
                                                               d_idx=32))
    print(f"arch={cfg.name} (MLA latent KV, lightning indexer, "
          f"top-k={cfg.sac.topk})")

    # 2. build the SAC-mode model: decode fetches only top-k entries
    model = build_model(cfg, mode="sac", device=args.device)
    params = model.init(torch.Generator(device=args.device).manual_seed(0))

    # 3. prefill a prompt -> KV entries + indexer keys land in the pool
    B, S = 2, 48
    g = torch.Generator(device=args.device).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (B, S), generator=g,
                           device=args.device, dtype=torch.int32)
    state, last_logits = model.prefill(params, prompt)
    print(f"prefill: pool kv {tuple(state['kv_pool'].shape)} "
          f"idx {tuple(state['idx_pool'].shape)}")

    # 4. decode: per layer, scores -> top-k -> fetch -> sparse attention
    toks = last_logits.argmax(-1).to(torch.int32)
    for step in range(5):
        state, logits = model.decode(params, state, toks)
        toks = logits.argmax(-1).to(torch.int32)
        print(f"  step {step}: tokens {toks.tolist()} "
              f"cache_len {state['cache_len'].tolist()}")

    # 5. the paper's point, in numbers: per-step fabric traffic
    k = min(cfg.sac.topk, S)
    entry = cfg.kv_bytes_per_token_layer
    n_layers = cfg.n_layers
    sparse_bytes = k * entry * n_layers
    full_bytes = S * entry * n_layers
    print(f"\nper-request per-step fetch: top-k {sparse_bytes} B vs "
          f"full-prefetch {full_bytes} B")
    t_cxl = sum(CXL.sparse_fetch_time(k, entry) for _ in range(n_layers))
    t_rdma = sum(RDMA.sparse_fetch_time(k, entry) for _ in range(n_layers))
    print(f"fetch latency: CXL {t_cxl*1e6:.1f}us vs per-layer RDMA "
          f"{t_rdma*1e6:.1f}us  ({t_rdma/t_cxl:.1f}x — why the paper "
          f"excludes RDMA dynamic top-k)")


if __name__ == "__main__":
    main()
