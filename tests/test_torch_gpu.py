"""Card-only checks of the port's CUDA kernels (marker ``gpu``).

Each kernel against its plain PyTorch version on the card, at the
serving shapes of DeepSeek-V3.2 (B=4, pool S=4160, k=2048 / 2049 lanes
with invalid lanes) and, for the GQA attention, at the (heads, KV heads,
head dim) of the dense/MoE configs (B=8, 2049 lanes): gather, page
gather and scatter bit-exact, indexer and attention at rtol = atol =
1e-4 (f32 sums in another order).  Plus the port's Engine on the card
against its CPU path with the same weights on small inputs (reduced
DeepSeek-V3.2 and reduced Qwen2).

This file imports no JAX, so it runs on the machine with the card:

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Without a card every test skips (decided inside the tests, so every
pytest worker collects the same tests).
"""
import dataclasses
import math

import pytest
import torch

from repro_torch.kernels import ops, ref

F32_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are built with nvcc for "
                    "sm_90a); run on the card with -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_gather_exact(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    kv = torch.randn(4, 4160, 576, generator=g, device=cuda).bfloat16()
    idx = torch.randint(0, 4160, (4, 2048), generator=g, device=cuda,
                        dtype=torch.int32)
    want = torch.stack([ref.gather_kv_ref(kv[b], idx[b]) for b in range(4)])
    n0 = ops.launch_counts()["gather_kv"]
    assert torch.equal(ops.batched_gather(kv, idx), want)
    assert ops.launch_counts()["gather_kv"] == n0 + 1


@pytest.mark.gpu
@pytest.mark.parametrize("n_rows", [8, 8320])
def test_gpu_scatter_exact(cuda, n_rows):
    g = torch.Generator(device=cuda).manual_seed(n_rows)
    pool = torch.randn(1, 2 * 4 * 4160, 576, generator=g,
                       device=cuda).bfloat16()
    rows = torch.randperm(pool.shape[1], generator=g, device=cuda)[:n_rows]
    e = torch.randn(1, n_rows, 576, generator=g, device=cuda).bfloat16()
    want = ref.scatter_kv_ref(pool[0].clone(), e[0], rows)
    got = ops.batched_scatter(pool.clone(), e, rows[None].to(torch.int32))
    assert torch.equal(got[0], want)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [4160, 37])
def test_gpu_indexer_close(cuda, S):
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(4, 64, 128, generator=g, device=cuda)
    w = torch.randn(4, 64, generator=g, device=cuda)
    keys = torch.randn(4, S, 128, generator=g, device=cuda).bfloat16()
    want = torch.stack([ref.indexer_scores_ref(q[b], w[b], keys[b])
                        for b in range(4)])
    torch.testing.assert_close(ops.batched_indexer_scores(q, w, keys), want,
                               **F32_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2049, 4161, 5])
def test_gpu_sparse_mla_close(cuda, k):
    g = torch.Generator(device=cuda).manual_seed(k)
    ql = torch.randn(4, 128, 512, generator=g, device=cuda)
    qp = torch.randn(4, 128, 64, generator=g, device=cuda)
    ent = torch.randn(4, k, 576, generator=g, device=cuda).bfloat16()
    valid = torch.rand(4, k, generator=g, device=cuda) > 0.1
    valid[:, -1] = True
    scale = 1.0 / math.sqrt(192)
    want = torch.stack([ref.sparse_mla_attn_ref(ql[b], qp[b], ent[b],
                                                valid[b], 512, scale)
                        for b in range(4)])
    got = ops.batched_sparse_mla(ql, qp, ent, valid, dc=512, scale=scale)
    torch.testing.assert_close(got, want, **F32_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("H,n_kv,hd", [(12, 2, 128), (36, 36, 64),
                                       (48, 1, 128), (48, 8, 128),
                                       (64, 8, 128)])
@pytest.mark.parametrize("k", [2049, 5])
def test_gpu_sparse_gqa_close(cuda, H, n_kv, hd, k):
    g = torch.Generator(device=cuda).manual_seed(H + k)
    q = torch.randn(8, H, hd, generator=g, device=cuda)
    ent = torch.randn(8, k, 2 * n_kv * hd, generator=g,
                      device=cuda).bfloat16()
    valid = torch.rand(8, k, generator=g, device=cuda) > 0.1
    valid[:, -1] = True
    want = torch.stack([ref.sparse_gqa_attn_ref(q[b], ent[b], valid[b], n_kv)
                        for b in range(8)])
    n0 = ops.launch_counts()["sparse_attn_gqa"]
    got = ops.batched_sparse_gqa(q, ent, valid, n_kv=n_kv)
    assert ops.launch_counts()["sparse_attn_gqa"] == n0 + 1
    torch.testing.assert_close(got, want, **F32_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("d,page", [(512, 16), (576, 4)])
def test_gpu_gather_pages_exact(cuda, d, page):
    from repro_torch.kernels import gather_kv
    g = torch.Generator(device=cuda).manual_seed(d)
    kv = torch.randn(8 * 8256, d, generator=g, device=cuda).bfloat16()
    pidx = torch.randint(0, kv.shape[0] // page, (1024,), generator=g,
                         device=cuda, dtype=torch.int32)
    assert torch.equal(gather_kv.gather_kv_pages(kv, pidx, page=page),
                       ref.gather_kv_pages_ref(kv, pidx, page))


@pytest.mark.gpu
@pytest.mark.parametrize("arch,attn", [("deepseek-v32", "sparse_attn"),
                                       ("qwen2-1.5b", "sparse_attn_gqa")])
def test_gpu_engine_matches_cpu_path(cuda, arch, attn):
    """The port's Engine on the card against the same engine on the CPU
    (a reduced config with a 32-dim indexer, dense MLP), the same
    weights and an injected top-k: the timeline, the traffic and the
    hot-tier outcome are exact, and every kernel of the path ran."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import sharegpt_trace

    base = get_config(arch).reduced()
    cfg = dataclasses.replace(base, n_experts=0, topk_experts=0,
                              sac=dataclasses.replace(base.sac, d_idx=32))

    def topk(scores, cache_len):
        j = torch.arange(16, dtype=torch.int32, device=scores.device)[None]
        t = cache_len[:, None]
        return ((j * 7 + 3 * t) % torch.clamp(t, min=1)).to(torch.int32), \
            (j < t) & (j % 5 != 3)

    engines, reqs = [], []
    for dev in ("cpu", "cuda"):
        eng = Engine(cfg, slots=2, max_ctx=96, topk_fn=topk, seed=3,
                     device=dev)
        if engines:
            eng.params = _to(engines[0].params, dev)
        r = sharegpt_trace(4, context_len=40, output_len=5, seed=1,
                           vocab=cfg.vocab)
        ops.reset_launch_counts()
        eng.run(r)
        engines.append(eng)
        reqs.append(r)
    counts = ops.launch_counts()
    for name in ("gather_kv", "indexer_scores", attn, "scatter_kv"):
        assert counts[name] > 0, counts
    for a, b in zip(*reqs):
        assert (a.dispatch_s, a.first_token_s, a.finish_s) == \
            (b.dispatch_s, b.first_token_s, b.finish_s)
    assert dataclasses.asdict(engines[0].stats.traffic) == \
        dataclasses.asdict(engines[1].stats.traffic)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)
