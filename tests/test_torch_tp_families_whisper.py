"""Tensor parallelism of Whisper's ``EncDecLM`` (the encoder's and the cross-attention's
``bidir_attention`` on a rank's heads, the decoder's self-attention
over the whole ``self_kv`` and SAC cross-attention over the sharded
pool) against the port's unsharded run and
the reference's GSPMD run, on the CPU (``test_torch_tp_families.py``'s
machinery and checks; its docstring says what each holds).

Configs: reduced Whisper (4 heads of 16: one a rank at
model 4), and a 6-head Whisper (1.5 heads a rank at model 4: q
all-gathered and every head attends, as in the six-head Qwen2 of
``test_torch_tp.py``).
The logits' limit is the decoder-only families' relative L2 (3e-2).
"""
import pytest

from test_torch_tp_families import (MESHES, check_layers, check_logits,
                                    check_residuals, check_shards,
                                    check_train, check_train_f32,
                                    check_train_world_of_one,
                                    check_world_of_one, make_runs,
                                    STEPS)

FAMILY = dict(
    configs={"whisper": ("whisper-small", {}),
             "whisper-h6": ("whisper-small", dict(n_heads=6,
                                                  n_kv_heads=6))},
    prompt=32, limits=(3e-2, 3e-2), tight=3, train="whisper-h6",
    w_out="wo")
NAMES = list(FAMILY["configs"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return make_runs(FAMILY, "test_torch_tp_families_whisper", tmp_path_factory)


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("name", NAMES)
def test_shards_and_rec_equal_reference_blocks(runs, name, shape):
    check_shards(FAMILY, runs, name, shape)


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("name", NAMES)
def test_residual_per_layer_near_unsharded_and_reference(runs, name, shape):
    check_residuals(FAMILY, runs, name, shape)


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("name", NAMES)
def test_logits_within_whole_model_limits(runs, name, shape):
    check_logits(FAMILY, runs, name, shape)


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("name", NAMES)
def test_layer_f32_forward_backward(runs, name, shape):
    check_layers(runs, name, shape)


@pytest.mark.parametrize("name", NAMES)
def test_sparse_equals_dense_in_tp_world(runs, name):
    import torch
    for r, res in enumerate(runs["ranks"][(2, 2)]):
        sac, dense = res[name]["sparse_dense"]
        assert len(sac) == STEPS
        for a, b in zip(sac, dense):
            assert torch.equal(a, b), (name, r)


@pytest.mark.parametrize("name", NAMES)
def test_world_of_one_equals_unsharded(runs, name):
    check_world_of_one(runs, name)


def test_train_step_world_of_one_bit_equal(runs):
    check_train_world_of_one(runs)


def test_train_step_near_unsharded_with_control(runs):
    check_train(runs)


def test_train_step_f32_equals_unsharded(runs):
    check_train_f32(runs)


_REHEARSAL = """
import sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
if __name__ == "__main__":
    import torch
    import torch.distributed as dist
    import chip_smoke
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    chip_smoke._tp_world_of_one(torch, dist, chip_smoke._free_port())
    try:
        chip_smoke.families_world_of_one(
            torch, ops, make_mesh((1, 1), ("data", "model"), device="cpu"))
    finally:
        dist.destroy_process_group()
    chip_smoke.fsdp_phase(torch, ops, "cpu rehearsal", fsdp=False,
                          families=True)
"""


def test_chip_smoke_phase_21_rehearses_on_cpu():
    """``chip_smoke.py`` phase 21 on the CPU at the reduced configs
    (``CHIP_SMOKE_TP_DEVICE=cpu``): (a)'s xLSTM serve run and both
    training steps bit-equal at a world of one; (b)'s four ranks at
    (2, 2) and (1, 4) within the phase's fixed limits, every control
    outside them (the phase raises otherwise), and the references'
    spread readings with the like-for-like control of the bf16 gaps
    (``CHIP_SMOKE_FAM_SPREAD=1``)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, CHIP_SMOKE_TP_DEVICE="cpu", OMP_NUM_THREADS="1",
               CHIP_SMOKE_FAM_SPREAD="1")
    out = subprocess.run([sys.executable, "-c", _REHEARSAL, str(root),
                          str(root / "src")], capture_output=True, text=True,
                         env=env, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-4000:]
    recs = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    runs = [(r["run"], r["config"].split()[0]) for r in recs
            if r.get("phase") == "families_tp"]
    assert ("nccl_world_1_xlstm", "xlstm-125m") in runs
    for arch in ("zamba2-7b", "xlstm-125m", "whisper-small"):
        assert runs.count(("gloo_4_ranks_serve", arch)) == 2, arch
        assert ("gloo_4_ranks_train", arch) in runs, arch
    assert recs[-1]["phase"] == "fsdp_total" and recs[-1]["families"]
    # the references' spread readings (CHIP_SMOKE_FAM_SPREAD): each serve
    # case's lane halves alone and rounded as a rank (``_rank_rounding``),
    # each training step in two microbatches, and each bf16 step's
    # like-for-like control, with Zamba2-7B's bf16 step on the ranks
    # beside it (reported, not held)
    assert runs.count(("unsharded_spread", "zamba2-7b")) == 3
    for arch in ("xlstm-125m", "whisper-small"):
        assert runs.count(("unsharded_spread", arch)) == 4, arch
    assert runs.count(("unsharded_spread", "zamba2-7b-bf16")) == 2
    bf16 = [r for r in recs if r.get("run") == "gloo_4_ranks_train"
            and r["config"] == "zamba2-7b-bf16"]
    assert len(bf16) == 1 and not bf16[0]["held"]
