"""chip_smoke.py phase 20 (the d_model rows split across ranks)
rehearsed on the CPU, and its world-of-one checks on the card.

``CHIP_SMOKE_TP_DEVICE=cpu`` runs the phase's code at the reduced
configs (training 4 x 16 tokens, 2 steps; serving one request over 64
pool rows, 2 steps; the kernels' plain versions), its NCCL worlds of one
as gloo, its child and its four ranks as processes of this machine.  The
phase must pass: at a world of one the training steps and the long_500k
decodes equal the unsharded runs bit for bit; at (2, 2) the loss and
the gradient norm within 1e-3 of the unsharded step's and each gathered
gradient leaf within 5e-2, each serve rank's residual stream after its
first two pool layers within 1e-2 of the unsharded run's and its logits
within the case's fixed limits, its hot tier exact, every control
outside.

The ``gpu`` test runs (a)'s training and Qwen2 serve checks at the
reduced configs on the card (one NCCL rank), where the kernels launch.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_REHEARSAL = """
import sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
if __name__ == "__main__":
    import torch
    import chip_smoke
    from repro_torch.kernels import ops
    chip_smoke.fsdp_phase(torch, ops, "cpu rehearsal")
"""


def _run(device: str):
    env = dict(os.environ, CHIP_SMOKE_TP_DEVICE=device,
               CHIP_SMOKE_FSDP_SMALL="1", OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c", _REHEARSAL, str(ROOT), str(ROOT / "src")],
        capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]


def _check(recs):
    runs = {(r.get("run"), r.get("config")): r for r in recs
            if r.get("phase") == "fsdp"}
    train = runs["nccl_world_1_train", "qwen2-1.5b"]
    assert all(train["equal_unsharded"].values())
    for arch in ("qwen2-1.5b", "deepseek-v32"):
        assert all(runs["nccl_world_1_serve", arch]
                   ["equal_unsharded"].values()), arch
        serve = runs["gloo_4_ranks_serve", arch]
        assert serve["worst_rel_l2"] <= serve["limits"]["rel_l2"]
        tight = serve["hidden_rel_l2_by_layer"][
            :serve["limits"]["hidden_layers"]]
        assert max(tight) <= serve["limits"]["hidden_rel_l2"]
        assert serve["control_least_rel_l2"] > serve["limits"]["rel_l2"]
        assert all(r["weight_bytes"] > 0 for r in serve["ranks"])
    ranks = runs["gloo_4_ranks_train", "qwen2-1.5b"]
    assert not ranks["leaves_over"]
    assert ranks["control_least_over_limit"] > 1
    assert ranks["loss_rel"] <= ranks["limits"]["loss_rel"]
    assert ranks["grad_norm_rel"] <= ranks["limits"]["grad_norm_rel"]
    kinds = ranks["ranks"][0]["collectives_per_step_grads"]
    assert kinds["reduce-scatter"] > 0 and kinds["all-gather"] > 0
    assert recs[-1]["phase"] == "fsdp_total"


def test_chip_smoke_fsdp_phase_rehearses_on_cpu():
    _check(_run("cpu"))


@pytest.mark.gpu
def test_chip_smoke_fsdp_phase_small_on_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _check(_run("cuda"))
