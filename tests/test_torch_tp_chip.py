"""chip_smoke.py phase 19 (tensor and expert parallelism of the weights)
rehearsed on the CPU: ``CHIP_SMOKE_TP_DEVICE=cpu`` runs the phase's
code at the reduced configs (4 requests of 24 tokens, 2 steps; the
kernels' plain versions), its NCCL worlds of one as gloo, its child and
its four ranks as processes of this machine.  The phase must pass: the
TP path at a world of one bit-equal to the unsharded run (weights,
logits, tokens, hot tier, expert choices), and each rank of the meshes
within the limits of the unsharded logits, with its hot tier exact and
its control outside both limits; (c), the MoE dispatch groups over the
batch axes, its serve run within the same limits (two all-to-alls a MoE
layer of the prefill) and its training step within phase 20's, the
control outside."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_REHEARSAL = """
import sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
if __name__ == "__main__":
    import torch
    import chip_smoke
    from repro_torch.kernels import ops
    chip_smoke.tp_phase(torch, ops, "cpu rehearsal")
"""


def test_chip_smoke_tp_phase_rehearses_on_cpu():
    env = dict(os.environ, CHIP_SMOKE_TP_DEVICE="cpu", OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c", _REHEARSAL, str(ROOT), str(ROOT / "src")],
        capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    recs = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    ones = [r for r in recs if r.get("run") == "nccl_world_1"]
    assert {r["config"] for r in ones} == {"qwen2-1.5b", "deepseek-v32"}
    assert all(all(r["equal_unsharded"].values()) for r in ones)
    meshes = [(r["config"], tuple(r["mesh"])) for r in recs
              if r.get("run") == "gloo_4_ranks_one_card"]
    assert meshes == [("deepseek-v32", (2, 2)), ("qwen2-1.5b", (1, 4)),
                      ("qwen2-1.5b", (2, 2))]
    for r in recs:
        if r.get("run") == "gloo_4_ranks_one_card":
            assert r["worst_rel_l2"] <= r["limits"]["rel_l2"]
            assert r["control_least_rel_l2"] > r["limits"]["rel_l2"]
    grouped = {r["run"]: r for r in recs
               if r.get("run", "").startswith("gloo_4_ranks_grouped")}
    assert set(grouped) == {"gloo_4_ranks_grouped_serve",
                            "gloo_4_ranks_grouped_train"}
    serve, train = (grouped[f"gloo_4_ranks_grouped_{k}"]
                    for k in ("serve", "train"))
    assert serve["worst_rel_l2"] <= serve["limits"]["rel_l2"]
    for rank in serve["ranks"]:     # two all-to-alls a MoE layer
        assert rank["moe_collectives_prefill"]["all-to-all"] == 4
    assert train["worst_grad_rel_l2"] <= train["limits"]["grad_rel_l2"]
    assert train["control_least_worst"] > train["limits"]["grad_rel_l2"]
    assert recs[-1]["phase"] == "tensor_parallel_total"
