"""Package-level guards of the PyTorch port (``src/repro_torch``).

- the port imports with ``jax`` blocked, and neither it nor
  ``chip_smoke.py`` imports anything of the JAX package ``repro``;
- its entry points run on the card by default: ``Engine(...)`` without a
  device refuses a machine that has none (no quiet switch to the CPU);
- the host modules the port copies whole stay equal to their references,
  apart from the import prefix ``repro.`` -> ``repro_torch.`` and the
  trailing ``# sacheck: disable=`` justifications, so a later fix to a
  reference host module cannot silently miss the port;
- the serving CLI (``repro_torch.launch.serve``) takes the reference's
  flags with the same defaults, plus ``--device``, and on the CPU prints
  the reference's JSON keys for the same served trace.
"""
import ast
import contextlib
import io
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

# modules copied whole from the reference (paths relative to the package)
COPIED = sorted(
    [p.relative_to(REF).as_posix() for p in (REF / "configs").glob("*.py")]
    + [f"core/{m}.py" for m in ("transfer", "fabric", "traffic", "metadata",
                                "placement")]
    + [f"serving/{m}.py" for m in ("request", "radix", "arbiter",
                                   "scheduler", "simulator")]
    + [p.relative_to(REF).as_posix()
       for p in (REF / "serving" / "policy").glob("*.py")]
    + ["training/data.py"])
# classes/functions copied whole into a port module that is not a copy
COPIED_DEFS = [("serving/prefetch.py", "analytic_prefetch"),
               ("serving/prefetch.py", "analytic_warmup"),
               ("core/sac.py", "RequestPages"),
               ("core/sac.py", "SACSystem"),
               ("training/optimizer.py", "OptConfig"),
               ("distributed/sharding.py", "TRAIN_RULES"),
               ("distributed/sharding.py", "SERVE_RULES"),
               ("distributed/elastic.py", "viable_mesh_shape"),
               ("distributed/elastic.py", "StepReport")]

_SACHECK = re.compile(r"\s*# sacheck: disable=.*$")


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_port_imports_with_jax_blocked():
    mods = list(_port_modules())
    assert {"repro_torch.models.encdec", "repro_torch.launch.train",
            "repro_torch.launch.mesh", "repro_torch.core.topk",
            "repro_torch.distributed", "repro_torch.distributed.sharding",
            "repro_torch.distributed.elastic"} | {
        f"repro_torch.training.{m}" for m in ("data", "optimizer",
                                              "train_loop", "checkpoint")
    } <= set(mods)
    code = ("import sys\nsys.modules['jax'] = None\n"
            f"import importlib\nfor m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in [k for k, v in sys.modules.items() if v]\n"
            "print('ok', len(" + repr(mods) + "))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


# every module of the port and chip_smoke.py: none may import JAX or repro
SCANNED = sorted([p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")]
                 + ["chip_smoke.py"])


def test_scan_covers_the_entry_points():
    for path in ("src/repro_torch/launch/serve.py",
                 "src/repro_torch/launch/train.py",
                 "src/repro_torch/launch/mesh.py",
                 "src/repro_torch/core/topk.py",
                 "src/repro_torch/distributed/sharding.py",
                 "src/repro_torch/distributed/elastic.py",
                 "src/repro_torch/models/encdec.py",
                 "src/repro_torch/training/train_loop.py",
                 "src/repro_torch/serving/engine.py",
                 "src/repro_torch/serving/prefetch.py", "chip_smoke.py"):
        assert path in SCANNED


@pytest.mark.parametrize("path", SCANNED)
def test_no_reference_or_jax_import(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            top = name.split(".")[0]
            assert top not in ("repro", "jax", "jaxlib"), \
                f"{path}:{node.lineno} imports {name}"


def test_engine_default_device_refuses_a_machine_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid")
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import Engine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(get_config("deepseek-v32").reduced(), slots=1, max_ctx=32)


def _strip(text: str) -> str:
    lines = []
    for line in text.split("\n"):
        stripped = _SACHECK.sub("", line)
        if line.strip().startswith("# sacheck: disable=") and \
                not stripped.strip():
            continue                       # a justification on its own line
        lines.append(stripped)
    return "\n".join(lines)


@pytest.mark.parametrize("rel", COPIED)
def test_host_copy_matches_reference(rel):
    want = (REF / rel).read_text().replace("repro.", "repro_torch.")
    got = _strip((PORT / rel).read_text())
    assert got == want, (f"src/repro_torch/{rel} drifted from "
                         f"src/repro/{rel}: re-copy it")


def _defines(node) -> str:
    """The name a module-level statement defines (a function, a class or
    an assignment such as a rule table), else None."""
    if isinstance(node, ast.AnnAssign):
        return getattr(node.target, "id", None)
    if isinstance(node, ast.Assign) and len(node.targets) == 1:
        return getattr(node.targets[0], "id", None)
    return getattr(node, "name", None)


@pytest.mark.parametrize("rel,name", COPIED_DEFS)
def test_host_definitions_match_reference(rel, name):
    def segment(path):
        text = path.read_text()
        for node in ast.parse(text).body:
            if _defines(node) == name:
                seg = ast.get_source_segment(text, node)
                deco = [ast.get_source_segment(text, d)
                        for d in getattr(node, "decorator_list", [])]
                return deco, seg
        raise AssertionError(f"{name} not in {path}")
    want = segment(REF / rel)
    got = segment(PORT / rel)
    assert got == (want[0], want[1].replace("repro.", "repro_torch.")), \
        f"{rel}::{name} drifted from the reference"


def _cli_flags(path):
    """flag -> its add_argument keywords but ``help``, as source text."""
    flags = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "add_argument"):
            flags[node.args[0].value] = {
                kw.arg: ast.unparse(kw.value) for kw in node.keywords
                if kw.arg != "help"}
    return flags


def test_serve_cli_flags_match_reference():
    want = _cli_flags(REF / "launch" / "serve.py")
    got = _cli_flags(PORT / "launch" / "serve.py")
    assert got.pop("--device") == {"default": "'cuda'"}
    assert got == want


def test_train_cli_flags_match_reference():
    want = _cli_flags(REF / "launch" / "train.py")
    got = _cli_flags(PORT / "launch" / "train.py")
    assert got.pop("--device") == {"default": "'cuda'"}
    assert got == want


def test_serve_cli_on_cpu_prints_the_reference_keys(monkeypatch):
    """The same trace through both CLIs with the fetch pipeline, the
    arbiter and online re-sizing on: the same JSON keys, requests served
    and tokens."""
    import repro.launch.serve as jserve
    from repro_torch.launch import serve as tserve
    args = ["--reduced", "--prefetch", "--arbiter", "--resize-interval",
            "2", "--requests", "3", "--ctx", "24", "--out-len", "3"]
    outs = []
    for run in (lambda: jserve.main(),
                lambda: tserve.main(args + ["--device", "cpu"])):
        monkeypatch.setattr(sys, "argv", ["serve"] + args)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run()
        text = buf.getvalue()
        outs.append(json.loads(text[text.index("{"):]))
    want, got = outs
    assert list(got) == list(want)
    assert (got["n_done"], got["engine_tokens"]) == \
        (want["n_done"], want["engine_tokens"]) == (3, 9)


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for small tensors: faster alone, and no
    oversubscription when several test processes share the cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_chip_smoke_whisper_and_training_phases_rehearse_on_cpu(
        monkeypatch, capsys, one_torch_thread):
    """chip_smoke.py's new phases, reduced on the CPU (their rehearsal:
    the card runs them at full size): the reduced-Whisper and training
    small checks (the CPU against itself: no error, the e4m3 controls
    above the limit), the Whisper serve phase (no kernel launches on the
    CPU) and the training phase (straight run, resume from step 10, the
    restored tree equal to the saved one)."""
    import torch
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    cpu = ("cpu", "cpu")
    for mode in ("sac", "dense"):
        err, control = cs.small_check_encdec(
            torch, cs.small_config("whisper-small"), mode=mode, devices=cpu)
        assert err == 0.0 and control > cs.SMALL_TOL
    err, control, loss, leaves = cs.train_small_check(
        torch, cs.small_config("deepseek-v32"), devices=cpu)
    assert err == 0.0 and control > cs.SMALL_TOL and leaves > 10
    counts = cs.serve_whisper(torch, ops, get_config("whisper-small")
                              .reduced(), device="cpu", requests=2,
                              frames=64, steps=3)
    assert not any(counts.values())
    cs.train_phase(torch, ops, argv=[
        "--arch", "qwen2-1.5b", "--reduced", "--batch", "2", "--seq", "16",
        "--steps", "20", "--ckpt-every", "10"], device="cpu")
    records = [json.loads(line) for line in capsys.readouterr().out
               .splitlines() if line.startswith("{")]
    assert [r["phase"] for r in records] == ["serve", "train"]
    serve, train = records
    assert serve["decode_steps"] == 3 and serve["logits_finite"]
    assert train["restores"] == [dict(train["restores"][0], step=10,
                                      equal_to_saved=True)]
    assert train["straight"]["steps"] == 20
    assert train["resumed"]["steps"] == 10
