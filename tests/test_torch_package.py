"""Package-level guards of the PyTorch port (``src/repro_torch``).

- the port imports with ``jax`` blocked, and neither it nor
  ``chip_smoke.py`` imports anything of the JAX package ``repro``;
- its entry points run on the card by default: ``Engine(...)`` without a
  device refuses a machine that has none (no quiet switch to the CPU);
- the host modules the port copies whole stay equal to their references,
  apart from the import prefix ``repro.`` -> ``repro_torch.`` and the
  trailing ``# sacheck: disable=`` justifications, so a later fix to a
  reference host module cannot silently miss the port.
"""
import ast
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
    + [f"serving/{m}.py" for m in ("request", "radix", "arbiter")]
    + [p.relative_to(REF).as_posix()
       for p in (REF / "serving" / "policy").glob("*.py")])
# classes/functions copied whole into a port module that is not a copy
COPIED_DEFS = [("serving/simulator.py", "ModelProfile"),
               ("serving/simulator.py", "profile_from_config"),
               ("core/sac.py", "RequestPages"),
               ("core/sac.py", "SACSystem")]

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


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
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


@pytest.mark.parametrize("rel,name", COPIED_DEFS)
def test_host_definitions_match_reference(rel, name):
    def segment(path):
        text = path.read_text()
        for node in ast.parse(text).body:
            if getattr(node, "name", None) == name:
                seg = ast.get_source_segment(text, node)
                deco = [ast.get_source_segment(text, d)
                        for d in getattr(node, "decorator_list", [])]
                return deco, seg
        raise AssertionError(f"{name} not in {path}")
    want = segment(REF / rel)
    got = segment(PORT / rel)
    assert got == (want[0], want[1].replace("repro.", "repro_torch.")), \
        f"{rel}::{name} drifted from the reference"
