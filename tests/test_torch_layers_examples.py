"""``layers.decode_attention`` and the port's examples
(``examples/torch/*.py``) on the CPU.

- ``decode_attention`` against the reference's on seeded numpy inputs:
  ragged length masks (a row with no valid lane too), n_rep 1 and 4,
  f32 caches, at ``F32_TOL`` (both softmax in f32; the sums run in
  another order);
- each port example with ``--device cpu``: quickstart (its fabric
  figures, pure Python over the copied ``core/transfer.py``, equal the
  reference example's printout, which runs in a subprocess meanwhile),
  serve_sac, train_sparse_lm (3 steps) and failover_restart (the resumed
  step equals the straight run's, bit for bit).
"""
import contextlib
import io
import os
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples" / "torch"
F32_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_rep", [1, 4])
def test_decode_attention_equals_reference(n_rep):
    import jax.numpy as jnp
    from repro.models.layers import decode_attention as jdecode
    from repro_torch.models.layers import decode_attention
    rng = np.random.default_rng(n_rep)
    B, T, nkv, hd = 4, 37, 2, 16
    q = rng.standard_normal((B, nkv * n_rep, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, nkv, hd)).astype(np.float32)
    lengths = np.array([T, 1, 20, 0])          # ragged; the last: no lane
    mask = np.arange(T)[None] < lengths[:, None]
    want = np.asarray(jdecode(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), jnp.asarray(mask)))
    got = decode_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(name, *args):
    """The example's ``main`` with ``--device cpu``: (result, stdout)."""
    buf = io.StringIO()
    main = runpy.run_path(str(EXAMPLES / f"{name}.py"))["main"]
    with contextlib.redirect_stdout(buf):
        out = main(["--device", "cpu", *args])
    return out, buf.getvalue()


def _fabric_lines(text):
    return [ln for ln in text.splitlines()
            if ln.startswith(("per-request per-step fetch", "fetch latency"))]


@pytest.fixture(scope="module")
def reference_quickstart():
    """The reference's quickstart (JAX on the CPU, ~20 s), started in a
    subprocess at the first example test and read by the last."""
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / "quickstart.py")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu",
                 PYTHONPATH=str(ROOT / "src")))
    yield proc
    if proc.poll() is None:
        proc.kill()


def _check_quickstart(out, text):
    assert "step 4: tokens" in text and len(_fabric_lines(text)) == 2


def _check_serve(out, text):
    assert out["n_done"] == 8 and "cxl:" in text


def _check_train(losses, text):
    assert len(losses) == 3 and all(np.isfinite(losses))


def _check_failover(out, text):
    straight, resumed = out
    assert resumed == straight          # the resumed step, bit for bit
    assert "restored step 3" in text


EXAMPLE_RUNS = {"quickstart": ((), _check_quickstart),
                "serve_sac": ((), _check_serve),
                "train_sparse_lm": (("--steps", "3"), _check_train),
                "failover_restart": ((), _check_failover)}


@pytest.mark.parametrize("name", list(EXAMPLE_RUNS))
def test_example_runs_on_cpu(name, reference_quickstart, one_torch_thread):
    args, check = EXAMPLE_RUNS[name]
    check(*_run(name, *args))


def test_quickstart_fabric_figures_equal_reference(reference_quickstart,
                                                   one_torch_thread):
    want, _ = reference_quickstart.communicate(timeout=300)
    assert reference_quickstart.returncode == 0, want
    port = _fabric_lines(_run("quickstart")[1])
    assert len(port) == 2 and port == _fabric_lines(want)
