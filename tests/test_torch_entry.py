"""The port's entry point, the K1 wrapper's input checks, and the port's
import hygiene (it never imports jax or manatee_tpu).

This file imports no jax and needs no conftest, so it also runs on a
machine with a CUDA card:

    python -m pytest tests/test_torch_entry.py -q -m cuda --noconftest

runs the kernel-vs-plain tests there; on a machine without CUDA they
skip.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from manatee_tpu_torch.device import resolve
from manatee_tpu_torch.graft_entry import entry
from manatee_tpu_torch.health.predictor import init_params, predict
from manatee_tpu_torch.health.telemetry import TorchScorer
from manatee_tpu_torch.health.train import evaluate_recorded
from manatee_tpu_torch.kernels.mlp_forward import (
    CROSSOVER,
    mlp_forward,
    mlp_forward_plain,
)

REPO = Path(__file__).resolve().parent.parent
HANG = sorted(str(p) for p in (REPO / "tests/data/recorded-hang-r4").glob(
    "*.jsonl"))


def _needs_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _weights(device="cpu"):
    model = init_params(torch.Generator(device=device).manual_seed(0))
    return tuple(t.detach() for t in model.tensors())


def test_entry_on_cpu():
    fn, (params, windows) = entry(device="cpu")
    assert windows.shape == (64, 16, 5) and windows.device.type == "cpu"
    out = fn(params, windows)
    assert out.shape == (64,) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
    assert bool(((out >= 0) & (out <= 1)).all())
    # seeded: a second call gives the same batch and scores
    fn2, (params2, windows2) = entry(device="cpu")
    assert torch.equal(windows, windows2)
    assert torch.equal(out, fn2(params2, windows2))


@pytest.mark.parametrize("call", [
    lambda: resolve(),
    lambda: entry(),
    lambda: TorchScorer(),
    lambda: evaluate_recorded(HANG),
], ids=["resolve", "entry", "TorchScorer", "evaluate_recorded"])
def test_default_device_is_cuda_and_never_falls_back(call):
    _needs_no_cuda()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_resolve_cpu():
    assert resolve("cpu") == torch.device("cpu")


@pytest.mark.parametrize("case", [
    "cpu_tensor", "float64", "wrong_window", "flat", "non_contiguous",
    "weight_shape", "weight_dtype"])
def test_wrapper_rejects(case):
    w = list(_weights())
    x = torch.rand(8, 16, 5)
    err, match = ValueError, "shape"
    if case == "cpu_tensor":
        match = "CUDA kernel"
    elif case == "float64":
        x, err, match = x.double(), TypeError, "float32"
    elif case == "wrong_window":
        x = torch.rand(8, 5, 16)
    elif case == "flat":
        x = torch.rand(8, 80)
    elif case == "non_contiguous":
        x, match = torch.rand(16, 8, 5).transpose(0, 1), "contiguous"
    elif case == "weight_shape":
        w[0] = w[0].T.contiguous()
    elif case == "weight_dtype":
        w[2], err, match = w[2].double(), TypeError, "float32"
    with pytest.raises(err, match=match):
        mlp_forward(x, *w)


def test_predict_on_cpu_is_the_plain_version():
    w = _weights()
    x = torch.rand(33, 16, 5, generator=torch.Generator().manual_seed(3))
    model = init_params(torch.Generator().manual_seed(0))
    assert torch.equal(predict(model, x), mlp_forward_plain(x, *w))
    assert not predict(model, x).requires_grad


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def _forbidden(name: str) -> bool:
    return (name.startswith("jax") or name == "manatee_tpu"
            or name.startswith("manatee_tpu."))


def test_port_sources_import_no_jax_and_no_reference():
    files = sorted((REPO / "manatee_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) >= 10
    bad = {str(f.relative_to(REPO)): [n for n in _imports(f) if _forbidden(n)]
           for f in files}
    assert not {f: n for f, n in bad.items() if n}


def test_port_runs_without_jax_in_a_fresh_process():
    code = """
import sys
from manatee_tpu_torch.graft_entry import entry
from manatee_tpu_torch.health.predictor import synthetic_batch, train_step
from manatee_tpu_torch.health.train import (
    evaluate_recorded, recorded_windows, train)
import torch
fn, args = entry(device="cpu")
assert fn(*args).shape == (64,)
ev = evaluate_recorded(%r, device="cpu")
assert ev["scored_ticks"] > 0, ev
w, y = synthetic_batch(torch.Generator().manual_seed(1), 16, "cpu")
_model, loss = train_step(args[0], w, y)
assert float(loss) > 0
rec = recorded_windows(%r[:1])
assert len(rec[1]) > 0
_model, loss, acc = train(steps=2, recorded=rec, device="cpu")
assert loss > 0 and 0 <= acc <= 1
from manatee_tpu_torch.state import mc_array, modelcheck
res = mc_array.explore_torch(modelcheck.CONFIGS["deaths3"], depth=2,
                             device="cpu")
assert res.ok and res.complete and res.states > 1, res
two = mc_array.explore_torch(modelcheck.CONFIGS["deaths3"], depth=2,
                             device=["cpu"] * 2)
assert (two.states, two.nodes, two.transitions) == (
    res.states, res.nodes, res.transitions), two
bad = [m for m in sys.modules if m.startswith("jax") or m == "manatee_tpu"
       or m.startswith("manatee_tpu.")]
assert not bad, bad
print("clean")
""" % (HANG, HANG)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 63, 64, 96, CROSSOVER - 1, CROSSOVER,
                                   CROSSOVER + 1, 4458, 65537])
def test_kernel_matches_plain_on_cuda(batch):
    _needs_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    w = _weights("cuda")
    g = torch.Generator(device="cuda").manual_seed(batch)
    for x in (torch.rand(batch, 16, 5, generator=g, device="cuda"),
              torch.zeros(batch, 16, 5, device="cuda"),
              torch.ones(batch, 16, 5, device="cuda")):
        before = mlp_forward.launches
        got = mlp_forward(x, *w)
        want = mlp_forward_plain(x, *w)
        torch.cuda.synchronize()
        assert mlp_forward.launches == before + 1
        assert bool(((got >= 0) & (got <= 1)).all())
        # fp32 sums in another order than cuBLAS: a few ulp of a logit
        assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_predict_on_cuda_launches_the_kernel():
    _needs_cuda()
    fn, (params, windows) = entry()
    before = mlp_forward.launches
    out = fn(params, windows)
    assert mlp_forward.launches == before + 1
    with torch.no_grad():
        want = mlp_forward_plain(windows, *params.tensors())
    assert float((out - want).abs().max()) <= 1e-5
