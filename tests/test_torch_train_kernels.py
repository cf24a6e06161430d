"""The training path's kernels, K2 (kernels/mlp_train.py) and K4
(kernels/synthetic_batch.py): their wrappers' input checks, their plain
versions on the CPU, and, on a machine with a CUDA card, each kernel
against its plain version and the training path on the card.

This file imports no jax and needs no conftest, so it also runs on a
machine with a CUDA card:

    python -m pytest tests/test_torch_train_kernels.py -q -m cuda --noconftest

runs the card tests there; on a machine without CUDA they skip.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from manatee_tpu_torch.health import predictor, telemetry
from manatee_tpu_torch.health.convert import load_npz
from manatee_tpu_torch.health.telemetry import DEFAULT_WEIGHTS
from manatee_tpu_torch.kernels import mlp_forward as k1
from manatee_tpu_torch.kernels import synthetic_batch as k4
from manatee_tpu_torch.kernels.mlp_train import (
    GRAD_SIZE,
    N_PARAMS,
    grad_sums_plain,
    mlp_sgd_apply,
    mlp_train_partials,
    sgd_apply_block_order,
    sgd_apply_plain,
    unflatten,
)

REPO = Path(__file__).resolve().parent.parent


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _model(device="cpu", seed=0):
    return predictor.init_params(
        torch.Generator(device=device).manual_seed(seed))


def _weights(device="cpu", seed=0):
    return [t.detach() for t in _model(device, seed).tensors()]


def _draws(batch, device="cpu", seed=0):
    return predictor.synthetic_draws(
        torch.Generator(device=device).manual_seed(seed), batch, device)


@pytest.mark.parametrize("case", [
    "cpu_tensor", "float64", "wrong_window", "labels_shape",
    "labels_dtype", "non_contiguous", "weight_shape", "weight_dtype"])
def test_train_partials_wrapper_rejects(case):
    w = _weights()
    x, y = torch.rand(8, 16, 5), torch.rand(8)
    err, match = ValueError, "shape"
    if case == "cpu_tensor":
        match = "CUDA kernel"
    elif case == "float64":
        x, err, match = x.double(), TypeError, "float32"
    elif case == "wrong_window":
        x = torch.rand(8, 5, 16)
    elif case == "labels_shape":
        y = torch.rand(8, 1)
    elif case == "labels_dtype":
        y, err, match = y.long(), TypeError, "float32"
    elif case == "non_contiguous":
        x, match = torch.rand(16, 8, 5).transpose(0, 1), "contiguous"
    elif case == "weight_shape":
        w[0] = w[0].T.contiguous()
    elif case == "weight_dtype":
        w[2], err, match = w[2].double(), TypeError, "float32"
    with pytest.raises(err, match=match):
        mlp_train_partials(x, y, *w)


@pytest.mark.parametrize("case", [
    "cpu_tensor", "width", "float64", "non_contiguous", "five_params"])
def test_sgd_apply_wrapper_rejects(case):
    partials = torch.zeros(3, GRAD_SIZE)
    params = _weights()
    err, match = ValueError, "shape"
    if case == "cpu_tensor":
        match = "CUDA kernel"
    elif case == "width":
        partials = torch.zeros(3, N_PARAMS)
    elif case == "float64":
        partials, err, match = partials.double(), TypeError, "float32"
    elif case == "non_contiguous":
        partials, match = torch.zeros(GRAD_SIZE, 3).T, "contiguous"
    elif case == "five_params":
        params, match = params[:5], "six tensors"
    with pytest.raises(err, match=match):
        mlp_sgd_apply(partials, 1.0, params, 0.1)


@pytest.mark.parametrize("case", [
    "cpu_tensor", "missing", "noise_shape", "phase_dtype", "pad_u_shape",
    "non_contiguous"])
def test_synthetic_windows_wrapper_rejects(case):
    draws = _draws(8)
    err, match = ValueError, "shape"
    if case == "cpu_tensor":
        match = "CUDA kernel"
    elif case == "missing":
        del draws["pad_len"]
        err, match = KeyError, "pad_len"
    elif case == "noise_shape":
        draws["noise"] = torch.rand(8, 80)
    elif case == "phase_dtype":
        draws["phase"], err, match = draws["phase"].int(), TypeError, "int64"
    elif case == "pad_u_shape":
        draws["pad_u"] = torch.rand(8)
    elif case == "non_contiguous":
        draws["noise"], match = (torch.rand(16, 8, 5).transpose(0, 1),
                                 "contiguous")
    with pytest.raises(err, match=match):
        k4.synthetic_windows(draws)


def test_kernel_constants_match_the_ring():
    assert k4.STATUS_EVERY == telemetry.STATUS_EVERY
    assert (k4.WINDOW, k4.N_FEATURES) == (telemetry.WINDOW,
                                          telemetry.N_FEATURES)


def test_the_cached_ramp_is_linspace_bit_for_bit():
    fresh = torch.linspace(0.0, 1.0, 16)
    got = k4.ramp("cpu")
    assert got.dtype == fresh.dtype and got.shape == (16,)
    assert torch.equal(got.view(torch.int32), fresh.view(torch.int32))
    # made once a device and reused
    assert k4.ramp(torch.device("cpu")) is got


def test_cpu_path_is_the_plain_version():
    counts = (k4.synthetic_windows.launches, mlp_train_partials.launches,
              mlp_sgd_apply.launches)
    draws = _draws(50, seed=3)
    got = predictor.synthetic_from_draws(draws)
    want = k4.synthetic_windows_plain(draws)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    w = _weights()
    x, y = got
    model, loss = predictor.train_step(_model(), x, y, 0.1)
    sums, new = sgd_apply_plain(grad_sums_plain(x, y, *w)[None], 1 / 50, w,
                                0.1)
    assert torch.equal(loss, sums[-1])
    assert all(torch.equal(a, b) for a, b in zip(model.tensors(), new))
    assert counts == (k4.synthetic_windows.launches,
                      mlp_train_partials.launches, mlp_sgd_apply.launches)


def test_sgd_apply_plain_reduces_and_updates():
    partials = torch.rand(5, GRAD_SIZE, generator=torch.Generator()
                          .manual_seed(0))
    w = _weights()
    sums, none = sgd_apply_plain(partials, 1.0)
    assert none is None and torch.allclose(sums, partials.sum(0))
    sums, new = sgd_apply_plain(partials, 0.5, w, 0.1)
    for p, g, q in zip(w, unflatten(sums), new):
        assert q.shape == p.shape and torch.equal(q, p - 0.1 * g)


# K2b's partial rows, as chip_smoke.py: one (the mesh step's apply), a
# training step's 4, whole and partial groups of 4 and of 32 rows
# (csrc/mlp_train.cu kApplyGroup, kApplyWide), `health/train.py --batch`
# 513 to 4,096 (n = ceil(B/64): 9 to 64) and the 65,536-row batch's
# 1,024
K2B_ROWS = (1, 4, 5, 8, 9, 32, 33, 64, 1024, 1025, 4097)


@pytest.mark.parametrize("n", K2B_ROWS)
def test_block_order_reference_agrees_with_the_plain_step(n):
    """K2b's block-order reference (one double chain an entry, then a
    float32 scale) is the plain step's function: within 1e-5 of
    sgd_apply_plain's float32 pairwise sums, scale 1 and 1/256."""
    g = torch.Generator().manual_seed(n)
    partials = torch.randn(n, GRAD_SIZE, generator=g) / 8
    w = _weights()
    for scale in (1.0, 1 / 256):
        sums, new = sgd_apply_block_order(partials, scale, w, 0.05)
        want_sums, want = sgd_apply_plain(partials, scale, w, 0.05)
        assert sums.dtype == torch.float32 and sums.shape == (GRAD_SIZE,)
        assert float((sums - want_sums).abs().max()) <= 1e-5
        for a, b in zip(new, want):
            assert a.shape == b.shape and float((a - b).abs().max()) <= 1e-5
        assert sgd_apply_block_order(partials, scale)[1] is None


# ---- on the card (skip without CUDA) --------------------------------

# as chip_smoke.py: the main path's batches, and edge and bulk sizes;
# K4 at odd batches has a half-filled last warp, and below or just past a
# multiple of 8 a partial last block; K2a at 65 and 128 has partial
# tiles and several entry slices a tile
K4_BATCHES = (1, 2, 3, 7, 15, 16, 17, 64, 249, 255, 256, 257, 2048, 65537)
K2_BATCHES = (1, 7, 16, 65, 128, 249, 256, 4096, 65537)
QUALITY_SEEDS = (0, 1, 2, 3, 4)


def _inputs(kind, batch, g):
    return {"random": lambda: torch.rand(batch, 16, 5, generator=g,
                                         device="cuda"),
            "zeros": lambda: torch.zeros(batch, 16, 5, device="cuda"),
            "ones": lambda: torch.ones(batch, 16, 5, device="cuda"),
            "wide": lambda: 4 * torch.randn(batch, 16, 5, generator=g,
                                            device="cuda")}[kind]()


@pytest.mark.cuda
@pytest.mark.parametrize("batch", K4_BATCHES)
def test_synthetic_kernel_equals_plain_on_cuda(batch):
    _needs_cuda()
    for seed in (0, 1, 2):
        draws = _draws(batch, "cuda", seed)
        before = k4.synthetic_windows.launches
        got = k4.synthetic_windows(draws)
        want = k4.synthetic_windows_plain(draws)
        torch.cuda.synchronize()
        assert k4.synthetic_windows.launches == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # the kernel's ramp, cached a device, is torch.linspace's own
    assert torch.equal(k4.ramp("cuda").view(torch.int32),
                       torch.linspace(0.0, 1.0, 16, device="cuda")
                       .view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", K2_BATCHES)
@pytest.mark.parametrize("kind", ["random", "zeros", "ones", "wide"])
def test_train_step_kernels_match_plain_on_cuda(batch, kind):
    _needs_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(batch)
    x = _inputs(kind, batch, g)
    models = (_model("cuda"), load_npz(DEFAULT_WEIGHTS).to("cuda"))
    labels = (torch.rand(batch, generator=g, device="cuda").round(),
              torch.zeros(batch, device="cuda"),
              torch.ones(batch, device="cuda"))
    for model in models:
        w = [t.detach() for t in model.tensors()]
        for y in labels:
            got, loss = predictor.train_step(model, x, y, 0.05)
            again, loss2 = predictor.train_step(model, x, y, 0.05)
            want_sums, want = sgd_apply_plain(
                grad_sums_plain(x, y, *w)[None], 1 / batch, w, 0.05)
            torch.cuda.synchronize()
            assert abs(float(loss) - float(want_sums[-1])) <= 1e-5
            for a, b, c in zip(got.tensors(), want, again.tensors()):
                assert float((a - b).abs().max()) <= 1e-5
                assert torch.equal(a, c)          # no atomics: same bits
            assert torch.equal(loss, loss2)


@pytest.mark.cuda
@pytest.mark.parametrize("n", K2B_ROWS)
def test_sgd_apply_equals_the_block_order_reference_on_cuda(n):
    """K2b's sums and new tensors equal its block-order reference bit
    for bit, with and without parameters, scale 1 and 1/256."""
    _needs_cuda()
    g = torch.Generator(device="cuda").manual_seed(n)
    partials = 3 * torch.randn(n, GRAD_SIZE, generator=g, device="cuda")
    w = _weights("cuda")
    for scale in (1.0, 1 / 256):
        for params in (None, w):
            before = mlp_sgd_apply.launches
            sums, new = mlp_sgd_apply(partials, scale, params, 0.05)
            want_sums, want = sgd_apply_block_order(partials, scale,
                                                    params, 0.05)
            torch.cuda.synchronize()
            assert mlp_sgd_apply.launches == before + 1
            assert torch.equal(sums, want_sums), (scale, params is None)
            if params is None:
                assert new is None and want is None
            else:
                assert all(torch.equal(a, b) for a, b in zip(new, want))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 64, 249, 256, k1.CROSSOVER, 65537])
def test_kernels_rerun_to_the_same_bits_on_cuda(batch):
    """Two launches of K1 (in every launch shape, all equal) and two of
    K2a on the same inputs give the same bits: no atomics, no order that
    depends on scheduling."""
    _needs_cuda()
    g = torch.Generator(device="cuda").manual_seed(batch)
    x = 4 * torch.randn(batch, 16, 5, generator=g, device="cuda")
    y = torch.rand(batch, generator=g, device="cuda").round()
    for w in (_weights("cuda"), [t.detach() for t in load_npz(
            DEFAULT_WEIGHTS).to("cuda").tensors()]):
        with torch.no_grad():
            first = k1.mlp_forward(x, *w)
            runs = [k1.mlp_forward(x, *w) for _ in range(2)]
            runs += [k1._launch(x, w, s) for s in k1.SHAPES]
        partials = mlp_train_partials(x, y, *w)
        again = mlp_train_partials(x, y, *w)
        torch.cuda.synchronize()
        assert all(torch.equal(first, r) for r in runs)
        assert torch.equal(partials, again)


@pytest.mark.cuda
def test_training_on_the_card_passes_the_bar(tmp_path):
    """The `make train-health` recipe on the card, read as chip_smoke.py
    reads it: over five seeds, detection >= 0.95 on average, and every
    seed's median lead >= 3 and FPR <= 0.01."""
    _needs_cuda()
    from manatee_tpu_torch.health import train

    mix = [str(p) for d in ("r4", "s2", "s3") for p in sorted(
        (REPO / "tests/data" / ("recorded-chaos-" + d)).glob("*.jsonl"))]
    out = tmp_path / "w.npz"
    train.main(["--mix-recorded", *mix, "-o", str(out)])
    with np.load(out) as z:
        assert sorted(z.files) == sorted(predictor.PARAM_NAMES)
    recorded = train.recorded_windows(mix)
    detection = []
    for seed in QUALITY_SEEDS:
        model, _loss, _acc = train.train(seed=seed, recorded=recorded)
        train.export(model, out)
        ev = train.evaluate(out, n_traces=60, seed=7)
        assert ev["median_lead_ticks"] >= 3, (seed, ev)
        assert ev["false_positive_rate"] <= 0.01, (seed, ev)
        detection.append(ev["detection_rate"])
    assert sum(detection) / len(detection) >= 0.95, detection
