"""Which devices the port runs on (``device.resolve_all``), and device
hygiene at every kernel launch: a launch on one card leaves the calling
thread's current device as it was.

This file imports no jax and needs no conftest, so it also runs on a
machine with a CUDA card:

    python -m pytest tests/test_torch_devices.py -q -m cuda --noconftest

runs the card test there; on a machine without CUDA it skips.  With two
or more cards it launches every kernel on a card that is not current.
"""

import pytest
import torch

from manatee_tpu_torch.device import resolve, resolve_all

CPU = torch.device("cpu")


def _cards(monkeypatch, n):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)


@pytest.mark.parametrize("device, want", [
    ("cpu", [CPU]), (CPU, [CPU]), (["cpu"] * 8, [CPU] * 8),
    ((CPU, "cpu"), [CPU, CPU])])
def test_cpu_devices(device, want):
    assert resolve_all(device) == want


def test_none_is_every_visible_card(monkeypatch):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_all(None)
    _cards(monkeypatch, 3)
    assert resolve_all(None) == [torch.device("cuda", i) for i in range(3)]


def test_a_list_of_cards_keeps_its_order_and_repeats(monkeypatch):
    _cards(monkeypatch, 2)
    assert resolve_all(["cuda:1", "cuda:0", torch.device("cuda", 1)]) == [
        torch.device("cuda", 1), torch.device("cuda", 0),
        torch.device("cuda", 1)]
    assert resolve_all(["cuda:0"] * 4) == [torch.device("cuda", 0)] * 4
    assert resolve("cuda:1") == torch.device("cuda", 1)


@pytest.mark.parametrize("device, error, match", [
    ("cuda:2", RuntimeError, "not present"),
    (["cuda:0", "cuda:5"], RuntimeError, "not present"),
    (["cpu", "cuda:0"], ValueError, "one kind"),
    ([], ValueError, "no device")])
def test_rejected(monkeypatch, device, error, match):
    _cards(monkeypatch, 2)
    with pytest.raises(error, match=match):
        resolve_all(device)


# -- on the card ---------------------------------------------------------------


def _launches(dev):
    """One launch of each kernel of the six libraries on *dev* (K7's
    sort in both its plans)."""
    from manatee_tpu_torch.health.predictor import (
        init_params,
        synthetic_draws,
    )
    from manatee_tpu_torch.kernels import (
        mc_dedup,
        mc_sort,
        mc_step,
        mlp_forward,
        mlp_train,
        synthetic_batch,
    )
    from manatee_tpu_torch.state import mc_array as ma
    from manatee_tpu_torch.state import modelcheck as mc

    g = torch.Generator(device=dev).manual_seed(0)
    w = init_params(g).tensors()
    x = torch.rand(64, 16, 5, generator=g, device=dev)
    y = (torch.rand(64, generator=g, device=dev) > 0.5).float()
    cfg = mc.CONFIGS["deaths3"]
    vs = torch.from_numpy(ma.encode_world(ma._boot(cfg, ma.Mutations()),
                                          cfg))[None].to(dev)
    knobs = torch.from_numpy(ma.make_knobs(cfg)).to(dev)
    ch, _vi, en = mc_step.mc_step(vs, knobs, 3)
    flat, valid = ch.view(-1, ch.shape[-1]), en.reshape(-1)
    keys = mc_dedup.mc_sort_keys(flat, valid)
    skeys, order = mc_sort.mc_sort(keys)
    big = torch.randint(0, 2**33, (mc_sort.CLUSTER * mc_sort.TILE + 1,),
                        generator=g, device=dev)
    partials = mlp_train.mlp_train_partials(x, y, *w)
    return {
        "K1": lambda: mlp_forward.mlp_forward(x, *w),
        "K2a": lambda: mlp_train.mlp_train_partials(x, y, *w),
        "K2b": lambda: mlp_train.mlp_sgd_apply(partials, 1 / 64, w, 0.05),
        "K4": lambda: synthetic_batch.synthetic_windows(
            synthetic_draws(g, 64, dev)),
        "K5": lambda: mc_step.mc_step(vs, knobs, 3),
        "K6": lambda: mc_step.mc_liveness(vs, knobs, 3),
        "K7_hash": lambda: mc_dedup.mc_sort_keys(flat, valid),
        "K7_sort": lambda: mc_sort.mc_sort(keys),
        "K7_sort_tiles": lambda: mc_sort.mc_sort(big),
        "K7_keep": lambda: mc_dedup.mc_keep(flat, skeys, order),
    }


@pytest.mark.cuda
def test_a_launch_keeps_the_current_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = torch.cuda.device_count()
    before = torch.cuda.current_device()
    try:
        for card in range(n):
            dev = torch.device("cuda", card)
            current = (card + 1) % n     # another card where there is one
            torch.cuda.set_device(current)
            launches = _launches(dev)
            torch.cuda.set_device(current)
            for name, launch in launches.items():
                launch()
                assert torch.cuda.current_device() == current, (name, card)
            torch.cuda.synchronize(dev)
    finally:
        torch.cuda.set_device(before)
