"""train() over several devices: the device count it uses, as the
reference's mesh path picks it (manatee_tpu/health/train.py:160-169),
and k gloo ranks on the CPU against the one-device train().

Measured on the CPU: after 20 steps of 64 with the recorded mix, the
parameters of 2 ranks differ from one device's by at most 3.0e-8 and
those of 4 ranks by 6.0e-8 (fp32 sums over another split of the batch);
the bar is 1e-5.
"""

from pathlib import Path

import pytest
import torch

from manatee_tpu_torch.distributed import run_ranks
from manatee_tpu_torch.health import train as port_train

REPO = Path(__file__).resolve().parent.parent
MIX = [str(p) for d in ("recorded-chaos-r4", "recorded-chaos-s2",
                        "recorded-chaos-s3")
       for p in sorted((REPO / "tests" / "data" / d).glob("*.jsonl"))]
TOL = 1e-5


def _reference_usable(n, batch):
    """manatee_tpu/health/train.py:166-167, as written there."""
    return max(d for d in range(1, n + 1) if batch % d == 0)


@pytest.mark.parametrize("n, batch, want", [
    (8, 256, 8), (8, 63, 7), (4, 255, 3), (8, 101, 1), (1, 256, 1),
    (3, 64, 2), (6, 300, 6)])
def test_usable_device_count_is_the_reference_s(n, batch, want):
    assert port_train.usable_devices(n, batch) == want
    assert _reference_usable(n, batch) == want


@pytest.fixture(scope="module")
def one_device():
    recorded = port_train.recorded_windows(MIX)
    model, loss, acc = port_train.train(steps=20, batch=64,
                                        recorded=recorded, device="cpu")
    return recorded, model, loss, acc


@pytest.mark.parametrize("k", [2, 4])
def test_ranks_on_cpu_end_where_one_device_ends(one_device, k):
    recorded, want, want_loss, want_acc = one_device
    model, loss, acc = port_train.train(steps=20, batch=64,
                                        recorded=recorded,
                                        device=["cpu"] * k)
    gap = max(float((a - b).abs().max())
              for a, b in zip(model.tensors(), want.tensors()))
    assert gap <= TOL and abs(loss - want_loss) <= TOL
    assert acc == want_acc
    assert all(t.device.type == "cpu" for t in model.tensors())


def test_a_batch_no_count_divides_trains_on_one_device(one_device):
    """(8, 101) -> 1: no ranks are started, and the result is the
    one-device path's, bit for bit."""
    recorded = one_device[0]
    a = port_train.train(steps=3, batch=101, recorded=recorded,
                         device=["cpu"] * 8)
    b = port_train.train(steps=3, batch=101, recorded=recorded,
                         device="cpu")
    assert all(torch.equal(x, y)
               for x, y in zip(a[0].tensors(), b[0].tensors()))
    assert a[1:] == b[1:]


def test_a_repeated_card_raises(monkeypatch):
    """NCCL puts one rank on a card: a list that repeats one raises
    before any rank starts, in train() and in run_ranks."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="repeats"):
        port_train.train(steps=1, batch=64, device=["cuda:1", "cuda:1"])
    with pytest.raises(ValueError, match="repeats"):
        run_ranks(port_train._train_rank, 2, ["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="2 ranks, 1 devices"):
        run_ranks(port_train._train_rank, 2, ["cuda:0"])
