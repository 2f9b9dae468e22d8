"""The hand-written CUDA RG-LRU backward (``csrc/rglru_bwd.cu``) against
autograd through the plain version (``rglru_blocked``) on the card: at
recurrentgemma-9b's train width (D=4096), ragged, from an initial state
with ``dh_last`` given, strided inputs, and lanes with a = 1 exactly
(where the gate's slope is 0); through the op's autograd formula, each
call one launch; and two runs bitwise equal.

These tests need a Hopper card (compute capability 9.0 or above) and
``nvcc``; elsewhere they skip.  Whether there is such a card is decided in
the ``hopper`` fixture, never at import, so every test worker collects
the same tests.  Run them on the card with ``PYTHONPATH=src python -m
pytest -q --noconftest -m gpu tests/test_torch_rglru_bwd_gpu.py``.

Tolerance: each gradient's max abs error within 1e-4 of its largest
|value| (fp32: the kernel walks the steps, the plain version sums in
16-step log-space blocks).
"""
import pytest
import torch

from repro_torch.kernels.rglru import kernel as rk
from repro_torch.kernels.rglru.ops import rglru
from repro_torch.kernels.rglru.ref import rglru_blocked

pytestmark = pytest.mark.gpu

TOL = 1e-4


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability 9.0 or above (sm_90a)")
    return torch.device("cuda", 0)


def _check(dev, B, S, D, strided=False):
    g = torch.Generator().manual_seed(0)
    if strided:   # x and a as slices of wider rows
        buf = torch.randn(B, S, 2 * D + 7, generator=g)
        x, a = buf[..., :D], torch.sigmoid(buf * 2)[..., D:2 * D]
    else:
        x = torch.randn(B, S, D, generator=g)
        a = torch.sigmoid(torch.randn(B, S, D, generator=g) * 2)
    a = a.clone()
    a[..., : D // 8] = 1.0
    h0, dl = torch.randn(B, D, generator=g), torch.randn(B, D, generator=g)
    dh = torch.randn(B, S, D, generator=g)
    ins = [t.to(dev) for t in (x, a, h0)]
    dh, dl = dh.to(dev), dl.to(dev)
    got = [t.clone().requires_grad_() for t in ins]
    want = [t.clone().requires_grad_() for t in ins]
    before = rk.rglru_bwd_cuda.launches
    torch.autograd.backward(rglru(*got), (dh, dl))
    torch.cuda.synchronize()
    assert rk.rglru_bwd_cuda.launches == before + 1
    h = rglru_blocked(*want)
    torch.autograd.backward((h, h[:, -1]), (dh, dl))
    for name, a_, w in zip(("dx", "da", "dinit"), got, want):
        err = ((a_.grad - w.grad).abs().max() / w.grad.abs().max()).item()
        assert torch.isfinite(a_.grad).all() and err <= TOL, (name, err)
    hk = h.detach().contiguous()
    runs = [rk.rglru_bwd_cuda(ins[0], ins[1], hk, ins[2], dh, dl) for _ in range(2)]
    assert all(torch.equal(a_, b) for a_, b in zip(*runs))


def test_recurrentgemma_train_shape(hopper):
    _check(hopper, 1, 2048, 4096)


@pytest.mark.parametrize("B,S,D,strided", [(1, 2000, 4096, False), (3, 37, 300, True),
                                           (2, 1, 64, False), (2, 130, 100, True)])
def test_shapes(hopper, B, S, D, strided):
    _check(hopper, B, S, D, strided)
