"""The fused-MLP CUDA kernel against its plain PyTorch version, on the card.

Every test here needs an NVIDIA card (marked ``cuda``) and skips elsewhere.
The file imports no JAX, so on a machine with the card but without JAX it
runs without the repository's conftest:

    python -m pytest tests/test_torch_kernel_cuda.py --noconftest -q -m cuda

Tolerance: both sides are f32 with TF32 off; only the order of the sums
differs, so the error stays within a few K * 2^-24 of the output scale:
1e-4 relative to max|plain| + 1.
"""
import numpy as np
import pytest
import torch

from sdfstudio_tpu_torch.ops import fused_mlp as fm

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dims, n, device, seed=0):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    x = t(rng.standard_normal((n, dims[0])))
    ws = [t(rng.standard_normal((a, b)) / np.sqrt(a)) for a, b in zip(dims[:-1], dims[1:])]
    bs = [t(0.1 * rng.standard_normal(b)) for b in dims[1:]]
    return x, ws, bs


@pytest.mark.parametrize(
    "dims,n",
    [
        ([39, 128, 128, 1], 262144),  # proposal 0 of a render chunk
        ([51, 128, 128, 1], 98304),  # proposal 1
        ([321, 256, 256, 3], 49152),  # color
        ([3, 9, 130, 8], 65),  # ragged rows, a 9-wide tiled layer, an 8-wide head
        ([17, 257, 5, 300, 1], 1),  # a narrow hidden layer between tiled ones
    ],
)
@pytest.mark.parametrize("act,out_act", [("relu", "none"), ("softplus100", "relu"), ("none", "softplus100")])
def test_kernel_matches_plain(card, dims, n, act, out_act):
    x, ws, bs = _case(dims, n, card)
    before = fm.LAUNCHES["fused_mlp_fwd"]
    y = fm.fused_mlp(x, ws, bs, act, out_act)
    ref = fm.fused_mlp_plain(x, ws, bs, act, out_act)
    torch.cuda.synchronize()
    assert fm.LAUNCHES["fused_mlp_fwd"] == before + 1
    assert y.shape == (n, dims[-1])
    assert float((y - ref).abs().max()) / (float(ref.abs().max()) + 1.0) <= 1e-4


def test_kernel_refuses_what_it_cannot_take(card):
    x, ws, bs = _case([8, 16, 2], 10, card)
    with pytest.raises(ValueError, match="float32"):
        fm.fused_mlp(x.double(), [w.double() for w in ws], [b.double() for b in bs])
    with pytest.raises(ValueError, match="contiguous"):
        fm.fused_mlp(x.t().contiguous().t(), ws, bs)
    with pytest.raises(ValueError, match="is on"):
        fm.fused_mlp(x, [ws[0].cpu(), ws[1]], bs)
    with pytest.raises(ValueError, match="shared memory"):
        fm.fused_mlp(*_case([1000, 16, 2], 10, card))
    with pytest.raises(RuntimeError, match="no backward kernel"):
        fm.fused_mlp(x.clone().requires_grad_(True), ws, bs)
    empty = fm.fused_mlp(x[:0], ws, bs)
    assert empty.shape == (0, 2)
