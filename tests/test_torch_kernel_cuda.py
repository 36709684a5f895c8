"""The CUDA kernels against their plain PyTorch versions, on the card: the
fused MLP, forward and backward, the row gathers ``take`` and ``loop``, and
the hash-grid encode, forward and table gradient (F = 2, 4 and 8; by
atomics and by the deterministic segment sum), and its gradient in ``x``.

Every test here needs an NVIDIA card (marked ``cuda``) and skips elsewhere.
The file imports no JAX, so on a machine with the card but without JAX it
runs without the repository's conftest:

    python -m pytest tests/test_torch_kernel_cuda.py --noconftest -m cuda

Tolerance: the plain side is f32 with TF32 off; the kernels take every
product in 3xTF32 (three tf32 tensor-core passes of operands split into hi
and lo, ~21 bits each), so the error stays within a few K * 2^-22 of the
output scale: 1e-4 relative to max|plain| + 1 (``chip_smoke.py``'s
KERNEL_TOL), and 1e-4 for the backward (BWD_TOL). A gather is a copy: the
row gathers must equal their plain versions exactly, NaN rows included.
The hash-grid forward adds 8 products a level in another order than the
plain version's batched product: 1e-6 of max |plain| (HASH_FWD_TOL). Its
backward adds up to ~10^5 updates into a coarse row with atomics, in an
order that changes from run to run (the plain ``index_add_`` on the card
uses atomics too): 1e-5 in relative Frobenius norm (HASH_BWD_TOL).
"""
import numpy as np
import pytest
import torch

from sdfstudio_tpu_torch.ops import fused_mlp as fm
from sdfstudio_tpu_torch.ops import hash_grid as hg
from sdfstudio_tpu_torch.ops import row_gather as rg
from sdfstudio_tpu_torch.ops.encodings import HashEncoding

pytestmark = pytest.mark.cuda

KERNEL_TOL = 1e-4  # chip_smoke.py
BWD_TOL = 1e-4  # chip_smoke.py
HASH_FWD_TOL = 1e-6  # chip_smoke.py
HASH_BWD_TOL = 1e-5  # chip_smoke.py

_ACTS = [("relu", "none"), ("softplus100", "relu"), ("none", "softplus100")]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dims, n, device, seed=0, margin=False):
    """Seeded inputs. With ``margin`` the biases lie in +-[0.5, 1.5] and the
    weights are scaled by 0.1, so no pre-activation comes within ~1e-6 of
    0: the relu derivative jumps there, and a rounding difference between
    two sums could flip it (a real difference of the two paths, not an
    error of either)."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    x = t(rng.standard_normal((n, dims[0])))
    scale = 0.1 if margin else 1.0
    ws = [t(scale * rng.standard_normal((a, b)) / np.sqrt(a)) for a, b in zip(dims[:-1], dims[1:])]
    if margin:
        bs = [t(rng.choice([-1.0, 1.0], b) * rng.uniform(0.5, 1.5, b)) for b in dims[1:]]
    else:
        bs = [t(0.1 * rng.standard_normal(b)) for b in dims[1:]]
    return x, ws, bs


@pytest.mark.parametrize(
    "dims,n",
    [
        ([39, 128, 128, 1], 262144),  # proposal 0 of a render chunk
        ([51, 128, 128, 1], 98304),  # proposal 1
        ([321, 256, 256, 3], 49152),  # color
        ([10, 16, 1], 524288),  # a neus-facto hash proposal net of a train step
        ([3, 9, 130, 8], 65),  # ragged rows, a 9-wide tiled layer, an 8-wide head
        ([17, 257, 5, 300, 1], 1),  # a narrow hidden layer between tiled ones
        # the NeRF baselines' chains at a train step's rows
        ([283, 128, 128], 196608),  # vanilla-nerf's / mipnerf's mlp_head (relu out)
        ([84, 256, 256, 256, 3], 65536),  # dnerf's temporal distortion
        ([150, 128, 128], 51200),  # tensorf's mlp_head (relu out)
        ([31, 64, 64], 196608),  # semantic-nerfw's transient MLP
        ([15, 64, 64], 196608),  # semantic-nerfw's semantic MLP
    ],
)
@pytest.mark.parametrize("act,out_act", _ACTS)
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
    with pytest.raises(ValueError, match="shared memory"):
        fm.fused_mlp_bwd(*_case([1000, 16, 2], 10, card), torch.zeros(10, 2, device=card))
    # a hidden layer's accumulators must fit five 64-column tiles
    with pytest.raises(ValueError, match="limit of 320"):
        fm.fused_mlp(*_case([8, 321, 2], 10, card))
    with pytest.raises(ValueError, match="limit of 320"):
        fm.fused_mlp_bwd(*_case([8, 321, 2], 10, card), torch.zeros(10, 2, device=card))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fm.fused_mlp_bwd(x.cpu(), [w.cpu() for w in ws], [b.cpu() for b in bs],
                         torch.zeros(10, 2))
    empty = fm.fused_mlp(x[:0], ws, bs)
    assert empty.shape == (0, 2)


# the three calls of a 2048-ray training step, with the slice's activations
# and dx need (the proposal nets' input needs no gradient), then odd shapes
# under every activation, with and without dx
_BWD_CASES = [
    ([39, 128, 128, 1], 524288, "relu", "none", False),  # proposal 0
    ([51, 128, 128, 1], 196608, "relu", "none", False),  # proposal 1
    ([321, 256, 256, 3], 98304, "relu", "none", True),  # color
    ([10, 16, 1], 524288, "relu", "none", False),  # neus-facto's hash proposal 0
    # the NeRF baselines' chains with their train steps' activations and dx need
    ([283, 128, 128], 196608, "relu", "relu", True),  # vanilla-nerf's mlp_head
    ([84, 256, 256, 256, 3], 65536, "relu", "none", False),  # dnerf's temporal distortion
    ([150, 128, 128], 51200, "relu", "relu", True),  # tensorf's mlp_head
    ([31, 64, 64], 196608, "relu", "none", True),  # semantic-nerfw's transient MLP
    ([15, 64, 64], 196608, "relu", "none", False),  # semantic-nerfw's semantic MLP
] + [
    (dims, n, act, out_act, need_dx)
    for dims, n in [
        ([3, 9, 130, 8], 65),  # ragged rows, a 9-wide tiled layer, an 8-wide head
        ([17, 257, 5, 300, 1], 1),  # one row, a narrow hidden layer between tiled ones
        ([7, 9], 1000),  # one layer: dx straight from g
        ([130, 20, 6], 300),  # a narrow head after a ragged tile
        ([321, 256, 256, 3], 5000),  # the color widths over a few splits
    ]
    for act, out_act in _ACTS
    for need_dx in (True, False)
]


@pytest.mark.parametrize("dims,n,act,out_act,need_dx", _BWD_CASES)
def test_bwd_kernel_matches_plain(card, dims, n, act, out_act, need_dx):
    """The backward kernel against ``fused_mlp_bwd_plain`` run in float64 on
    the same inputs: only the kernel's own f32 rounding is left, and its
    split-K sums over at most a few thousand rows stay within 1e-4 of each
    output's scale (max |reference| + 1e-6). The inputs keep every
    pre-activation away from the relu's jump (``_case(margin=True)``)."""
    x, ws, bs = _case(dims, n, card, margin=True)
    g = torch.from_numpy(np.random.default_rng(1).standard_normal((n, dims[-1])).astype(np.float32)).to(card)
    before = fm.LAUNCHES["fused_mlp_bwd"]
    dx, dws, dbs = fm.fused_mlp_bwd(x, ws, bs, g, act, out_act, need_dx)
    rdx, rdws, rdbs = fm.fused_mlp_bwd_plain(x.double(), [w.double() for w in ws],
                                             [b.double() for b in bs], g.double(), act, out_act,
                                             need_dx)
    torch.cuda.synchronize()
    assert fm.LAUNCHES["fused_mlp_bwd"] == before + 1
    assert (dx is None) == (not need_dx)
    pairs = list(zip(dws, rdws)) + list(zip(dbs, rdbs)) + ([(dx, rdx)] if need_dx else [])
    for got, ref in pairs:
        assert got.shape == ref.shape and got.dtype == torch.float32
        err = float((got.double() - ref).abs().max())
        assert err / (float(ref.abs().max()) + 1e-6) <= 1e-4


def test_fused_mlp_autograd_wiring(card):
    """Gradients through the autograd node (forward and backward kernels)
    against autograd through the plain version, both f32 on the card
    (1e-4 relative, as above), and ``torch.autograd.gradcheck`` in float32
    on a linear chain, where central differences with step 1e-2 are exact
    up to rounding: f32 rounding of outputs of size ~10 over 2e-2 gives
    ~1e-4, so atol and rtol are 1e-3."""
    x, ws, bs = _case([13, 40, 7, 3], 37, card, margin=True)
    x = x.reshape(37, 1, 13)
    params = [t.clone().requires_grad_(True) for t in (x, *ws, *bs)]
    c = torch.randn(37, 1, 3, device=card, generator=torch.Generator(device=card).manual_seed(0))
    before = dict(fm.LAUNCHES)
    y = fm.fused_mlp(params[0], params[1:4], params[4:], "softplus100", "relu")
    grads = torch.autograd.grad((y * c).sum(), params)
    assert fm.LAUNCHES["fused_mlp_fwd"] == before["fused_mlp_fwd"] + 1
    assert fm.LAUNCHES["fused_mlp_bwd"] == before["fused_mlp_bwd"] + 1
    ref_params = [t.detach().clone().requires_grad_(True) for t in params]
    y_ref = fm.fused_mlp_plain(ref_params[0], ref_params[1:4], ref_params[4:], "softplus100", "relu")
    ref = torch.autograd.grad((y_ref * c).sum(), ref_params)
    for got, want in zip(grads, ref):
        assert got.shape == want.shape
        assert float((got - want).abs().max()) / (float(want.abs().max()) + 1e-6) <= 1e-4
    # no gradient for x: the kernel skips dx
    y2 = fm.fused_mlp(x.reshape(37, 13), params[1:4], params[4:], "relu")
    g2 = torch.autograd.grad(y2.sum(), params[1])[0]
    assert g2.shape == ws[0].shape
    xs, wsl, bsl = _case([5, 6, 2], 4, card)
    inputs = tuple(t.clone().requires_grad_(True) for t in (xs, *wsl, *bsl))
    assert torch.autograd.gradcheck(
        lambda a, w0, w1, b0, b1: fm.fused_mlp(a, [w0, w1], [b0, b1], "none", "none"),
        inputs, eps=1e-2, atol=1e-3, rtol=1e-3)


# the edges of the tiling: rows around the 64-row warpgroup and 128-row
# block, the p8 input widths (39, 51, 321) and one that is not a multiple
# of 8 (45), heads of 1 and 3 columns, every activation
_EDGE_ROWS = [0, 1, 63, 64, 65, 127, 1000]
_EDGE_NETS = [
    ([39, 128, 128, 1], "relu", "none"),
    ([51, 128, 128, 1], "softplus100", "relu"),
    ([321, 256, 256, 3], "none", "softplus100"),
    ([45, 72, 3], "relu", "softplus100"),
]


@pytest.mark.parametrize("n", _EDGE_ROWS)
@pytest.mark.parametrize("dims,act,out_act", _EDGE_NETS)
def test_kernel_tiling_edges(card, dims, act, out_act, n):
    x, ws, bs = _case(dims, n, card, seed=n)
    before = fm.LAUNCHES["fused_mlp_fwd"]
    y = fm.fused_mlp(x, ws, bs, act, out_act)
    ref = fm.fused_mlp_plain(x, ws, bs, act, out_act)
    torch.cuda.synchronize()
    assert fm.LAUNCHES["fused_mlp_fwd"] == before + (1 if n else 0)
    assert y.shape == (n, dims[-1])
    if n:
        assert float((y - ref).abs().max()) / (float(ref.abs().max()) + 1.0) <= KERNEL_TOL


@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("n", _EDGE_ROWS)
@pytest.mark.parametrize("dims,act,out_act", _EDGE_NETS)
def test_bwd_kernel_tiling_edges(card, dims, act, out_act, n, need_dx):
    """As test_bwd_kernel_matches_plain, at the tiling's edges."""
    x, ws, bs = _case(dims, n, card, seed=n, margin=True)
    g = torch.from_numpy(np.random.default_rng(n + 1).standard_normal((n, dims[-1])).astype(np.float32)).to(card)
    before = fm.LAUNCHES["fused_mlp_bwd"]
    dx, dws, dbs = fm.fused_mlp_bwd(x, ws, bs, g, act, out_act, need_dx)
    rdx, rdws, rdbs = fm.fused_mlp_bwd_plain(x.double(), [w.double() for w in ws],
                                             [b.double() for b in bs], g.double(), act, out_act,
                                             need_dx)
    torch.cuda.synchronize()
    assert fm.LAUNCHES["fused_mlp_bwd"] == before + (1 if n else 0)
    assert (dx is None) == (not need_dx)
    pairs = list(zip(dws, rdws)) + list(zip(dbs, rdbs)) + ([(dx, rdx)] if need_dx else [])
    for got, ref in pairs:
        assert got.shape == ref.shape and got.dtype == torch.float32
        if ref.numel():  # dx of no rows is empty
            err = float((got.double() - ref).abs().max())
            assert err / (float(ref.abs().max()) + 1e-6) <= BWD_TOL


def test_bwd_kernel_repeats_bit_for_bit(card):
    """A fixed split count and a fixed reduction order, no atomics: two calls
    on the same inputs give the same bits of dx, every dW and every db."""
    x, ws, bs = _case([321, 256, 256, 3], 5000, card)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal((5000, 3)).astype(np.float32)).to(card)
    first = fm.fused_mlp_bwd(x, ws, bs, g, "relu", "none", True)
    second = fm.fused_mlp_bwd(x, ws, bs, g, "relu", "none", True)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    for a_, b_ in zip(first[1] + first[2], second[1] + second[2]):
        assert torch.equal(a_, b_)


def _rel_fro(a, b):
    return float(torch.linalg.vector_norm(a - b)) / max(float(torch.linalg.vector_norm(b)), 1e-30)


def test_color_net_matches_plain_at_smoke_tolerances(card):
    """The color net (321 -> 256 -> 256 -> 3) at the main path's exact shapes
    against the plain versions in f32 on the card, with ``chip_smoke.py``'s
    measures: the forward of a 1024-ray render chunk (49,152 rows) within
    KERNEL_TOL of max |plain| + 1, the backward of a 2048-ray train step
    (98,304 rows, dx needed) within BWD_TOL in relative Frobenius norm, on
    inputs that keep the relu's jump away (``_case(margin=True)``): a random
    init puts ~50 of these 5e7 pre-activations within rounding of 0, and
    each one the two sides round across moves its row's delta by its full
    value, ~1e-3 of the norm."""
    x, ws, bs = _case([321, 256, 256, 3], 98304, card, seed=5)
    y = fm.fused_mlp(x[:49152], ws, bs, "relu", "none")
    ref = fm.fused_mlp_plain(x[:49152], ws, bs, "relu", "none")
    assert float((y - ref).abs().max()) / (float(ref.abs().max()) + 1.0) <= KERNEL_TOL
    x, ws, bs = _case([321, 256, 256, 3], 98304, card, seed=5, margin=True)
    g = torch.from_numpy(np.random.default_rng(6).standard_normal((98304, 3)).astype(np.float32)).to(card)
    kern = fm.fused_mlp_bwd(x, ws, bs, g, "relu", "none", True)
    plain = fm.fused_mlp_bwd_plain(x, ws, bs, g, "relu", "none", True)
    torch.cuda.synchronize()
    for got, want in zip([kern[0], *kern[1], *kern[2]], [plain[0], *plain[1], *plain[2]]):
        assert _rel_fro(got, want) <= BWD_TOL


# (kernel, R, F, M): the probes' shapes, p8's table, odd row counts, F in
# {1, 2, 3, 4}, tables in shared memory and through L2
_GATHER_CASES = [
    ("take", 1 << 14, 2, 4_194_304),  # pl-take, a table that L1 holds
    ("take", 1 << 19, 2, 4_194_304),  # pl-take, through L2
    ("take", 2_841_000, 4, 3_145_728),  # p8's permutohedral table, one train step's gathers
    ("take", 1000, 1, 1001),
    ("take", 12_000, 4, 12_345),  # 192 KB, float4 rows
    ("take", 50_000, 4, 777),  # 800 KB, through L2
    ("take", 100, 3, 999),
    ("take", 3, 2, 5),
    ("loop", 1 << 14, 2, 1 << 20),  # pl-loop
    ("loop", 1000, 1, 1001),
    ("loop", 12_000, 4, 12_345),
    ("loop", 100, 3, 999),
    ("loop", 3, 2, 5),
    ("take", 100_000, 8, 4099),  # F = 8: two float4 a row, through L2
    ("take", 5000, 8, 4099),  # F = 8, a table in L1
    ("loop", 5000, 8, 4099),
    ("loop", 1000, 2, 2_000_003),  # more tiles than one round of the card's blocks
]


def _gather_case(R, F, M, device, seed=0):
    """A random table and indices in [0, R], with R, 0 and R-1 among them."""
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.standard_normal((R, F)).astype(np.float32)).to(device)
    idx = rng.integers(0, R + 1, M).astype(np.int32)
    idx[: min(M, 3)] = [R, 0, R - 1][: min(M, 3)]
    return table, torch.from_numpy(idx).to(device)


@pytest.mark.parametrize("kind,R,F,M", _GATHER_CASES)
@pytest.mark.parametrize("offset", [0, 1])
def test_row_gather_kernel_matches_plain(card, kind, R, F, M, offset):
    """``offset`` 1 shifts the table by one float, so no row is aligned for
    a vector load and the kernel takes its scalar path."""
    table, idx = _gather_case(R, F, M, card)
    if offset:
        buf = torch.empty(R * F + 1, device=card)
        buf[1:] = table.reshape(-1)
        table = buf[1:].view(R, F)
    kern, plain = (rg.take, rg.take_plain) if kind == "take" else (rg.loop, rg.loop_plain)
    before = rg.LAUNCHES[f"row_gather_{kind}"]
    got = kern(table, idx)
    want = plain(table, idx)
    torch.cuda.synchronize()
    assert rg.LAUNCHES[f"row_gather_{kind}"] == before + 1
    assert got.shape == (M, F) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert bool(torch.isnan(got).any()) == (kind == "take")


def _batch(F):
    from sdfstudio_tpu_torch.utils.cuda_build import load_library

    return load_library().sst_row_gather_take_rows(F)


# M around the rows a ``take`` thread owns (B, from the library: four
# 16-byte slots), which a ``loop`` walker owns too
_BATCH_ROWS = {"1": lambda b: 1, "B-1": lambda b: b - 1, "B": lambda b: b, "B+1": lambda b: b + 1,
               "5B+3": lambda b: 5 * b + 3, "1024B+3": lambda b: 1024 * b + 3}


@pytest.mark.parametrize("kind", ["take", "loop"])
@pytest.mark.parametrize("m", list(_BATCH_ROWS))
@pytest.mark.parametrize("F", [1, 2, 4])
@pytest.mark.parametrize("idx_offset", [0, 1])
def test_row_gather_batch_edges(card, kind, m, F, idx_offset):
    """Row counts that end inside a batch, indices R and -1 as the last row
    of one batch and the first of the next, and (``idx_offset`` 1) an index
    tensor that starts 4 bytes past a 16-byte boundary, so its loads cannot
    be 16-byte vectors and a bulk copy of it cannot start at its start."""
    B = _batch(F)
    M, R = _BATCH_ROWS[m](B), 1000
    table, idx = _gather_case(R, F, M, card, seed=M)
    for j, v in ((B - 1, R), (B, -1), (2 * B - 1, -1), (2 * B, R)):
        if j < M:
            idx[j] = v
    if idx_offset:
        buf = torch.empty(M + 4, dtype=torch.int32, device=card)
        buf[1:M + 1] = idx
        idx = buf[1:M + 1]
        assert idx.data_ptr() % 16 == 4
    kern, plain = (rg.take, rg.take_plain) if kind == "take" else (rg.loop, rg.loop_plain)
    before = rg.LAUNCHES[f"row_gather_{kind}"]
    got = kern(table, idx)
    want = plain(table, idx)
    torch.cuda.synchronize()
    assert rg.LAUNCHES[f"row_gather_{kind}"] == before + 1
    assert got.shape == (M, F)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def test_row_gather_at_the_shared_memory_limits(card):
    """``take`` at tables of the card's shared-memory limit per block and
    one row over it (both read through L1 and L2; a table that size would
    no longer fit a block if it were staged), and ``loop`` at a table whose
    bytes and a round's indices fill that limit exactly; one row more is
    refused."""
    from sdfstudio_tpu_torch.utils.cuda_build import load_library

    lib = load_library()
    limit, F = lib.sst_row_gather_smem_limit(), 2
    for R in (limit // (4 * F), limit // (4 * F) + 1):
        table, idx = _gather_case(R, F, 100_003, card, seed=R)
        torch.testing.assert_close(rg.take(table, idx), rg.take_plain(table, idx), rtol=0, atol=0,
                                   equal_nan=True)
    R = (limit - lib.sst_row_gather_loop_smem_bytes(0, F)) // (4 * F)
    assert lib.sst_row_gather_loop_smem_bytes(R, F) == limit
    table, idx = _gather_case(R, F, 100_003, card, seed=R)
    torch.testing.assert_close(rg.loop(table, idx), rg.loop_plain(table, idx), rtol=0, atol=0)
    before = dict(rg.LAUNCHES)
    table, idx = _gather_case(R + 1, F, 10, card)
    with pytest.raises(ValueError, match="shared memory"):
        rg.loop(table, idx)
    assert rg.LAUNCHES == before


def test_row_gather_refuses_what_it_cannot_take(card):
    table, idx = _gather_case(64, 2, 10, card)
    for fn in (rg.take, rg.loop):
        with pytest.raises(ValueError, match="float32 table and int32"):
            fn(table.double(), idx)
        with pytest.raises(ValueError, match="float32 table and int32"):
            fn(table, idx.long())
        with pytest.raises(ValueError, match="contiguous"):
            fn(table.t().contiguous().t(), idx)
        with pytest.raises(ValueError, match="is on"):
            fn(table, idx.cpu())
        with pytest.raises(ValueError, match="table \\[R, F\\] and idx \\[M\\]"):
            fn(table.reshape(-1), idx)
    before = dict(rg.LAUNCHES)
    assert rg.take(table, idx[:0]).shape == (0, 2) and rg.LAUNCHES == before
    # the loop kernel keeps its table in shared memory: 2^16 x 1 floats + the
    # tile's indices exceed the 227 KB a block may use
    big, big_idx = _gather_case(1 << 16, 1, 10, card)
    with pytest.raises(ValueError, match="shared memory"):
        rg.loop(big, big_idx)
    assert rg.LAUNCHES == before
    torch.testing.assert_close(rg.take(big, big_idx), rg.take_plain(big, big_idx), rtol=0, atol=0,
                               equal_nan=True)


# ---- the hash-grid encode ------------------------------------------------------

# (grid, points, jacobian): neus-facto's SDF grid at a train step's points,
# its two proposal grids at theirs, and an all-dense grid whose far corner
# at x = 1.0 reads past the table (NaN rows, dropped gradients)
_HASH_GRIDS = {
    "sdf": dict(num_levels=16, min_res=16, max_res=2048, log2_hashmap_size=19, smoothstep=True),
    "proposal_64": dict(num_levels=5, min_res=16, max_res=64, log2_hashmap_size=17),
    "proposal_256": dict(num_levels=5, min_res=16, max_res=256, log2_hashmap_size=17),
    # the density methods' field (nerfacto, phototourism, instant-ngp): L16 x F2, 2^19 rows, 16-1024
    "nerfacto": dict(num_levels=16, min_res=16, max_res=1024, log2_hashmap_size=19),
    "dense": dict(num_levels=3, min_res=2, max_res=8, log2_hashmap_size=10, smoothstep=True),
    # neus-facto-tpu's SDF grid (L8 x F4, 2^19 rows, 16-512), and an all-dense F = 4 grid
    "tpu_f4": dict(num_levels=8, min_res=16, max_res=512, log2_hashmap_size=19,
                   features_per_level=4, smoothstep=True),
    "dense_f4": dict(num_levels=3, min_res=2, max_res=8, log2_hashmap_size=10,
                     features_per_level=4, smoothstep=True),
    # Neuralangelo's grid (L16 x F8, 2^22 rows a level, 64-4096, linear
    # weights: 55,867,118 rows, 1.79 GB), the same levels at 2^19, and an
    # all-dense F = 8 grid
    "angelo": dict(num_levels=16, min_res=64, max_res=4096, log2_hashmap_size=22,
                   features_per_level=8, smoothstep=False),
    "f8": dict(num_levels=16, min_res=64, max_res=4096, log2_hashmap_size=19,
               features_per_level=8, smoothstep=False),
    "dense_f8": dict(num_levels=3, min_res=2, max_res=8, log2_hashmap_size=10,
                     features_per_level=8, smoothstep=False),
}
_HASH_CASES = [("sdf", 98304, True), ("proposal_64", 524288, False),
               ("proposal_256", 196608, False), ("dense", 4099, True),
               ("angelo", 65536, False), ("angelo", 65536, True), ("dense_f8", 4099, True)]


def row_table(rows, F, device):
    """A table whose values identify their row: a corner read from the wrong
    row is off by O(1), not by noise."""
    k = torch.arange(rows * F, dtype=torch.int64, device=device)
    return (((k * 2654435761) % (1 << 24)).to(torch.float32) / (1 << 23) - 1.0).reshape(rows, F)


def _hash_points(n, device, seed=0):
    """Uniform points in [0, 1]^3 with 0, exactly 1.0 and cell faces among them."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    edges = np.array([[0, 0, 0], [1, 1, 1], [1, 0.5, 0.25], [0.125, 1, 0.5], [0.5, 0.5, 1]],
                     np.float32)
    x[:min(n, len(edges))] = edges[:n]
    return torch.from_numpy(x).to(device)


def _rel_max(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _ray_points(n, per_ray, device, seed=0):
    """Points in ray order, as a step's samples come: ``per_ray`` sorted
    samples along each seeded ray through [0, 1]^3, clipped to the cube."""
    rng = np.random.default_rng(seed)
    rays = -(-n // per_ray)
    o = rng.uniform(0.2, 0.8, (rays, 1, 3))
    d = rng.standard_normal((rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(-0.4, 0.4, (rays, per_ray, 1)), axis=1)
    x = np.clip(o + t * d, 0.0, 1.0).reshape(-1, 3)[:n].astype(np.float32)
    return torch.from_numpy(x).to(device)


def _check_hash(enc, x, want_jac, device, seed=1):
    spec, R, F = enc.spec, enc.total_rows, enc.features_per_level
    table = row_table(R, F, device)
    before = dict(hg.LAUNCHES)
    got = hg.hash_encode_fwd(x, table, spec, want_jac)
    want = hg.hash_encode_plain(x, table, spec, want_jac)
    got, want = (got, want) if want_jac else ((got,), (want,))
    rng = np.random.default_rng(seed)
    cot = [torch.from_numpy(rng.standard_normal(tuple(w.shape)).astype(np.float32)).to(device)
           for w in want]
    g_out, g_jac = cot[0], (cot[1] if want_jac else None)
    grad = hg.hash_encode_bwd(x, g_out, g_jac, spec, R)
    ref = hg.hash_encode_bwd_plain(x, g_out, g_jac, spec, R)
    torch.cuda.synchronize()
    n = x.shape[0]
    assert hg.LAUNCHES["hash_encode_fwd"] == before["hash_encode_fwd"] + (1 if n else 0)
    assert hg.LAUNCHES["hash_encode_bwd"] == before["hash_encode_bwd"] + (1 if n else 0)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        if n:
            assert _rel_max(torch.nan_to_num(a), torch.nan_to_num(b)) <= HASH_FWD_TOL
    assert grad.shape == (R, F) and bool(torch.isfinite(grad).all())
    if n:
        assert _rel_fro(grad, ref) <= HASH_BWD_TOL
    return got


@pytest.mark.parametrize("grid,n,want_jac", _HASH_CASES)
def test_hash_encode_kernels_match_plain(card, grid, n, want_jac):
    enc = HashEncoding(**_HASH_GRIDS[grid])
    out = _check_hash(enc, _hash_points(n, card), want_jac, card)
    # the far corner of x = 1.0 reads past the all-dense table: NaN there only
    assert bool(torch.isnan(out[0]).any()) == grid.startswith("dense")


@pytest.mark.parametrize("n", [0, 1, 127])
@pytest.mark.parametrize("grid", ["sdf", "proposal_64", "dense", "tpu_f4", "f8"])
def test_hash_encode_batch_edges(card, grid, n):
    enc = HashEncoding(**_HASH_GRIDS[grid])
    _check_hash(enc, _hash_points(n, card, seed=n), True, card, seed=n)


@pytest.mark.parametrize("per_ray", [48, 96, 256])
@pytest.mark.parametrize("grid,n,want_jac", [("sdf", 98304, True), ("proposal_64", 524288, False),
                                             ("tpu_f4", 98304, True), ("dense_f4", 4099, True),
                                             ("f8", 458752, False), ("f8", 98304, True)])
def test_hash_encode_kernels_on_ray_ordered_points(card, grid, n, want_jac, per_ray):
    """A step's samples come in ray order: runs of lanes share the coarse
    cells (the backward's warp aggregation) at F = 2, 4 and 8."""
    enc = HashEncoding(**_HASH_GRIDS[grid])
    _check_hash(enc, _ray_points(n, per_ray, card, seed=per_ray), want_jac, card)


def test_hash_encode_f4_uniform_and_nan_past_the_table(card):
    """F = 4 (float4 rows) at neus-facto-tpu's grid on uniform points, and
    an all-dense F = 4 grid whose far corner at x = 1.0 reads past the
    table: NaN there, the gradient dropped."""
    out = _check_hash(HashEncoding(**_HASH_GRIDS["tpu_f4"]), _hash_points(98304, card), True, card)
    assert not bool(torch.isnan(out[0]).any())
    out = _check_hash(HashEncoding(**_HASH_GRIDS["dense_f4"]), _hash_points(4099, card), True, card)
    assert bool(torch.isnan(out[0][1]).any()) and not bool(torch.isnan(out[0][0]).any())


@pytest.mark.parametrize("grid", ["sdf", "dense", "f8", "dense_f8", "tpu_f4"])
def test_hash_encode_outside_the_cube(card, grid):
    """Points up to 1/32 outside [0, 1]^3 on every side, as a numerical
    gradient's taps past a face: below 0 a dense level's corner at -1 is a
    negative int32 index, read from the table's end (and its update added
    there), past 1 it reads the next level's rows. Both kernels hold the
    plain version, and both kinds of index occur."""
    enc = HashEncoding(**_HASH_GRIDS[grid])
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.uniform(-1 / 32, 1 + 1 / 32, (8192, 3)).astype(np.float32)).to(card)
    _check_hash(enc, x, True, card)
    idx, _ = hg.corner_indices(x, enc.spec)
    assert bool((idx >= 2**31).any()) and bool((idx < enc.total_rows).any())


@pytest.mark.parametrize("grid", ["sdf", "dense"])
def test_hash_encode_paired_corners_even_and_odd_cx(card, grid):
    """Points whose cell corner on x is even at every level and points whose
    is odd: the paired 16-byte loads and reductions (rows i, i ^ 1 of a
    hashed level, i, i + 1 of a dense one, when they form an aligned pair)
    and the unpaired ones both hold the plain version, and both occur."""
    enc = HashEncoding(**_HASH_GRIDS[grid])
    spec = enc.spec
    rng = np.random.default_rng(11)
    base = rng.uniform(0.05, 0.95, (2048, 3)).astype(np.float32)
    res = np.asarray(spec.resolutions, np.float32)
    for parity in (0, 1):
        x = base.copy()
        # the finest level sets the cell: even or odd cx there, and at the coarser levels whatever follows
        c = np.floor(x[:, 0] * res[-1])
        c = np.where(c % 2 == parity, c, c + 1)
        x[:, 0] = np.clip((c + 0.5) / res[-1], 0.0, 1.0)
        xt = torch.from_numpy(x).to(card)
        _check_hash(enc, xt, True, card, seed=parity)
        idx, _ = hg.corner_indices(xt, spec)
        a, b = idx[..., 0::2], idx[..., 1::2]
        paired = ((a ^ b) == 1) & ((a | 1) < enc.total_rows)
        assert bool(paired.any()) and bool((~paired).any())


def test_hash_encode_autograd_wiring(card):
    """The autograd node on the card launches both kernels and gives the
    table the plain version's gradient, from both outputs' cotangents; an
    x that requires a gradient gets one (``test_hash_grad_x_matches_plain``)."""
    enc = HashEncoding(**_HASH_GRIDS["sdf"]).to(card)
    with torch.no_grad():
        enc.hash_table.copy_(row_table(enc.total_rows, 2, card))
    x = _hash_points(1000, card)
    before = dict(hg.LAUNCHES)
    out, jac = enc(x, want_jac=True)
    (out.sum() + 0.5 * jac.square().sum()).backward()
    torch.cuda.synchronize()
    assert hg.LAUNCHES["hash_encode_fwd"] == before["hash_encode_fwd"] + 1
    assert hg.LAUNCHES["hash_encode_bwd"] == before["hash_encode_bwd"] + 1
    ref = hg.hash_encode_bwd_plain(x, torch.ones_like(out), jac.detach(), enc.spec, enc.total_rows)
    assert _rel_fro(enc.hash_table.grad, ref) <= HASH_BWD_TOL
    xg = x.clone().requires_grad_(True)
    enc(xg).sum().backward()
    assert xg.grad is not None and bool(torch.isfinite(xg.grad).all())


GRAD_X_TOL = 1e-5  # chip_smoke.py


@pytest.mark.parametrize("grid,n", [("nerfacto", 196608), ("proposal_256", 393216), ("tpu_f4", 98304),
                                    ("dense_f4", 4099), ("nerfacto", 1)])
def test_hash_grad_x_matches_plain(card, grid, n):
    """The encode's gradient in ``x`` (the forward kernel's jacobian
    contracted with the output cotangent, the density methods' camera
    optimizer path) against ``hash_encode_plain`` under autograd, to 1e-5
    of max |plain| at F = 2 and 4; the forward runs once, the table's
    backward kernel once, and the table gradient holds the plain one's."""
    enc = HashEncoding(**_HASH_GRIDS[grid]).to(card)
    with torch.no_grad():
        enc.hash_table.copy_(row_table(enc.total_rows, enc.features_per_level, card))
    x = _ray_points(n, 48, card)
    g = torch.randn((n, enc.out_dim), device=card, generator=torch.Generator(card).manual_seed(1))
    xk = x.clone().requires_grad_(True)
    before = dict(hg.LAUNCHES)
    (enc(xk) * g).sum().backward()
    torch.cuda.synchronize()
    assert hg.LAUNCHES["hash_encode_fwd"] == before["hash_encode_fwd"] + 1
    assert hg.LAUNCHES["hash_encode_bwd"] == before["hash_encode_bwd"] + 1
    xp = x.clone().requires_grad_(True)
    table = enc.hash_table.detach().clone().requires_grad_(True)
    (hg.hash_encode_plain(xp, table, enc.spec) * g).sum().backward()
    # a point at 1.0 whose dense far corner lies past the table reads a row of NaN on both sides
    nan = torch.isnan(xp.grad)
    assert torch.equal(torch.isnan(xk.grad), nan) and bool((~nan).any())
    assert _rel_max(xk.grad[~nan], xp.grad[~nan]) <= GRAD_X_TOL
    assert _rel_fro(enc.hash_table.grad, table.grad) <= HASH_BWD_TOL


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("grid,n,want_jac", [("sdf", 98304, True), ("proposal_64", 524288, False),
                                             ("tpu_f4", 98304, True), ("dense", 4099, True),
                                             ("angelo", 65536, False), ("dense_f8", 4099, True)])
def test_hash_encode_deterministic_backward(card, deterministic, grid, n, want_jac):
    """Under ``torch.use_deterministic_algorithms(True)`` the wrapper takes
    the sorted segment-sum path (its two counters move, the atomic kernel's
    does not), which holds the plain version and repeats bit for bit."""
    enc = HashEncoding(**_HASH_GRIDS[grid])
    spec, R, F = enc.spec, enc.total_rows, enc.features_per_level
    x = _ray_points(n, 96, card)
    x[0] = 1.0  # a corner past the table in the dense grid: dropped
    rng = np.random.default_rng(3)
    LF = spec.num_levels * F
    g_out = torch.from_numpy(rng.standard_normal((n, LF)).astype(np.float32)).to(card)
    g_jac = (torch.from_numpy(rng.standard_normal((n, LF, 3)).astype(np.float32)).to(card)
             if want_jac else None)
    before = dict(hg.LAUNCHES)
    runs = [hg.hash_encode_bwd(x, g_out, g_jac, spec, R) for _ in range(2)]
    torch.cuda.synchronize()
    assert hg.LAUNCHES["hash_encode_bwd"] == before["hash_encode_bwd"]
    assert hg.LAUNCHES["hash_encode_bwd_det"] == before["hash_encode_bwd_det"] + 2
    assert hg.LAUNCHES["hash_segment_sum"] == before["hash_segment_sum"] + 2
    assert torch.equal(runs[0], runs[1])
    ref = hg.hash_encode_bwd_plain(x, g_out, g_jac, spec, R)
    assert _rel_fro(runs[0], ref) <= HASH_BWD_TOL


def test_hash_encode_refuses_what_it_cannot_take(card):
    """The kernels take F = 2, 4 or 8 and 16-byte aligned tables and
    cotangents; the wrappers raise on anything else before a launch."""
    enc = HashEncoding(**_HASH_GRIDS["dense"])
    x = _hash_points(10, card)
    with pytest.raises(ValueError, match="features per level"):
        hg.hash_encode_fwd(x, torch.zeros(enc.total_rows, 3, device=card), enc.spec)
    table = torch.zeros(enc.total_rows * 2 + 2, device=card)[2:].view(enc.total_rows, 2)
    with pytest.raises(ValueError, match="16-byte aligned"):
        hg.hash_encode_fwd(x, table, enc.spec)
    with pytest.raises(ValueError, match="contiguous float32 CUDA"):
        hg.hash_encode_bwd(x, torch.zeros(10, 6, device=card).double(), None, enc.spec,
                           enc.total_rows)


# --- the "grid" background (NerfactoField) -----------------------------------------


@pytest.mark.parametrize("n", [8192, 65536, 1, 127])
def test_grid_background_base_chain_matches_plain(card, n):
    """The grid background's ``mlp_base`` [32 -> 64 -> 16] (relu hidden, no
    output activation) at the rows a step gives it (4 or 32 outside samples
    x 2048 rays) and at ragged edges: the forward to ``KERNEL_TOL`` of its
    scale, the backward against ``fused_mlp_bwd_plain`` in float64 to 1e-4
    of each output's scale (``x`` is the hash feature: no input gradient)."""
    dims = [32, 64, 16]
    x, ws, bs = _case(dims, n, card, margin=True)
    y = fm.fused_mlp(x, ws, bs, "relu", "none")
    ref = fm.fused_mlp_plain(x, ws, bs, "relu", "none")
    assert float((y - ref).abs().max()) / (float(ref.abs().max()) + 1.0) <= KERNEL_TOL
    g = torch.from_numpy(np.random.default_rng(2).standard_normal((n, 16)).astype(np.float32)).to(card)
    _, dws, dbs = fm.fused_mlp_bwd(x, ws, bs, g, "relu", "none", False)
    _, rdws, rdbs = fm.fused_mlp_bwd_plain(x.double(), [w.double() for w in ws],
                                           [b.double() for b in bs], g.double(), "relu", "none", False)
    torch.cuda.synchronize()
    for got, want in list(zip(dws, rdws)) + list(zip(dbs, rdbs)):
        assert float((got.double() - want).abs().max()) / (float(want.abs().max()) + 1e-6) <= BWD_TOL


def test_grid_background_hash_matches_plain_on_contracted_points(card):
    """The grid background's encode (L16 x F2, 2^19 rows a level, 16-1024,
    no smoothstep) without its jacobian on the normalised contraction of
    points far beyond the unit cube, as the background's samples lie: the
    forward to ``HASH_FWD_TOL``, the table gradient to ``HASH_BWD_TOL``."""
    import math

    from sdfstudio_tpu_torch.fields.nerfacto_field import NerfactoField

    field = NerfactoField().to(card)
    rng = np.random.default_rng(3)
    d = rng.standard_normal((65536, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pts = torch.from_numpy((d * rng.uniform(0.5, 1000.0, (65536, 1))).astype(np.float32)).to(card)
    x = field.normalize(pts)
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0 and math.isclose(
        float((x - 0.5).abs().max()), 0.5, abs_tol=1e-3)
    _check_hash(field.encoding, x.contiguous(), False, card)


# --- the Newton undistortion and the three camera models on the card ------------------
# plain PyTorch (XLA code in JAX): the card's float32 against the CPU's on the same inputs,
# to 1e-5 of the normalised coordinate (the CPU side is held to JAX in tests/test_torch_capture.py)

RAYS_TOL = 1e-5  # chip_smoke.py


def _distortions(rng, n):
    from sdfstudio_tpu_torch.cameras.camera_utils import get_distortion_params

    return np.stack([get_distortion_params(k1=rng.uniform(-0.4, 0.4), k2=rng.uniform(-0.1, 0.1),
                                           k3=0.01, k4=-0.005, p1=rng.uniform(-0.01, 0.01),
                                           p2=rng.uniform(-0.01, 0.01)) for _ in range(n)])


def test_undistort_on_the_card_matches_the_cpu(card):
    from sdfstudio_tpu_torch.cameras.camera_utils import (_residual_and_jacobian,
                                                          radial_and_tangential_undistort)

    rng = np.random.default_rng(0)
    coords = torch.as_tensor(rng.uniform(-0.8, 0.8, (3, 65536, 2)), dtype=torch.float32)
    params = torch.as_tensor(_distortions(rng, 65536))[None]
    cpu = radial_and_tangential_undistort(coords, params)
    got = radial_and_tangential_undistort(coords.to(card), params.to(card)).cpu()
    # a distorted point beyond the lens's fold has no undistorted point: there
    # the fixed Newton steps wander (in JAX too) and two float32 paths part.
    # Held where float64 finds the point the distortion maps there
    x64 = radial_and_tangential_undistort(coords.double(), params.double())
    fx, fy, *_ = _residual_and_jacobian(x64[..., 0], x64[..., 1], coords[..., 0].double(),
                                        coords[..., 1].double(), params.double())
    solved = torch.maximum(fx.abs(), fy.abs()) < 1e-9
    assert float(solved.double().mean()) > 0.85
    assert float((got - cpu).abs().amax(-1)[solved].max()) <= RAYS_TOL
    assert float((cpu.double() - x64).abs().amax(-1)[solved].max()) <= RAYS_TOL


@pytest.mark.parametrize("model", [1, 2, 3])
@pytest.mark.parametrize("distorted", [True, False])
def test_camera_rays_on_the_card_match_the_cpu(card, model, distorted):
    from sdfstudio_tpu_torch.cameras.cameras import Cameras

    rng = np.random.default_rng(model)
    n, R = 4, 32768
    c2w = np.concatenate([np.linalg.qr(rng.normal(size=(n, 3, 3)))[0], rng.normal(size=(n, 3, 1))], -1)
    fx = rng.uniform(300, 400, n)
    kw = dict(camera_type=model, distortion_params=_distortions(rng, n) if distorted else None)
    idx = torch.as_tensor(rng.integers(0, n, R))
    coords = torch.as_tensor(np.stack([rng.uniform(0, 300, R), rng.uniform(0, 400, R)], -1),
                             dtype=torch.float32)
    rays = [Cameras.create(c2w, fx, 1.1 * fx, 200.0, 150.0, 400, 300, device=d, **kw)
            .generate_rays(idx.to(d), coords.to(d)) for d in (card, "cpu")]
    for k in ("origins", "directions", "pixel_area", "directions_norm"):
        assert float((getattr(rays[0], k).cpu() - getattr(rays[1], k)).abs().max()) <= RAYS_TOL, k
