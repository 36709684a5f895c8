"""The precision design of the fused-MLP kernels, modelled on the CPU.

The CUDA kernels (``sdfstudio_tpu_torch/csrc/tf32_mma.cuh``,
``fused_mlp_chain.cuh``, ``fused_mlp_bwd.cu``) take every layer product on
the tensor cores in tf32 as three passes: each f32 operand ``v`` is split
into ``hi = tf32(v)`` and ``lo = tf32(v - hi)`` (``cvt.rna.tf32.f32``:
nearest, ties away from zero, 10 mantissa bits) and ``a b`` is summed as
``lo_a hi_b + hi_a lo_b + hi_a hi_b``, one k8 step (one wgmma each) at a
time. This file follows the kernels' arithmetic step for step:

* every layer, the 1- and 3-column heads included, is a product on the
  tensor cores; a forward layer's bias rides in it as one more k row (b,
  split into hi and lo) against an input column of ones, and K is padded
  with zeros to a multiple of 8;
* a pass of at most 2 tiles of 64 columns (every layer of the proposal
  nets, and any 1-tile pass) sums each k8 step's three wgmmas apart and adds
  that to the accumulator in f32, rounded to nearest; a pass of 4 tiles (the
  color net's 256-wide layers and dx) accumulates on the tensor cores;
* the backward's rows kernel lists each row with a relu pre-activation
  within ``K_FLIP`` of the largest |value| the same thread holds of that row,
  and those rows' forward is recomputed as a k-ordered f32 FMA chain, then
  the bias; the delta chain and dW read the recomputed pre-activations;
* dW of a wide layer sums ``a^T D`` over the rows of a split in one
  tensor-core accumulator, 8 rows a step, with db summed in f32 beside it;
  a head's dW is an FMA chain over each of 4 warps' rows, summed over the
  warps in order; the splits' partials are summed in order in f32.

What is modelled rather than reproduced bit for bit: the tensor cores' own
sum of a wgmma is taken as the exact sum of its 8 products and the
accumulator, rounded once toward zero (the hardware rounds toward zero, but
how it aligns the addends is not documented); an FMA is taken in f64 and
rounded to f32 (a double rounding the card does not make); the activations
are PyTorch's.

The three nets of ``neus-facto-tpu-p8`` (39 -> 128 -> 128 -> 1, 51 -> 128
-> 128 -> 1, 321 -> 256 -> 256 -> 3) run on numpy-seeded inputs, and the
result is held to the JAX package's Pallas kernel (``pallas_mlp.fused_mlp``,
interpret mode, Precision.HIGHEST) within the card's ``KERNEL_TOL`` of 1e-4
relative to max |reference| + 1 (``chip_smoke.py``), and the backward to
``jax.vjp`` of the same kernel within the card's ``BWD_TOL`` of 1e-4
(relative Frobenius). Single-pass TF32 is reported beside it, larger, which
is why the kernels pay three passes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdfstudio_tpu.ops.pallas_mlp import fused_mlp as jfused_mlp

from sdfstudio_tpu_torch.ops import fused_mlp as tfm
from tests.test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

KERNEL_TOL = 1e-4  # chip_smoke.py: max |kernel - plain| / (max |plain| + 1)
BWD_TOL = 1e-4  # chip_smoke.py: ||kernel - plain|| / ||plain|| of dx, each dW and db
TILE_N = 64  # output columns of one wgmma (fused_mlp_chain.cuh)
NARROW = 8  # a layer of at most this many outputs has its dW on the FP32 cores (fused_mlp_bwd.cu)
K_FLIP = 1.0 / 16384  # fused_mlp_bwd.cu kFlipBand
# fused_mlp_bwd.cu plan_dw
DW_GM, DW_GN, DW_BR, NK = 64, 128, 32, 32
TARGET_BLOCKS, MAX_SPLITS, MIN_ROWS_PER_SPLIT, MAX_ROWS_PER_SPLIT = 4 * 132, 256, 256, 2048

P8_NETS = [
    ([39, 128, 128, 1], "relu", "none"),  # proposal 0
    ([51, 128, 128, 1], "relu", "none"),  # proposal 1
    ([321, 256, 256, 3], "relu", "none"),  # color
]


def tf32(v: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round an f32 tensor to 10 mantissa bits, to
    nearest with ties away from zero, as an f32 with the low 13 bits 0."""
    bits = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    sign = bits & 0x80000000
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    out = (sign | mag).to(torch.int64)
    out = torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)
    return out.view(torch.float32)


def split(v: torch.Tensor):
    hi = tf32(v)
    return hi, tf32(v - hi)


def to_f32_rz(v: torch.Tensor) -> torch.Tensor:
    """An f64 tensor rounded to f32 toward zero."""
    r = v.to(torch.float32)
    return torch.where(r.double().abs() > v.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def wgmma(a: torch.Tensor, b: torch.Tensor, c=None) -> torch.Tensor:
    """One wgmma k8 step, ``a [m, 8] @ b [8, n] (+ c)``: exact products of
    tf32 values, summed, rounded toward zero to f32."""
    s = a.double() @ b.double()
    return to_f32_rz(s if c is None else s + c.double())


def fma(a, b, c):
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _pad_k(t: torch.Tensor, dim: int) -> torch.Tensor:
    k = t.shape[dim]
    pad = -k % 8
    if pad == 0:
        return t
    shape = list(t.shape)
    shape[dim] = pad
    return torch.cat([t, t.new_zeros(shape)], dim)


def mm_tc(a: torch.Tensor, b: torch.Tensor, passes: int = 3, promote: bool = True) -> torch.Tensor:
    """``a [m, k] @ b [k, n]`` as one pass of the chain kernels (or the dW
    kernel, with ``a`` = act^T and k the rows): k zero-padded to a multiple
    of 8, one k8 step at a time, each adding lo_a hi_b, hi_a lo_b, hi_a hi_b
    (passes 3) or hi_a hi_b alone (passes 1). With ``promote`` a step's
    wgmmas are summed apart and added to the accumulator in f32; without, they
    accumulate on the tensor cores."""
    a_hi, a_lo = split(_pad_k(a, 1))
    b_hi, b_lo = split(_pad_k(b, 0))
    terms = ([(a_lo, b_hi), (a_hi, b_lo)] if passes == 3 else []) + [(a_hi, b_hi)]
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k in range(0, a_hi.shape[1], 8):
        s = slice(k, k + 8)
        if promote:
            part = None
            for ta, tb in terms:
                part = wgmma(ta[:, s], tb[s], part)
            acc = acc + part
        else:
            for ta, tb in terms:
                acc = wgmma(ta[:, s], tb[s], acc)
    return acc


def chain_maxt(dims, bwd: bool) -> int:
    """fused_mlp_chain.cuh plan_chain: the tile count of a pass, from the
    widest output kept in shared memory (every hidden layer; in the backward
    also the last layer and every delta)."""
    kept = list(dims[1:-1]) + ([dims[-1]] if bwd else [])
    need = max([1] + [-(-d // TILE_N) for d in kept])
    return 2 if need <= 2 else 4 if need <= 4 else 5


def chain_product(h, w, b, maxt, passes):
    """One job of the chain: ``h @ w (+ b)`` with the bias as a k row, in
    passes of at most ``maxt`` tiles; a pass promotes its sums when the
    kernel instantiates it with at most 2 tiles (a 1-tile pass, or maxt 2)."""
    if b is not None:
        h = torch.cat([h, torch.ones(h.shape[0], 1)], 1)
        w = torch.cat([w, b[None]], 0)
    tiles = -(-w.shape[1] // TILE_N)
    outs = []
    for t0 in range(0, tiles, maxt):
        nt = min(maxt, tiles - t0)
        cols = slice(t0 * TILE_N, (t0 + nt) * TILE_N)
        outs.append(mm_tc(h, w[:, cols].contiguous(), passes, promote=nt == 1 or maxt == 2))
    return torch.cat(outs, 1)


def emulated_fwd(x, ws, bs, act, out_act, passes=3):
    dims = [x.shape[1]] + [w.shape[1] for w in ws]
    maxt = chain_maxt(dims, bwd=False)
    h = x
    for i, (w, b) in enumerate(zip(ws, bs)):
        h = tfm._act(chain_product(h, w, b, maxt, passes), act if i < len(ws) - 1 else out_act)
    return h


def near_zero_rows(pre: torch.Tensor) -> torch.Tensor:
    """The rows kernel's fix list: rows with an entry within K_FLIP of the
    largest |value| that the same thread holds of the row (thread t of a
    quad holds the columns c with (c % 8) // 2 == t)."""
    owner = (torch.arange(pre.shape[1]) % 8) // 2
    near = torch.zeros(pre.shape[0], dtype=torch.bool)
    for t in range(4):
        v = pre[:, owner == t].abs()
        if v.shape[1]:
            near |= (v < K_FLIP * v.max(1, keepdim=True).values).any(1)
    return near


def exact_layer(h, w, b):
    """The fix kernel's forward of one layer: a k-ordered FMA chain from 0,
    then the bias."""
    z = torch.zeros(h.shape[0], w.shape[1])
    for k in range(w.shape[0]):
        z = fma(h[:, k:k + 1], w[k][None], z)
    return z + b


def dw_splits(dims, n):
    """fused_mlp_bwd.cu plan_dw: (splits, rows_per_split)."""
    items = sum(0 if N <= NARROW else -(-K // DW_GM) * -(-N // DW_GN) for K, N in zip(dims, dims[1:]))
    narrow = sum(-(-K // NK) if N <= NARROW else 0 for K, N in zip(dims, dims[1:]))
    splits = -(-TARGET_BLOCKS // (items + narrow))
    splits = min(max(splits, -(-n // MAX_ROWS_PER_SPLIT)), MAX_SPLITS)
    splits = max(min(splits, n // MIN_ROWS_PER_SPLIT), 1)
    per = -(-(-(-n // splits)) // DW_BR) * DW_BR
    return -(-n // per), per


def dw_split(a, d, passes):
    """One split's partial (dW, db). A wide layer: a^T D on the tensor cores
    in one accumulator, db a running f32 sum of each 4 rows' pairwise sum. A
    head: warp w (of 4) takes rows w, w + 4, ... in an FMA chain, and the
    warps' sums are added in order."""
    K, N = a.shape[1], d.shape[1]
    if N > NARROW:
        rows = -(-a.shape[0] // DW_BR) * DW_BR
        pad = rows - a.shape[0]
        a_ = torch.cat([a, a.new_zeros(pad, K)])
        d_ = torch.cat([d, d.new_zeros(pad, N)])
        dw = mm_tc(a_.t().contiguous(), d_, passes, promote=False)
        db = torch.zeros(N)
        for r in range(0, rows, 4):
            db = db + ((d_[r] + d_[r + 1]) + (d_[r + 2] + d_[r + 3]))
        return dw, db
    dw, db = torch.zeros(K, N), torch.zeros(N)
    for w in range(4):
        acc, bacc = torch.zeros(K, N), torch.zeros(N)
        for r in range(w, a.shape[0], 4):
            acc = fma(a[r][:, None], d[r][None], acc)
            bacc = bacc + d[r]
        dw, db = dw + acc, db + bacc
    return dw, db


def emulated_bwd(x, ws, bs, g, act, out_act, passes=3, fix=True):
    """fused_mlp_bwd's launches: the rows kernel's forward (and its fix
    list), the fix kernel, the delta chain and dx, dW by splits and their
    reduction. Returns dx, dWs, dbs and the number of rows fixed."""
    L, n = len(ws), x.shape[0]
    dims = [x.shape[1]] + [w.shape[1] for w in ws]
    maxt = chain_maxt(dims, bwd=True)
    pres, h = [], x
    flagged = torch.zeros(n, dtype=torch.bool)
    for i, (w, b) in enumerate(zip(ws, bs)):
        pre = chain_product(h, w, b, maxt, passes)
        fn = act if i < L - 1 else out_act
        if fn == "relu":
            flagged |= near_zero_rows(pre)
        pres.append(pre)
        h = tfm._act(pre, fn)
    if fix and bool(flagged.any()):
        hx = x[flagged]
        for i, (w, b) in enumerate(zip(ws, bs)):
            if i == L - 1 and out_act != "relu":
                break
            v = exact_layer(hx, w, b)
            pres[i][flagged] = v
            hx = tfm._act(v, act)
    d = g * tfm._act_grad(pres[-1], out_act)
    deltas = [None] * L
    deltas[L - 1] = d
    for l in range(L - 1, 0, -1):
        d = chain_product(d, ws[l].t().contiguous(), None, maxt, passes) * tfm._act_grad(pres[l - 1], act)
        deltas[l - 1] = d
    dx = chain_product(d, ws[0].t().contiguous(), None, maxt, passes)
    splits, per = dw_splits(dims, n)
    dws, dbs = [], []
    for l in range(L):
        a = x if l == 0 else tfm._act(pres[l - 1], act)
        dw, db = torch.zeros(dims[l], dims[l + 1]), torch.zeros(dims[l + 1])
        for p in range(splits):
            rows = slice(p * per, min(n, (p + 1) * per))
            pdw, pdb = dw_split(a[rows], deltas[l][rows], passes)
            dw, db = dw + pdw, db + pdb
        dws.append(dw)
        dbs.append(db)
    return dx, dws, dbs, int(flagged.sum())


def _inputs(dims, n, seed, margin=False):
    """Seeded inputs. With ``margin`` the biases lie in +-[0.5, 1.5] and the
    weights are scaled by 0.1, so no pre-activation comes within rounding of
    0, where the relu's derivative jumps and two correct forwards may take
    its two sides (as in tests/test_torch_kernel_cuda.py)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dims[0])).astype(np.float32)
    scale = 0.1 if margin else 1.0
    ws = [(scale * rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(dims[:-1], dims[1:])]
    if margin:
        bs = [(rng.choice([-1.0, 1.0], b) * rng.uniform(0.5, 1.5, b)).astype(np.float32)
              for b in dims[1:]]
    else:
        bs = [(0.1 * rng.standard_normal(b)).astype(np.float32) for b in dims[1:]]
    return x, ws, bs


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    half_ulp = 2.0 ** -11  # tf32 keeps 10 mantissa bits: its ulp at 1 is 2^-10
    v = _t([one + half_ulp, -(one + half_ulp), one + half_ulp - 2.0 ** -23,
            one + 3 * half_ulp, 3.0, 0.0, -0.0, 1e-30, 65504.0 * 1024])
    r = tf32(v)
    expect = _t([one + 2 * half_ulp, -(one + 2 * half_ulp), one, one + 4 * half_ulp, 3.0, 0.0,
                 -0.0, float(np.float32(1e-30)), 65504.0 * 1024])
    assert torch.equal(r[:7], expect[:7])
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()
    # every value moves by at most half a tf32 ulp, and hi + lo keeps ~21 bits
    x = _t(np.random.default_rng(0).standard_normal(10000))
    hi, lo = split(x)
    assert float(((hi - x).abs() / x.abs()).max()) <= 2.0 ** -11
    assert float(((hi + lo - x).abs() / x.abs()).max()) <= 2.0 ** -21


def test_wgmma_model_rounds_toward_zero():
    ulp = 2.0 ** -23  # f32's ulp at 1
    v = torch.tensor([1 + 0.75 * ulp, -(1 + 0.75 * ulp), 1 + 0.25 * ulp, 2.0, -3.5, 0.0],
                     dtype=torch.float64)
    expect = torch.tensor([1.0, -1.0, 1.0, 2.0, -3.5, 0.0])
    assert torch.equal(to_f32_rz(v), expect)
    # a k8 step of exact tf32 products: the same sum as f64 up to the rounding
    a, b = tf32(_t(np.random.default_rng(1).standard_normal((4, 8)))), tf32(_t(np.ones((8, 3))))
    s = wgmma(a, b)
    assert s.dtype == torch.float32
    exact = a.double() @ b.double()
    assert bool((s.double().abs() <= exact.abs()).all())
    assert bool(((exact - s.double()).abs() <= exact.abs() * 2.0 ** -23).all())


@pytest.mark.parametrize("dims,act,out_act", P8_NETS)
def test_3xtf32_forward_matches_jax_highest(dims, act, out_act):
    n = 200
    x, ws, bs = _inputs(dims, n, seed=dims[0])
    ref = np.asarray(jfused_mlp(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                                [jnp.asarray(b) for b in bs], activation=act,
                                out_activation=out_act, interpret=True))
    scale = float(np.abs(ref).max()) + 1.0
    tx, tws, tbs = _t(x), [_t(w) for w in ws], [_t(b) for b in bs]
    err3 = float(np.abs(emulated_fwd(tx, tws, tbs, act, out_act, 3).numpy() - ref).max()) / scale
    err1 = float(np.abs(emulated_fwd(tx, tws, tbs, act, out_act, 1).numpy() - ref).max()) / scale
    print(f"{dims}: 3xTF32 error {err3:.2e}, single-pass TF32 {err1:.2e} (tol {KERNEL_TOL})")
    assert err3 <= KERNEL_TOL
    assert err1 > err3


def _rel_fro(a, b):
    return float(np.linalg.norm(a - b)) / max(float(np.linalg.norm(b)), 1e-30)


def _vjp_refs(x, ws, bs, g, act, out_act):
    def f(x, ws, bs):
        return jfused_mlp(x, ws, bs, activation=act, out_activation=out_act, interpret=True)

    _, vjp = jax.vjp(f, jnp.asarray(x), [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs])
    rdx, rdws, rdbs = vjp(jnp.asarray(g))
    return [np.asarray(r) for r in [rdx, *rdws, *rdbs]]


def _bwd_error(refs, x, ws, bs, g, act, out_act, passes, fix=True):
    """(largest relative error of dx, any dW, any db; rows fixed)"""
    dx, dws, dbs, fixed = emulated_bwd(_t(x), [_t(w) for w in ws], [_t(b) for b in bs], _t(g), act,
                                       out_act, passes, fix)
    return max(_rel_fro(got.numpy(), ref) for got, ref in zip([dx, *dws, *dbs], refs)), fixed


@pytest.mark.parametrize("dims,act,out_act", P8_NETS)
def test_3xtf32_backward_matches_jax_vjp(dims, act, out_act):
    n = 300
    x, ws, bs = _inputs(dims, n, seed=dims[0] + 1, margin=True)
    g = np.random.default_rng(7).standard_normal((n, dims[-1])).astype(np.float32)
    refs = _vjp_refs(x, ws, bs, g, act, out_act)
    errs = {passes: _bwd_error(refs, x, ws, bs, g, act, out_act, passes)[0] for passes in (3, 1)}
    print(f"{dims}: 3xTF32 error {errs[3]:.2e}, single-pass TF32 {errs[1]:.2e} (tol {BWD_TOL})")
    assert errs[3] <= BWD_TOL
    assert errs[1] > errs[3]


@pytest.mark.parametrize("dims,act,out_act", P8_NETS)
def test_3xtf32_backward_fixes_rows_near_zero(dims, act, out_act):
    """Inputs with no margin: some relu pre-activations lie within 3xTF32's
    error of 0, where the two forwards could take the relu's two sides. The
    rows kernel lists those rows and the fix kernel recomputes them in f32;
    with that, the backward stays within BWD_TOL of the f32 reference. 600
    rows take two dW splits and their reduction."""
    n = 600
    x, ws, bs = _inputs(dims, n, seed=dims[0] + 2)
    g = np.random.default_rng(8).standard_normal((n, dims[-1])).astype(np.float32)
    refs = _vjp_refs(x, ws, bs, g, act, out_act)
    assert dw_splits(dims, n)[0] == 2
    err, fixed = _bwd_error(refs, x, ws, bs, g, act, out_act, 3)
    unfixed, _ = _bwd_error(refs, x, ws, bs, g, act, out_act, 3, fix=False)
    print(f"{dims}: {fixed} of {n} rows fixed; 3xTF32 error {err:.2e} with the fix, "
          f"{unfixed:.2e} without (tol {BWD_TOL})")
    assert fixed > 0
    assert err <= BWD_TOL
