"""The smoke's kernel-step-against-plain-step check with the discrete
choices carried over (``chip_smoke.py::discrete_choices``,
``choices_parted`` and ``step_vs_plain(carry_choices=True)``).

Two float32 paths that are both right may part at a discrete choice where a
value lies within their rounding of its boundary: an rgb residual's sign
(the L1 loss's gradient is ``sign(r)``) or a final sample's side of the
background merge's unit sphere. The check carries the kernel step's choice
over to the plain step there and holds that at its tolerance (1e-4 of the
gradient's norm), reporting the free comparison with its flips. Here a
crafted pair of steps differs in exactly one such choice: held once the
choice is carried, not held without the carry, and not held with a 1e-3
error in the gradient either way. A flip far from the boundary is not
carried.

A relu's side is such a choice too (``relu_choices``, ``step_vs_plain(
carry_relu=True)``): a hidden unit whose pre-activation lies within the
paths' rounding of 0 takes the whole of its share of the gradient on one
side and none on the other. A stand-in kernel that puts one unit of a fused
chain, or one unit of a plain MLP after it, on the other side from the plain
product is held on the shared samples once the kernel's side is carried
over (read, for the chain, from the backward as the smoke reads the card's
kernel), not held without the carry, and not held with a 1e-3 error in its
gradient or with the unit beyond the rounding.
"""
import sys
from pathlib import Path

import pytest
import torch

from tests.test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from sdfstudio_tpu_torch.components import losses as L  # noqa: E402
from sdfstudio_tpu_torch.ops import fused_mlp as fm  # noqa: E402
from sdfstudio_tpu_torch.ops import mlp  # noqa: E402


class _Samples:
    def __init__(self, positions):
        self.positions = positions

    def get_start_positions(self):
        return self.positions


class _Toy:
    """A step with one L1 loss over a background merge, a parameter ``w``
    (the ``field`` group), and the plain path's crafted difference."""

    def __init__(self, what: str, shift: float = 1e-7, grad_error: float = 0.0):
        g = torch.Generator().manual_seed(0)
        self.w = torch.randn(4, 3, generator=g, dtype=torch.float64)
        self.feats = torch.randn(6, 5, 4, generator=g, dtype=torch.float64)  # [R, S, 4]
        self.pos = torch.randn(6, 5, 3, generator=g, dtype=torch.float64)
        self.pos = self.pos / torch.linalg.vector_norm(self.pos, dim=-1, keepdim=True) * 1.3
        self.pos[2, 1] *= (1.0 + 3e-8) / 1.3  # one sample just outside the unit sphere
        self.what, self.shift, self.grad_error = what, shift, grad_error
        with torch.no_grad():
            rgb = self._rgb(self.w, False)
            self.image = rgb + 0.1 * torch.randn(rgb.shape, generator=g, dtype=torch.float64)
            self.image[3, 2] = rgb[3, 2] + 5e-8  # one residual just above 0

    def get_foreground_mask(self, ray_samples):
        return (torch.linalg.vector_norm(ray_samples.get_start_positions(), dim=-1) < 1.0).to(
            torch.float64)

    def _rgb(self, w, plain: bool):
        pos = self.pos.clone()
        if plain and self.what == "side":
            pos[2, 1] *= 1.0 - self.shift  # the sample crosses to the inside
        inside = self.get_foreground_mask(_Samples(pos))[..., None]
        fg, bg = torch.sigmoid(self.feats @ w), torch.tanh(self.feats @ w) * 0.5 + 0.5
        return (inside * fg + (1 - inside) * bg).mean(dim=1)  # [R, 3]

    def one_step(self):
        plain = mlp.fused_mlp is fm.fused_mlp_plain
        w = self.w.clone().requires_grad_(True)
        pos = self.pos.clone()
        if plain and self.what == "side":
            pos[2, 1] *= 1.0 - self.shift
        inside = self.get_foreground_mask(_Samples(pos))[..., None]
        fg, bg = torch.sigmoid(self.feats @ w), torch.tanh(self.feats @ w) * 0.5 + 0.5
        rgb = (inside * fg + (1 - inside) * bg).mean(dim=1)
        if plain and self.what == "l1":
            rgb = rgb + torch.nn.functional.one_hot(torch.tensor(3 * 3 + 2), 18).reshape(6, 3) * self.shift
        loss = L.l1_loss(self.image, rgb)
        (g,) = torch.autograd.grad(loss, w)
        if plain and self.grad_error:
            g = g * (1.0 + self.grad_error)
        return {"rgb_loss": float(loss.detach())}, {"field": g.reshape(-1)}


@pytest.fixture(autouse=True)
def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


def _run(toy, carry: bool):
    return chip_smoke.step_vs_plain(fm, "toy", toy.one_step, model=toy, carry_choices=carry)


@pytest.mark.parametrize("what", ["l1", "side"])
def test_one_flipped_choice_is_held_once_carried_over(what):
    toy = _Toy(what)
    out = _run(toy, carry=True)
    flips = out["choices"]["free"]
    assert (flips["l1_sign_flips"], flips["side_flips"]) == ((1, 0) if what == "l1" else (0, 1))
    assert flips["l1_flips_within_rounding"] + flips["side_flips_within_rounding"] == 1
    # the free comparison parts by far more than the tolerance and is only reported
    assert max(out["grad_err"].values()) > 10 * chip_smoke.STEP_GRAD_TOL
    assert max(out["carried_grad_err"].values()) <= chip_smoke.STEP_GRAD_TOL
    with pytest.raises(AssertionError, match="kernel step and plain step differ"):
        _run(toy, carry=False)


@pytest.mark.parametrize("what", ["l1", "side"])
def test_a_real_gradient_error_still_fails_with_the_carry(what):
    with pytest.raises(AssertionError, match="carried over"):
        _run(_Toy(what, grad_error=1e-3), carry=True)
    with pytest.raises(AssertionError, match="field gradient"):
        _run(_Toy("none", grad_error=1e-3), carry=True)


@pytest.mark.parametrize("what", ["l1", "side"])
def test_a_flip_beyond_the_rounding_is_not_carried(what):
    toy = _Toy(what, shift=1e-3)
    toy.image[3, 2] += 1e-4 if what == "l1" else 0.0
    toy.pos[2, 1] *= (1.0 + 1e-4) if what == "side" else 1.0
    with pytest.raises(AssertionError, match="carried over"):
        _run(toy, carry=True)


def test_no_flip_holds_the_free_step():
    out = _run(_Toy("none"), carry=True)
    assert "carried_grad_err" not in out
    assert out["choices"]["free"]["l1_sign_flips"] == out["choices"]["free"]["side_flips"] == 0
    assert max(out["grad_err"].values()) == 0.0


ROW, UNIT = 5, 3  # the unit whose side the stand-in kernel flips


class _ReluToy:
    """A fused relu chain [4 -> 8 -> 8] and a plain MLP head [8 -> 8 -> 3]
    after it, in float64, on 64 rows: the gradients of the chain and head
    (``field``) and of the input (``camera_opt``). Unit ``UNIT`` of row
    ``ROW`` has its pre-activation ``near`` 0 in the chain's first layer
    (``where="chain"``) or the head's (``where="mlp"``), and the stand-in
    kernel moves it by ``-shift`` there (through the chain's output for the
    head), so its side differs from the plain product's."""

    def __init__(self, where: str, near: float = 1e-8, shift: float = 3e-8, grad_error: float = 0.0):
        g = torch.Generator().manual_seed(0)
        self.x = torch.randn(64, 4, generator=g, dtype=torch.float64)
        self.c = torch.randn(64, 3, generator=g, dtype=torch.float64)
        self.chain = mlp.MLP(4, 2, 8, out_dim=8).double()
        self.head = mlp.MLP(8, 2, 8, out_dim=3, out_activation="sigmoid").double()
        assert self.chain.fused and not self.head.fused
        with torch.no_grad():
            for m in (self.chain, self.head):
                m.reset_parameters(g)
                for layer in m.layers:
                    layer.bias.copy_(0.1 * torch.randn(layer.bias.shape, generator=g, dtype=torch.float64))
            if where == "chain":
                w, b = self.chain.layers[0].kernel, self.chain.layers[0].bias
                b[UNIT] = near - self.x[ROW] @ w[:, UNIT]
            else:
                h = fm.fused_mlp_plain(self.x, [m.kernel for m in self.chain.layers],
                                       [m.bias for m in self.chain.layers])
                w, b = self.head.layers[0].kernel, self.head.layers[0].bias
                b[UNIT] = near - h[ROW] @ w[:, UNIT]
                self.out_shift = -shift * torch.sign(w[:, UNIT]) / w[:, UNIT].abs().sum()
        self.where, self.shift, self.grad_error, self.kernel_calls = where, shift, grad_error, 0

    def kernel(self, x, weights, biases, activation="relu", out_activation="none", step=True):
        """The stand-in forward kernel: the plain chain with row ``ROW``'s
        unit moved (rows told apart by their content, as a kernel's are)."""
        if step and torch.is_grad_enabled() and x.requires_grad:
            self.kernel_calls += 1
        is_row = (x == self.x[ROW]).all(dim=-1, keepdim=True).to(x.dtype) if x.shape[-1] == 4 else 0.0
        h, n = x, len(weights)
        for i, (w, b) in enumerate(zip(weights, biases)):
            h = torch.matmul(h, w) + b
            if i == 0 and self.where == "chain":
                h = h - is_row * self.shift * torch.nn.functional.one_hot(torch.tensor(UNIT), h.shape[-1])
            h = fm._act(h, activation if i < n - 1 else out_activation)
        if self.where == "mlp" and len(weights) == len(self.chain.layers):
            h = h + is_row * self.out_shift
        return h

    def kernel_bwd(self, x, weights, biases, g, activation="relu", out_activation="none", need_dx=True):
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            wr = [w.detach().requires_grad_(True) for w in weights]
            br = [b.detach().requires_grad_(True) for b in biases]
            grads = torch.autograd.grad(self.kernel(xr, wr, br, activation, out_activation, step=False),
                                        [xr, *wr, *br], g)
        n = len(weights)
        return (grads[0] if need_dx else None), list(grads[1:1 + n]), list(grads[1 + n:])

    def one_step(self):
        x = self.x.clone().requires_grad_(True)
        params = [*self.chain.parameters(), *self.head.parameters()]
        before = self.kernel_calls
        loss = (self.head(self.chain(x)) * self.c).mean()
        dx, *dp = torch.autograd.grad(loss, [x, *params])
        field = torch.cat([t.reshape(-1) for t in dp])
        if self.kernel_calls > before and self.grad_error:  # an error in the kernel's gradient
            field = field * (1.0 + self.grad_error)
        return {"rgb_loss": float(loss.detach())}, {"field": field, "camera_opt": dx.reshape(-1)}


@pytest.fixture
def relu_kernel(monkeypatch):
    """Install a toy's stand-in kernels where the model and the smoke find the card's."""
    def install(toy):
        for mod in (fm, mlp):
            monkeypatch.setattr(mod, "fused_mlp", toy.kernel)
        monkeypatch.setattr(fm, "fused_mlp_bwd", toy.kernel_bwd)
        return toy
    return install


def _run_relu(toy, carry: bool):
    return chip_smoke.step_vs_plain(fm, "toy", toy.one_step, plain_hash=False, shared_samples=True,
                                    only_well_posed=True, carry_relu=carry)


@pytest.mark.parametrize("where", ["chain", "mlp"])
def test_one_relu_flip_is_held_once_carried_over(relu_kernel, where):
    toy = relu_kernel(_ReluToy(where))
    out = _run_relu(toy, carry=True)
    flips = out["relu_flips"]
    assert (flips["chain_flips"], flips["mlp_flips"]) == ((1, 0) if where == "chain" else (0, 1))
    assert flips["max_abs_pre"] < 1e-6
    assert (flips["rows_queried"] > 0) == (where == "chain")
    # without the carry the shared samples part by far more than the tolerance: only reported
    assert max(out["shared_uncarried_grad_err"].values()) > 10 * chip_smoke.STEP_GRAD_TOL
    assert max(out["shared_grad_err"].values()) <= chip_smoke.STEP_GRAD_TOL
    with pytest.raises(AssertionError, match="plain step on its resamplings differ"):
        _run_relu(toy, carry=False)


@pytest.mark.parametrize("where", ["chain", "mlp"])
def test_a_real_gradient_error_still_fails_with_the_relu_carry(relu_kernel, where):
    with pytest.raises(AssertionError, match="field gradient: kernel step and plain step on its "
                                             "resamplings"):
        _run_relu(relu_kernel(_ReluToy(where, grad_error=1e-3)), carry=True)


@pytest.mark.parametrize("where", ["chain", "mlp"])
def test_a_relu_flip_beyond_the_rounding_is_not_carried(relu_kernel, where):
    toy = relu_kernel(_ReluToy(where, near=1e-3, shift=3e-3))
    with pytest.raises(AssertionError, match="plain step on its resamplings differ"):
        _run_relu(toy, carry=True)


def test_no_relu_flip_holds_the_shared_step(relu_kernel):
    out = _run_relu(relu_kernel(_ReluToy("chain", near=0.5, shift=0.0)), carry=True)
    assert out["relu_flips"]["chain_flips"] == out["relu_flips"]["mlp_flips"] == 0
    assert max(out["shared_grad_err"].values()) == 0.0
