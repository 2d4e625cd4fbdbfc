"""The port's grouped expert FFN backward on the CPU: the plain backward
(``grouped_ffn_backward_reference``) and ``GroupedFFN`` through
``grouped_ffn`` against torch autograd of the port's plain forward and
against ``jax.vjp`` of the JAX reference (``repro/kernels/moe_gmm/ref.py``),
and the checks of the CUDA path.

Inputs and cotangents are drawn once with numpy and handed to both
frameworks.  The CUDA backward kernel runs only on the card: chip_smoke.py
holds it against the same plain backward there."""
import types

import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.moe_gmm.ref import \
    grouped_ffn_reference as jax_gffn_ref  # noqa: E402
from repro_torch.kernels.moe_gmm import (  # noqa: E402
    GroupedFFN, grouped_ffn, grouped_ffn_backward_reference,
    grouped_ffn_reference)
from repro_torch.kernels.moe_gmm import ops  # noqa: E402

# f32 on both sides, only the order of sums differs; leaf-relative, as
# tests/test_torch_train.py holds gradients
GRAD_REL = 1e-4
BF16_TOL = dict(atol=0.05, rtol=0.05)    # tests/test_kernels.py, bf16 gmm
NAMES = ("dbuf", "dw_in", "dw_gate", "dw_out")

# B, E, C, D, F, act, occupancy: every row live; F not a multiple of 8;
# gelu; buffers as the MoE dispatch leaves them (dead experts and rows,
# dY zero on unkept slots); gelu with zero X rows under nonzero dY rows
CASES = {
    "swiglu": (2, 4, 8, 32, 64, "swiglu", None),
    "swiglu ragged F": (1, 8, 16, 64, 100, "swiglu", None),
    "gelu": (2, 2, 4, 16, 48, "gelu", None),
    "swiglu dead": (2, 6, 8, 32, 48, "swiglu", "routed"),
    "gelu dead": (2, 6, 8, 16, 48, "gelu", "routed"),
    "gelu zero x": (2, 3, 4, 16, 32, "gelu", "zero x"),
}


def _draw(b, e, c, d, f, occupancy, seed=0):
    """buf, w_in, w_gate, w_out, dy as f32 numpy arrays.  ``routed``: tokens
    in order into their experts' next free slots, expert 0 never chosen;
    buf and dy are zero on every other slot.  ``zero x``: X zero on half the
    rows of every expert, dy nonzero everywhere."""
    rng = np.random.default_rng(seed)
    buf = 0.5 * rng.standard_normal((b, e, c, d), np.float32)
    wi = rng.standard_normal((e, d, f), np.float32) * d ** -0.5
    wg = rng.standard_normal((e, d, f), np.float32) * d ** -0.5
    wo = rng.standard_normal((e, f, d), np.float32) * f ** -0.5
    dy = rng.standard_normal((b, e, c, d), np.float32)
    if occupancy == "routed":
        mask = np.zeros((b, e, c, 1), np.float32)
        for i in range(b):
            fill = np.zeros(e, int)
            for ex in rng.integers(1, e, size=c * e // 2):
                if fill[ex] < c:
                    mask[i, ex, fill[ex]] = 1
                    fill[ex] += 1
        buf, dy = buf * mask, dy * mask
    elif occupancy == "zero x":
        buf[:, :, ::2] = 0
    return buf, wi, wg, wo, dy


def _leaf_rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def _autograd(arrs, act):
    """Autograd of the port's plain forward; w_gate's gradient is zeros
    where the function does not read it (gelu), as jax.grad gives."""
    leaves = [torch.tensor(a, requires_grad=True) for a in arrs[:4]]
    grouped_ffn_reference(*leaves, act=act).backward(torch.tensor(arrs[4]))
    return [x.grad if x.grad is not None else torch.zeros_like(x)
            for x in leaves]


def _jax_vjp(arrs, act):
    jx = [jnp.asarray(a) for a in arrs]
    _, vjp = jax.vjp(lambda *w: jax_gffn_ref(*w, act=act), *jx[:4])
    return [np.asarray(g) for g in vjp(jx[4])]


def _assert_close(got, want, label):
    for name, g, w in zip(NAMES, got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == np.shape(w), (label, name)
        assert _leaf_rel(g, w) <= GRAD_REL, (label, name, _leaf_rel(g, w))


@pytest.mark.parametrize("case", CASES, ids=str)
def test_backward_reference_matches_autograd(case):
    *shape, act, occupancy = CASES[case]
    arrs = _draw(*shape, occupancy)
    got = grouped_ffn_backward_reference(
        *(torch.tensor(a) for a in arrs), act=act)
    assert all(g.dtype == torch.float32 for g in got)
    _assert_close(got, [g.numpy() for g in _autograd(arrs, act)], case)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_backward_reference_matches_jax_vjp(case):
    *shape, act, occupancy = CASES[case]
    arrs = _draw(*shape, occupancy, seed=1)
    got = grouped_ffn_backward_reference(
        *(torch.tensor(a) for a in arrs), act=act)
    _assert_close(got, _jax_vjp(arrs, act), case)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_function_matches_autograd_and_jax_on_cpu(case):
    """grouped_ffn on inputs that need grad goes through GroupedFFN; on the
    CPU its forward and backward are the plain versions, and neither counts
    a launch."""
    *shape, act, occupancy = CASES[case]
    arrs = _draw(*shape, occupancy, seed=2)
    leaves = [torch.tensor(a, requires_grad=True) for a in arrs[:4]]
    before = grouped_ffn.launches, grouped_ffn.backward_launches
    out = grouped_ffn(*leaves, act=act)
    assert type(out.grad_fn).__name__ == "GroupedFFNBackward"
    want_out = grouped_ffn_reference(*(torch.tensor(a) for a in arrs[:4]),
                                     act=act)
    torch.testing.assert_close(out.detach(), want_out, rtol=0, atol=0)
    out.backward(torch.tensor(arrs[4]))
    assert (grouped_ffn.launches, grouped_ffn.backward_launches) == before
    got = [x.grad for x in leaves]
    _assert_close(got, [g.numpy() for g in _autograd(arrs, act)], case)
    _assert_close(got, _jax_vjp(arrs, act), case)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_dead_rows_and_experts_have_exact_zero_gradients(act):
    """Buffers as the dispatch leaves them: dead experts' weight gradients
    and the dX rows of dead rows are exact zeros (what the CUDA kernel's
    skip rests on); under gelu a zero X row with a nonzero dY row is live,
    and its dX row is not zero."""
    arrs = list(_draw(2, 6, 8, 16, 48, "routed", seed=3))
    dbuf, dwi, dwg, dwo = grouped_ffn_backward_reference(
        *(torch.tensor(a) for a in arrs), act=act)
    dead = ~(arrs[0] != 0).any(-1) & ~(arrs[4] != 0).any(-1)   # (B, E, C)
    dead_e = dead.all(axis=(0, 2))
    assert dead.any() and dead_e.any()
    assert not dbuf.numpy()[dead].any()
    for g in (dwi, dwg, dwo):
        assert not g.numpy()[dead_e].any()
    # a zero X row under a nonzero dY row
    row = tuple(np.argwhere(dead)[0])
    arrs[4][row] = 1.0
    dbuf = grouped_ffn_backward_reference(
        *(torch.tensor(a) for a in arrs), act=act)[0]
    want = _jax_vjp(arrs, act)[0]
    np.testing.assert_allclose(dbuf.numpy(), want, rtol=1e-5, atol=1e-6)
    if act == "gelu":
        assert dbuf[row].abs().max() > 0
    else:
        assert not dbuf[row].any()


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_backward_bf16_inputs(act):
    """bf16 inputs: the gradients come back in bf16 and agree with the f32
    gradients of the bf16 values (autograd and jax.vjp) within the bf16 gmm
    tolerance."""
    arrs = _draw(1, 2, 4, 32, 64, None, seed=4)
    bf = [torch.tensor(a).to(torch.bfloat16) for a in arrs]
    f32 = [x.float().numpy() for x in bf]
    got = grouped_ffn_backward_reference(*bf, act=act)
    assert all(g.dtype == torch.bfloat16 for g in got)
    for want in ([g.numpy() for g in _autograd(f32, act)],
                 _jax_vjp(f32, act)):
        for name, g, w in zip(NAMES, got, want):
            np.testing.assert_allclose(g.float().numpy(), w, **BF16_TOL,
                                       err_msg=name)


def test_gelu_w_gate_gradient_is_zeros_of_its_shape():
    """gelu does not read w_gate: any tensor may stand in for it, and its
    gradient is zeros of its shape."""
    buf, wi, _, wo, dy = (torch.tensor(a) for a in
                          _draw(2, 2, 4, 16, 48, None))
    wg = torch.ones(1, requires_grad=True)
    wi.requires_grad_()
    grouped_ffn(buf, wi, wg, wo, act="gelu").backward(dy)
    assert torch.equal(wg.grad, torch.zeros(1))
    assert wi.grad is not None and wi.grad.abs().max() > 0


def test_cuda_backward_launches_kernel_and_never_the_plain_version(
        monkeypatch):
    """On CUDA tensors the backward checks dy and launches the kernel,
    counting one backward launch; it never calls the plain backward.
    Emulated here with the device check patched."""
    arrs = [torch.tensor(a) for a in _draw(1, 2, 4, 16, 32, None)]
    calls = []
    monkeypatch.setattr(ops, "grouped_ffn_backward_reference",
                        lambda *a, **k: calls.append("plain"))

    def kernel(buf, wi, wg, wo, dy, act):
        calls.append(("kernel", act, wg is arrs[2]))
        return buf, wi, None if act == "gelu" else wg, wo
    monkeypatch.setattr(ops, "grouped_ffn_bwd_cuda", kernel)
    monkeypatch.setattr(torch.Tensor, "device", property(
        lambda self: torch.device("cuda", 0)))
    before = grouped_ffn.backward_launches
    for act in ("swiglu", "gelu"):
        ctx = types.SimpleNamespace(saved_tensors=tuple(arrs[:4]), act=act)
        dy = arrs[4].transpose(0, 1).contiguous().transpose(0, 1)
        grads = GroupedFFN.backward(ctx, dy)
        assert grads[4] is None and len(grads) == 5
    assert calls == [("kernel", "swiglu", True), ("kernel", "gelu", False)]
    assert grouped_ffn.backward_launches == before + 2
    # gelu: the kernel leaves w_gate alone, its gradient is zeros
    assert torch.equal(grads[2], torch.zeros_like(arrs[2]))
    grouped_ffn.backward_launches = before


def test_check_cuda_inputs_checks_dy():
    buf, wi, wg, wo, dy = (torch.tensor(a) for a in
                           _draw(1, 2, 4, 16, 32, None))
    ops._check_cuda_inputs(buf, wi, wg, wo, "swiglu", dy)
    with pytest.raises(ValueError, match="cotangent"):
        ops._check_cuda_inputs(buf, wi, wg, wo, "swiglu", dy[:, :, :2])
    with pytest.raises(ValueError, match="cotangent"):
        ops._check_cuda_inputs(buf, wi, wg, wo, "swiglu",
                               dy.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        ops._check_cuda_inputs(buf, wi, wg, wo, "swiglu",
                               dy.transpose(-1, -2).contiguous()
                               .transpose(-1, -2))
