"""The port's grouped expert FFN backward on the CPU: the plain backward
(``grouped_ffn_backward_reference``) and ``GroupedFFN`` through
``grouped_ffn`` against torch autograd of the port's plain forward and
against ``jax.vjp`` of the JAX reference (``repro/kernels/moe_gmm/ref.py``),
and the checks of the CUDA path.

Inputs and cotangents are drawn once with numpy and handed to both
frameworks.  The CUDA backward kernel runs only on the card: chip_smoke.py
holds it against the same plain backward there."""
import contextlib
import importlib.util
import types
from pathlib import Path

import pytest
from _hyp import given, settings, st

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.moe_gmm.ref import \
    grouped_ffn_reference as jax_gffn_ref  # noqa: E402
from repro_torch.kernels.moe_gmm import (  # noqa: E402
    GroupedFFN, grouped_ffn, grouped_ffn_backward_reference,
    grouped_ffn_reference)
from repro_torch.kernels.moe_gmm import kernel, ops  # noqa: E402

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
        assert grads[4] is None and grads[5] is None and len(grads) == 6
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


# ---------------------------------------------------------------- geometry
# The wgmma body's TMA maps (kernel.py::bwd_maps), which the CUDA kernel
# encodes as they are given, and the body the wrapper names to the kernel.

def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _strided(flat, dims, strides):
    """The tensor a map describes, indexed (dim 3, dim 2, dim 1, dim 0)."""
    return torch.as_strided(flat, tuple(reversed(dims)),
                            (strides[2], strides[1], strides[0], 1))


def _check_maps(b, e, c, d, f, transposed):
    """Every map addresses its tensor: element (i0, i1, i2, i3) of the map
    is the element the kernel means, for contiguous buffers and for a buf
    and dy that are views of an (E, B, C, D) array."""
    gen = torch.Generator().manual_seed(0)

    def rows():
        if transposed:
            return torch.randn(e, b, c, d, generator=gen).transpose(0, 1)
        return torch.randn(b, e, c, d, generator=gen)

    x, dy = rows(), rows()
    wi, wg = (torch.randn(e, d, f, generator=gen) for _ in range(2))
    wo = torch.randn(e, f, d, generator=gen)
    scratch = torch.randn(e, b * c, f, generator=gen)
    maps = kernel.bwd_maps((b, e, c, d, f), {
        "x": x.stride(), "dy": dy.stride(), "w_in": wi.stride(),
        "w_gate": wg.stride(), "w_out": wo.stride()})
    assert tuple(maps) == kernel.BWD_TENSORS
    want = {"x": x, "dy": dy, "w_in": wi[None], "w_gate": wg[None],
            "w_out": wo[None],
            "scratch": scratch.view(e, b, c, f),
            "dw_in": wi[None], "dw_gate": wg[None], "dw_out": wo[None]}
    for name, (dims, strides) in maps.items():
        assert len(dims) == 4 and len(strides) == 3
        if name in ("x", "dy"):
            assert dims == (d, c, e, b)     # a box of rows: one batch row
        if name == "scratch":
            assert dims == (f, c, b, e)
        t = want[name]
        base = t.as_strided((t.untyped_storage().nbytes() // 4,), (1,), 0)
        got = _strided(base, dims, strides)
        assert torch.equal(got, t), name


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("shape", [(2, 16, 160, 64, 96), (3, 5, 100, 24, 40),
                                   (1, 1, 7, 8, 16)])
def test_bwd_maps_address_the_tensors(shape, transposed):
    _check_maps(*shape, transposed)


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 4), st.integers(1, 200), st.integers(1, 12),
       st.integers(1, 12), st.booleans())
def test_geometry_at_drawn_shapes(b, c, d, f, transposed):
    """Hypothesis-drawn (B, C, D, F) (D and F multiples of 8, as the bf16
    kernels take them): the maps address their tensors."""
    _check_maps(b, 3, c, 8 * d, 8 * f, transposed)


def test_bwd_body_by_dtype_and_name():
    assert kernel.bwd_body(torch.bfloat16) == "wgmma"
    assert kernel.bwd_body(torch.float32) == "fma"
    assert kernel.BWD_BODIES == {"fma": 0, "wgmma": 1}
    assert kernel._BWD_DIMS.size == 8 * (23 + 7 * len(kernel.BWD_TENSORS))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_wrapper_counts_the_body_it_names(monkeypatch, dt):
    """grouped_ffn_bwd_cuda packs its dtype's body after the 22 sizes and
    strides and counts the launch under that body, only once the kernel
    returned success; emulated with the library and the stream patched."""
    seen = []

    def launch(*args):
        seen.append(kernel._BWD_DIMS.unpack(args[13]))
        return int(len(seen) > 1)        # the first call succeeds

    lib = types.SimpleNamespace(moe_gmm_bwd=launch,
                                repro_cuda_error_string=lambda e: b"failed")
    monkeypatch.setattr(kernel, "_bwd_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: types
                        .SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(kernel.grouped_ffn_bwd_cuda, "bodies", {})
    buf, wi, wg, wo, dy = (torch.tensor(a).to(dt) for a in
                           _draw(1, 2, 4, 16, 32, None))
    kernel.grouped_ffn_bwd_cuda(buf, wi, wg, wo, dy, "swiglu")
    body = kernel.bwd_body(dt)
    assert seen[0][0] == kernel._DTYPES[dt]
    assert seen[0][22] == kernel.BWD_BODIES[body]
    assert kernel.grouped_ffn_bwd_cuda.bodies == {body: 1}
    with pytest.raises(RuntimeError):
        kernel.grouped_ffn_bwd_cuda(buf, wi, wg, wo, dy, "swiglu")
    assert kernel.grouped_ffn_bwd_cuda.bodies == {body: 1}


def test_body_at_each_chip_smoke_case():
    """chip_smoke.py's backward cases: bf16 runs the wgmma body (D and F
    multiples of 8, as TMA's 16-byte strides need), f32 the FMAs."""
    cases = _chip_smoke().GMM_BWD_CASES
    assert len(cases) >= 12
    for label, (b, e, c, d, f), act, dt, _ in cases:
        want = "wgmma" if dt == torch.bfloat16 else "fma"
        assert kernel.bwd_body(dt) == want, label
        if want == "wgmma":
            assert d % 8 == 0 and f % 8 == 0, label
