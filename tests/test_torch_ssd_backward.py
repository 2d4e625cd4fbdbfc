"""The port's SSD intra-chunk backward on the CPU: the plain backward
(``ssd_intra_chunk_backward_reference``, the formulas written out) against
torch autograd of the plain forward and against ``jax.vjp`` of the JAX
oracle (``repro/kernels/ssd/ref.py``), the autograd Function
(``SSDIntraChunk``) on the CPU, and the checks and dispatch of its CUDA
path.

Inputs and cotangents are drawn once with numpy and handed to both
frameworks.  The CUDA backward kernel runs only on the card: chip_smoke.py
holds it against the same plain backward there."""
import types

import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd.ref import \
    ssd_intra_chunk_reference as jax_intra_ref  # noqa: E402
from repro_torch.kernels.ssd import (  # noqa: E402
    SSDIntraChunk, ssd_intra_chunk, ssd_intra_chunk_backward_reference,
    ssd_intra_chunk_reference)
from repro_torch.kernels.ssd import ops  # noqa: E402

# tests/test_kernels.py:94-97, atol scaled to each gradient's max |value|
# as chip_smoke.py holds the kernel (f32 on both sides here: only the order
# of sums differs, observed <= 1e-6 of the max)
SSD_TOL = dict(atol=2e-4, rtol=1e-3)
NAMES = ("dxc", "ddtc", "dcum", "dbc", "dcc")

# label -> (B, NC, L, H, P, N), decay, cotangents read.  decay: A = -decay
# for every head, or "served" for the model's A = -linspace(1, 16, H) (the
# steep decay that drowns all but the nearest rows)
CASES = {
    "ragged L": ((2, 2, 13, 3, 8, 5), 0.1, "both"),
    "L 1": ((1, 1, 1, 2, 4, 3), 0.1, "both"),
    "mild decay": ((1, 3, 16, 2, 8, 6), 0.01, "both"),
    "steep decay": ((2, 2, 16, 4, 8, 6), "served", "both"),
    "y only": ((1, 2, 12, 2, 8, 4), 0.1, "dy"),
    "states only": ((1, 2, 12, 2, 8, 4), 0.1, "states"),
    "full width one chunk": ((1, 1, 37, 2, 64, 128), "served", "both"),
}


def _draw(case, seed=0):
    """xc, dtc, cum, bc, cc and the cotangents dy, dstates (None where the
    case reads no such output), numpy f32."""
    (b, nc, l, h, p, n), decay, which = CASES[case]
    rng = np.random.default_rng(seed)
    xc = rng.standard_normal((b, nc, l, h, p), np.float32)
    dtc = np.logaddexp(0.0, rng.standard_normal((b, nc, l, h))).astype(
        np.float32)
    a = (-np.linspace(1.0, 16.0, h) if decay == "served"
         else np.full(h, -decay)).astype(np.float32)
    cum = np.cumsum(dtc * a, axis=2, dtype=np.float32)
    bc = rng.standard_normal((b, nc, l, n), np.float32)
    cc = rng.standard_normal((b, nc, l, n), np.float32)
    dy = rng.standard_normal((b, nc, l, h, p), np.float32)
    ds = rng.standard_normal((b, nc, h, n, p), np.float32)
    return ((xc, dtc, cum, bc, cc), dy if which != "states" else None,
            ds if which != "dy" else None)


def _close(got, want, tol=SSD_TOL):
    """Each gradient within ``tol``, its atol scaled to the max |value| of
    the gradient it is held against."""
    for name, g, w in zip(NAMES, got, want):
        g = torch.as_tensor(np.asarray(g, np.float64))
        w = torch.as_tensor(np.asarray(w, np.float64))
        assert g.shape == w.shape, name
        torch.testing.assert_close(g, w, atol=tol["atol"] * float(
            w.abs().max()), rtol=tol["rtol"], msg=name)


def _autograd(x, dy, ds):
    """Gradients of ``ssd_intra_chunk_reference`` by torch autograd."""
    leaves = [t.clone().requires_grad_() for t in x]
    y, st = ssd_intra_chunk_reference(*leaves)
    read = [(o, g) for o, g in ((y, dy), (st, ds)) if g is not None]
    return torch.autograd.grad([o for o, _ in read], leaves,
                               [g for _, g in read], allow_unused=True,
                               materialize_grads=True)


@pytest.mark.parametrize("case", CASES)
def test_backward_reference_matches_autograd(case):
    x, dy, ds = _draw(case)
    tx = [torch.tensor(a) for a in x]
    tdy = None if dy is None else torch.tensor(dy)
    tds = None if ds is None else torch.tensor(ds)
    got = ssd_intra_chunk_backward_reference(*tx, tdy, tds)
    assert all(g.dtype == torch.float32 for g in got)
    _close([g.numpy() for g in got],
           [g.numpy() for g in _autograd(tx, tdy, tds)])


@pytest.mark.parametrize("case", CASES)
def test_backward_reference_matches_jax_vjp(case):
    """Against jax.vjp of the JAX oracle; a cotangent the case does not read
    is zeros there (jax.vjp takes both)."""
    x, dy, ds = _draw(case, seed=1)
    _, vjp = jax.vjp(jax_intra_ref, *(jnp.asarray(a) for a in x))
    shapes = (x[0].shape, (*x[0].shape[:2], x[0].shape[3], x[3].shape[-1],
                           x[0].shape[-1]))
    want = vjp(tuple(jnp.zeros(s, jnp.float32) if g is None else
                     jnp.asarray(g) for g, s in zip((dy, ds), shapes)))
    got = ssd_intra_chunk_backward_reference(
        *(torch.tensor(a) for a in x), None if dy is None else
        torch.tensor(dy), None if ds is None else torch.tensor(ds))
    _close([g.numpy() for g in got], want)


def test_backward_reference_f64_measures_rounding():
    """In f64 the plain backward and autograd agree to rounding (1e-12 of
    the max), and the f32 plain backward lies within the SSD tolerances of
    the f64 one, at the served (steep) decay and at mild decay."""
    for case in ("steep decay", "mild decay"):
        x, dy, ds = _draw(case, seed=2)
        x64 = [torch.tensor(a, dtype=torch.float64) for a in x]
        dy64 = torch.tensor(dy, dtype=torch.float64)
        ds64 = torch.tensor(ds, dtype=torch.float64)
        exact = ssd_intra_chunk_backward_reference(*x64, dy64, ds64)
        assert all(g.dtype == torch.float64 for g in exact)
        _close(exact, _autograd(x64, dy64, ds64), dict(atol=1e-12, rtol=0))
        f32 = ssd_intra_chunk_backward_reference(
            *(torch.tensor(a) for a in x), torch.tensor(dy), torch.tensor(ds))
        _close([g.double() for g in f32], exact)


def test_bf16_x_gives_bf16_dxc():
    x, dy, ds = _draw("full width one chunk", seed=3)
    tx = [torch.tensor(a) for a in x]
    tx[0] = tx[0].to(torch.bfloat16)
    got = ssd_intra_chunk_backward_reference(*tx, torch.tensor(dy),
                                             torch.tensor(ds))
    assert got[0].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in got[1:])
    want = ssd_intra_chunk_backward_reference(tx[0].float(), *tx[1:],
                                              torch.tensor(dy),
                                              torch.tensor(ds))
    assert torch.equal(got[0], want[0].to(torch.bfloat16))


@pytest.mark.parametrize("case", ["ragged L", "y only", "states only"])
def test_function_on_cpu_is_the_plain_backward(case):
    """``ssd_intra_chunk`` on inputs that require grad goes through
    ``SSDIntraChunk``; on the CPU its backward is the plain one, bit for
    bit, and no kernel is counted."""
    x, dy, ds = _draw(case, seed=4)
    leaves = [torch.tensor(a, requires_grad=True) for a in x]
    before = ssd_intra_chunk.launches, ssd_intra_chunk.backward_launches
    y, st = ssd_intra_chunk(*leaves)
    assert type(y.grad_fn).__name__ == "SSDIntraChunkBackward"
    read = [(o, torch.tensor(g)) for o, g in ((y, dy), (st, ds))
            if g is not None]
    torch.autograd.backward([o for o, _ in read], [g for _, g in read])
    want = ssd_intra_chunk_backward_reference(
        *(t.detach() for t in leaves), None if dy is None else
        torch.tensor(dy), None if ds is None else torch.tensor(ds))
    for t, w in zip(leaves, want):
        assert torch.equal(t.grad, w)
    assert (ssd_intra_chunk.launches,
            ssd_intra_chunk.backward_launches) == before


def test_no_grad_skips_the_function():
    x, _, _ = _draw("ragged L")
    leaves = [torch.tensor(a, requires_grad=True) for a in x]
    with torch.no_grad():
        y, _ = ssd_intra_chunk(*leaves)
    assert y.grad_fn is None
    y, _ = ssd_intra_chunk(*(t.detach() for t in leaves))
    assert y.grad_fn is None


def test_cuda_backward_launches_kernel_and_never_the_plain_version(
        monkeypatch):
    """On CUDA tensors the backward checks the cotangents, fills an absent
    one with zeros, launches the kernel and counts one backward call; it
    never calls the plain backward.  Emulated here with the device check
    patched."""
    x, dy, ds = _draw("ragged L", seed=5)
    tx = [torch.tensor(a) for a in x]
    calls = []
    monkeypatch.setattr(ops, "ssd_intra_chunk_backward_reference",
                        lambda *a, **k: calls.append("plain"))

    def kernel(*args):
        calls.append(("kernel", args[5].clone(), args[6].clone()))
        return tuple(torch.zeros_like(t) for t in args[:5])
    monkeypatch.setattr(ops, "ssd_intra_chunk_bwd_cuda", kernel)
    monkeypatch.setattr(torch.Tensor, "device", property(
        lambda self: torch.device("cuda", 0)))
    before = ssd_intra_chunk.backward_launches
    ctx = types.SimpleNamespace(saved_tensors=tuple(tx))
    # a non-contiguous dy is made contiguous, as the kernel takes it
    tdy = torch.tensor(dy).transpose(3, 4).contiguous().transpose(3, 4)
    assert not tdy.is_contiguous()
    grads = SSDIntraChunk.backward(ctx, tdy, None)
    assert len(grads) == 5 and len(calls) == 1 and calls[0][0] == "kernel"
    assert torch.equal(calls[0][1], torch.tensor(dy))
    assert calls[0][1].is_contiguous()
    assert not calls[0][2].any() and calls[0][2].shape == (2, 2, 3, 5, 8)
    SSDIntraChunk.backward(ctx, None, torch.tensor(ds))
    assert not calls[1][1].any() and calls[1][1].shape == tdy.shape
    assert ssd_intra_chunk.backward_launches == before + 2
    assert SSDIntraChunk.backward(ctx, None, None) == (None,) * 5
    assert ssd_intra_chunk.backward_launches == before + 2
    assert "plain" not in calls
    ssd_intra_chunk.backward_launches = before


def test_check_cuda_inputs_checks_cotangents():
    x, dy, ds = _draw("ragged L")
    tx = [torch.tensor(a) for a in x]
    tdy, tds = torch.tensor(dy), torch.tensor(ds)
    ops._check_cuda_inputs(*tx, tdy, tds)
    for bad_dy, bad_ds in ((tdy[:, :, :-1], tds), (tdy, tds[..., :-1]),
                           (tdy.double(), tds),
                           (tdy, tds.transpose(-1, -2).contiguous()
                            .transpose(-1, -2))):
        with pytest.raises(ValueError, match="cotangent"):
            ops._check_cuda_inputs(*tx, bad_dy, bad_ds)

