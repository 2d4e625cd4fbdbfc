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
from repro_torch.kernels.ssd.ref import NEG_INF, split_matmul  # noqa: E402

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



# ---------------------------------------------------------------------------
# The numerics of the CUDA backward's products (ssd_intra_chunk_bwd.cu's
# table): bf16 tensor-core products at f32 accuracy, each f32 operand split
# into three bf16 parts (an operand holding bf16 values, X from a bf16 x, is
# one), the part-products down to 2^-16 summed lightest first
# (``split_matmul``), held against f64 sums of the same f32 operands beside
# the plain f32 product.  Sizes: tests/test_kernels.py's SSD cases, which
# chip_smoke.py's phase 3 runs too, (B, NC, L, H, P, N).
SPLIT_CASES = [(2, 2, 16, 4, 8, 16), (1, 4, 32, 2, 16, 8),
               (2, 1, 64, 8, 32, 32), (1, 2, 128, 4, 64, 64)]
SSD_ROW_REL = 1e-4           # chip_smoke.py's bound on a row's rms error
PRODUCTS = ["dM^T = X dy^T", "dM^T = X dy^T, x f32", "dX += M^T dy",
            "U = B dS", "X dS^T", "X dS^T, x f32", "dC = dCB B",
            "dB = dCB^T C"]


def _products(shape, seed=0):
    """product -> (A, B, A's parts, B's parts), f32 operands batched over
    (b, c, h) or (b, c), built as the backward builds them: M = CB * E *
    dt_j and dCB = sum_h dM * E * dt_j from the plain formulas, X holding
    bf16 values but for the "x f32" products."""
    b, nc, l, h, p, n = shape
    rng = np.random.default_rng(seed)

    def draw(*dims):
        return torch.tensor(rng.standard_normal(dims, np.float32))
    x32 = draw(b, nc, h, l, p)
    x16 = x32.to(torch.bfloat16).float()
    dy, ds = draw(b, nc, h, l, p), draw(b, nc, h, n, p)
    bm, cm = draw(b, nc, l, n), draw(b, nc, l, n)
    dt = torch.nn.functional.softplus(draw(b, nc, h, l))
    cum = torch.cumsum(-0.1 * dt, -1)
    causal = torch.tril(torch.ones(l, l, dtype=torch.bool))
    e = torch.exp(torch.where(causal, cum[..., :, None] - cum[..., None, :],
                              NEG_INF))                       # (b,nc,h,i,j)
    m = (cm @ bm.transpose(-1, -2))[:, :, None] * e * dt[..., None, :]
    dcb = ((dy @ x16.transpose(-1, -2)) * e * dt[..., None, :]).sum(2)
    return {
        "dM^T = X dy^T": (x16, dy.transpose(-1, -2), 1, 3),
        "dM^T = X dy^T, x f32": (x32, dy.transpose(-1, -2), 3, 3),
        "dX += M^T dy": (m.transpose(-1, -2), dy, 3, 3),
        "U = B dS": (bm[:, :, None], ds, 3, 3),
        "X dS^T": (x16, ds.transpose(-1, -2), 1, 3),
        "X dS^T, x f32": (x32, ds.transpose(-1, -2), 3, 3),
        "dC = dCB B": (dcb, bm, 3, 3),
        "dB = dCB^T C": (dcb.transpose(-1, -2), cm, 3, 3),
    }


def _cancelling(a, b, seed=1):
    """(A, B) rebuilt so that every row of A B cancels to about 1% of its
    terms: A's second half of columns the negated first, B's second half
    of rows the first times 1 + 0.01 noise."""
    rng = np.random.default_rng(seed)
    k = a.shape[-1] // 2
    noise = torch.tensor(rng.standard_normal(b[..., :k, :].shape, np.float32))
    a = torch.cat([a[..., :k], -a[..., :k]], -1)
    b = torch.cat([b[..., :k, :], b[..., :k, :] * (1 + 0.01 * noise)], -2)
    return a, b


def _row_rel(got, want):
    """The largest rms(got - want) / rms(want) over the rows (last dim)."""
    err = (got.double() - want).pow(2).mean(-1).sqrt()
    return float((err / want.pow(2).mean(-1).sqrt().clamp_min(1e-30)).max())


@pytest.mark.parametrize("cancel", [False, True],
                         ids=["rows", "rows that cancel"])
@pytest.mark.parametrize("product", PRODUCTS)
@pytest.mark.parametrize("shape", SPLIT_CASES, ids=str)
def test_split_products_stay_near_f64(shape, product, cancel):
    """Each product from its parts, as the kernel sums them: every row
    within SSD_ROW_REL of the f64 sum, and no more than 4x as far from it
    as the plain f32 product."""
    a, b, ap, bp = _products(shape)[product]
    if cancel:
        a, b = _cancelling(a, b)
    exact = a.double() @ b.double()
    split = _row_rel(split_matmul(a, b, ap, bp), exact)
    plain = _row_rel(a @ b, exact)
    assert split < SSD_ROW_REL, (split, plain)
    assert split <= 4 * plain, (split, plain)


def test_two_part_split_misses_the_row_bound():
    """Why three parts: with two (about 16 bits of each operand; every
    part-product kept) rows that cancel to 1% of their terms miss
    SSD_ROW_REL, where three parts at the kernel's order stay within it
    (observed on the CPU: two 5.6e-4, three 1.8e-5).  At the largest test
    case's M^T dy."""
    a, b, _, _ = _products(SPLIT_CASES[-1])["dX += M^T dy"]
    a, b = _cancelling(a, b)
    exact = a.double() @ b.double()
    two = _row_rel(split_matmul(a, b, 2, 2, order=2), exact)
    three = _row_rel(split_matmul(a, b), exact)
    assert two > SSD_ROW_REL > three, (two, three)


def test_split_matmul_of_bf16_values_is_one_part():
    """An operand holding bf16 values is exact as its first part: with one
    part of it, the product equals the three-part product of it."""
    a, b, _, _ = _products(SPLIT_CASES[1])["X dS^T"]
    assert torch.equal(split_matmul(a, b, 1, 3), split_matmul(a, b, 3, 3))
