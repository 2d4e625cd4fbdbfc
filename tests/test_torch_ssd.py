"""Port's SSD primitive (its plain versions, on the CPU) vs the JAX package:
``ssd_intra_chunk`` against the JAX oracle and the Pallas kernel in
interpret mode, at the cases of tests/test_kernels.py and one ragged
full-width case; ``ssd_reference`` and ``ssd_chunked`` against the JAX ones
and the recurrence; and the wrapper's refusals on CUDA tensors.

Inputs are drawn once with numpy and handed to both frameworks.  The CUDA
kernel itself runs only on the card: chip_smoke.py holds it against the same
plain version there."""
import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd.ops import ssd_intra_chunk as jax_intra  # noqa: E402
from repro.kernels.ssd.ref import \
    ssd_intra_chunk_reference as jax_intra_ref  # noqa: E402
from repro.kernels.ssd.ref import ssd_reference as jax_ssd_ref  # noqa: E402
from repro.models.ssm import ssd_chunked as jax_chunked  # noqa: E402
from repro_torch.kernels.ssd import (ssd_intra_chunk,  # noqa: E402
                                     ssd_intra_chunk_reference,
                                     ssd_reference)
from repro_torch.kernels.ssd.ops import _check_cuda_inputs  # noqa: E402
from repro_torch.models.ssm import ssd_chunked  # noqa: E402

KERNEL_TOL = dict(atol=2e-4, rtol=1e-3)      # tests/test_kernels.py:94-97
CHUNKED_TOL = dict(atol=1e-3, rtol=1e-3)     # tests/test_kernels.py:75-78
PALLAS_ATOL = 1e-4                           # tests/test_kernels.py:110-111
# stepwise recurrences in f32 on both sides: only the order of sums differs
REF_TOL = dict(atol=1e-5, rtol=1e-5)

# tests/test_kernels.py:81-83 -- B, NC, L, H, P, N
SHAPES = [(2, 2, 16, 4, 8, 16), (1, 4, 32, 2, 16, 8), (2, 1, 64, 8, 32, 32),
          (1, 2, 128, 4, 64, 64)]


def _softplus(x):
    return np.logaddexp(0.0, x).astype(np.float32)


def _intra_inputs(b, nc, l, h, p, n, seed=0, a=None):
    """xc, dtc, cum, bc, cc as numpy f32.  ``cum`` is cumsum(-0.1 dt) as in
    tests/test_kernels.py, or cumsum(dt A) for the given per-head ``a``."""
    rng = np.random.default_rng(seed)
    xc = rng.standard_normal((b, nc, l, h, p), np.float32)
    dtc = _softplus(rng.standard_normal((b, nc, l, h), np.float32))
    da = dtc * (np.float32(-0.1) if a is None else a.astype(np.float32))
    cum = np.cumsum(da, axis=2, dtype=np.float32)
    bc = rng.standard_normal((b, nc, l, n), np.float32)
    cc = rng.standard_normal((b, nc, l, n), np.float32)
    return xc, dtc, cum, bc, cc


def _check_intra(arrs, x_bf16=False):
    jx = [jnp.asarray(a) for a in arrs]
    tx = [torch.from_numpy(a) for a in arrs]
    if x_bf16:
        jx[0] = jx[0].astype(jnp.bfloat16)
        tx[0] = tx[0].to(torch.bfloat16)
    before = ssd_intra_chunk.launches
    y, st = ssd_intra_chunk(*tx)
    assert ssd_intra_chunk.launches == before   # CPU: plain version
    b, nc, l, h, p = arrs[0].shape
    n = arrs[3].shape[-1]
    assert y.dtype == st.dtype == torch.float32
    assert y.shape == (b, nc, l, h, p) and st.shape == (b, nc, h, n, p)
    for want in (jax_intra_ref(*jx), jax_intra(*jx, interpret=True)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want[0]),
                                   **KERNEL_TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(want[1]),
                                   **KERNEL_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_port_intra_chunk_matches_jax_oracle_and_pallas(shape):
    _check_intra(_intra_inputs(*shape))


def test_port_intra_chunk_ragged_full_width_bf16():
    # a 75-token prompt at mamba2-780m's N 128 and P 64, x in bf16, and the
    # model's decay rates A = -linspace(1, 16, H)
    h = 3
    a = -np.linspace(1.0, 16.0, h)
    _check_intra(_intra_inputs(1, 1, 75, h, 64, 128, seed=5, a=a),
                 x_bf16=True)


def test_intra_chunk_reference_is_the_kernel_function():
    """The CPU wrapper is exactly the plain version."""
    tx = [torch.from_numpy(a) for a in _intra_inputs(1, 2, 16, 2, 8, 4)]
    for got, want in zip(ssd_intra_chunk(*tx),
                         ssd_intra_chunk_reference(*tx)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def _ssd_inputs(s, h, seed, b=2, p=8, n=4):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((b, s, h, p), np.float32)
    dt = _softplus(rng.standard_normal((b, s, h), np.float32))
    a_log = np.log(np.linspace(1.0, 8.0, h)).astype(np.float32)
    bm = rng.standard_normal((b, s, n), np.float32)
    cm = rng.standard_normal((b, s, n), np.float32)
    return xh, dt, a_log, bm, cm


@pytest.mark.parametrize("h", [1, 2, 4])
@pytest.mark.parametrize("s", [8, 16, 17, 31])
def test_ssd_chunked_matches_recurrence_and_jax(s, h):
    # port of tests/test_kernels.py::test_ssd_chunked_matches_recurrence,
    # plus the JAX recurrence and JAX ssd_chunked in "ref" and "interpret"
    arrs = _ssd_inputs(s, h, seed=s * 10 + h)
    tx = [torch.from_numpy(a) for a in arrs]
    jx = [jnp.asarray(a) for a in arrs]
    y_ref, h_ref = ssd_reference(*tx)
    jy_ref, jh_ref = jax_ssd_ref(*jx)
    np.testing.assert_allclose(y_ref.numpy(), np.asarray(jy_ref), **REF_TOL)
    np.testing.assert_allclose(h_ref.numpy(), np.asarray(jh_ref), **REF_TOL)

    y, hf = ssd_chunked(*tx, chunk=8)
    assert y.dtype == torch.float32 and hf.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), **CHUNKED_TOL)
    np.testing.assert_allclose(hf.numpy(), h_ref.numpy(), **CHUNKED_TOL)
    for mode in ("ref", "interpret"):
        jy, jh = jax_chunked(*jx, chunk=8, kernel_mode=mode)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy),
                                   atol=PALLAS_ATOL)
        np.testing.assert_allclose(hf.numpy(), np.asarray(jh),
                                   atol=PALLAS_ATOL)


def test_ssd_chunked_carries_h_init():
    arrs = _ssd_inputs(13, 2, seed=7)
    h0 = np.random.default_rng(8).standard_normal((2, 2, 4, 8), np.float32)
    tx = [torch.from_numpy(a) for a in arrs]
    y, hf = ssd_chunked(*tx, chunk=4, h_init=torch.from_numpy(h0))
    y_ref, h_ref = ssd_reference(*tx, h_init=torch.from_numpy(h0))
    jy, jh = jax_chunked(*(jnp.asarray(a) for a in arrs), chunk=4,
                         h_init=jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), **CHUNKED_TOL)
    np.testing.assert_allclose(hf.numpy(), h_ref.numpy(), **CHUNKED_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=PALLAS_ATOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(jh), atol=PALLAS_ATOL)


def _zeros(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("kind", ["plain", "plain_bf16_x", "half_x",
                                  "bf16_dt", "bf16_b", "bad_shape",
                                  "long_chunk", "wide_state", "wide_head",
                                  "strided_last_dim", "empty"])
def test_cuda_inputs_refused(kind):
    """What the CUDA kernel does not take.  The checks read only metadata,
    so they run on CPU tensors here."""
    b, nc, l, h, p, n = 1, 2, 16, 4, 64, 128
    xc, dtc, cum = _zeros(b, nc, l, h, p), _zeros(b, nc, l, h), \
        _zeros(b, nc, l, h)
    bc, cc = _zeros(b, nc, l, n), _zeros(b, nc, l, n)
    err, match = ValueError, None
    if kind == "plain_bf16_x":
        xc = xc.to(torch.bfloat16)
    elif kind == "half_x":
        xc, err, match = xc.half(), TypeError, "float32 or bfloat16"
    elif kind == "bf16_dt":
        dtc, err, match = dtc.to(torch.bfloat16), TypeError, "float32"
    elif kind == "bf16_b":
        bc, err, match = bc.to(torch.bfloat16), TypeError, "float32"
    elif kind == "bad_shape":
        cc, match = _zeros(b, nc, l, n + 1), "shapes disagree"
    elif kind == "long_chunk":      # L 257
        xc, dtc, cum = _zeros(b, 1, 257, h, p), _zeros(b, 1, 257, h), \
            _zeros(b, 1, 257, h)
        bc, cc = _zeros(b, 1, 257, n), _zeros(b, 1, 257, n)
        match = "L <= 256"
    elif kind == "wide_state":      # N 129
        bc, cc, match = _zeros(b, nc, l, 129), _zeros(b, nc, l, 129), \
            "N <= 128"
    elif kind == "wide_head":       # P 65
        xc, match = _zeros(b, nc, l, h, 65), "P <= 64"
    elif kind == "strided_last_dim":
        bc, match = _zeros(b, nc, l, 2 * n)[..., ::2], "contiguous"
    elif kind == "empty":
        xc, dtc, cum = _zeros(b, nc, 0, h, p), _zeros(b, nc, 0, h), \
            _zeros(b, nc, 0, h)
        bc, cc, match = _zeros(b, nc, 0, n), _zeros(b, nc, 0, n), "empty"
    if kind.startswith("plain"):
        _check_cuda_inputs(xc, dtc, cum, bc, cc)
    else:
        with pytest.raises(err, match=match):
            _check_cuda_inputs(xc, dtc, cum, bc, cc)


def test_strided_views_are_taken():
    """The model hands in views of its projection (x, B and C sliced out of
    one (B,S,C) tensor): the kernel reads them through their strides."""
    b, nc, l, h, p, n = 1, 2, 8, 2, 16, 16
    xbc = _zeros(b, nc * l, h * p + 2 * n)
    xc = xbc[..., :h * p].reshape(b, nc, l, h, p)
    bc = xbc[..., h * p:h * p + n].reshape(b, nc, l, n)
    cc = xbc[..., h * p + n:].reshape(b, nc, l, n)
    assert not xc.is_contiguous() and not bc.is_contiguous()
    _check_cuda_inputs(xc, _zeros(b, nc, l, h), _zeros(b, nc, l, h), bc, cc)


def test_cuda_tensor_never_takes_plain_version(monkeypatch):
    """On CUDA tensors the wrapper checks and launches, or raises; it never
    calls the plain version.  Emulated here with the device check patched."""
    from repro_torch.kernels.ssd import ops
    arrs = [torch.from_numpy(a) for a in _intra_inputs(1, 1, 8, 2, 8, 4)]
    calls = []
    monkeypatch.setattr(ops, "ssd_intra_chunk_reference",
                        lambda *a, **k: calls.append("plain"))
    monkeypatch.setattr(ops, "ssd_intra_chunk_cuda",
                        lambda *a, **k: calls.append("kernel") or a[:2])
    monkeypatch.setattr(torch.Tensor, "device", property(
        lambda self: torch.device("cuda", 0)))
    before = ops.ssd_intra_chunk.launches
    ops.ssd_intra_chunk(*arrs)
    assert calls == ["kernel"] and ops.ssd_intra_chunk.launches == before + 1
    with pytest.raises(TypeError, match="float32"):
        ops.ssd_intra_chunk(arrs[0], arrs[1].double(), *arrs[2:])
    assert calls == ["kernel"] and ops.ssd_intra_chunk.launches == before + 1
    ops.ssd_intra_chunk.launches = before
