"""Port's flash attention (its plain version, on the CPU) vs the JAX Pallas
kernel in interpret mode, over the cases of tests/test_kernels.py and at
zamba2's head dim 80.

Inputs are drawn once with numpy and handed to both frameworks.  The CUDA
kernel itself runs only on the card: chip_smoke.py holds it against the same
plain version there."""
import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_kernels import FLASH_CASES  # noqa: E402

from repro.kernels.flash_attention.ops import \
    flash_attention as jax_flash  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ops import \
    _check_cuda_inputs  # noqa: E402

F32_TOL = dict(atol=3e-5, rtol=1e-4)     # tests/test_kernels.py, f32
BF16_TOL = dict(atol=2e-2, rtol=2e-2)    # tests/test_kernels.py, bf16


def _qkv(b, sq, skv, h, k, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, hd), np.float32),
            rng.standard_normal((b, skv, k, hd), np.float32),
            rng.standard_normal((b, skv, k, hd), np.float32))


@pytest.mark.parametrize("case", FLASH_CASES)
def test_port_flash_matches_pallas_interpret(case):
    b, sq, skv, h, k, hd, causal, window, bq, bk = case
    q, kk, v = _qkv(b, sq, skv, h, k, hd)
    want = jax_flash(jnp.asarray(q), jnp.asarray(kk), jnp.asarray(v),
                     causal=causal, window=window, interpret=True, bq=bq,
                     bk=bk)
    before = flash_attention.launches
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(kk),
                          torch.from_numpy(v), causal=causal, window=window)
    assert flash_attention.launches == before   # CPU: plain version, no kernel
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_flash_dtypes(dtype):
    q, k, v = _qkv(1, 64, 64, 4, 2, 32, seed=1)
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    want = jax_flash(jq, jk, jv, interpret=True, bq=32, bk=32)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = flash_attention(tq, tk, tv)
    assert got.dtype == tdt
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    assert flash_attention.launches == 0


# zamba2's head dim 80 (no Pallas test case has it): B, Sq, Skv, H, K,
# causal, window -- ragged S, a kv prefix with MQA, GQA with a window, and
# no causal mask
HD80_CASES = [(1, 100, 100, 4, 4, True, 0), (2, 32, 128, 4, 1, True, 0),
              (1, 128, 128, 8, 2, True, 24), (1, 96, 96, 2, 2, False, 0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", HD80_CASES)
def test_port_flash_hd80_matches_pallas_interpret(case, dtype):
    b, sq, skv, h, k, causal, window = case
    q, kk, v = _qkv(b, sq, skv, h, k, 80, seed=2)
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, kk, v))
    want = jax_flash(jq, jk, jv, causal=causal, window=window,
                     interpret=True, bq=32, bk=32)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, kk, v))
    before = flash_attention.launches
    got = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert flash_attention.launches == before   # CPU: plain version, no kernel
    assert got.dtype == tdt and got.shape == (b, sq, h, 80)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_inputs_take_hd80(dtype):
    """hd 80 (zamba2) is a head dim the kernel takes in both dtypes: bf16 on
    the mma.sync body, f32 on FMAs; 96 is not.  Metadata only: CPU
    tensors."""
    q = torch.zeros(1, 8, 4, 80, dtype=dtype)
    kv = torch.zeros(1, 8, 2, 80, dtype=dtype)
    _check_cuda_inputs(q, kv, kv)
    q96 = torch.zeros(1, 8, 4, 96, dtype=dtype)
    with pytest.raises(ValueError, match="head dim 96"):
        _check_cuda_inputs(q96, q96, q96)


def _layout(kind, dtype):
    shape = (1, 8, 2, 64)
    if kind == "sliced":            # row stride 65: rows not 16-byte aligned
        return torch.zeros(1, 8, 2, 65, dtype=dtype)[..., :64]
    if kind == "offset":            # data pointer 8 bytes past an alignment
        n = 8 * 2 * 64
        return torch.zeros(n + 4, dtype=dtype)[4:].view(shape)
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("kind,dtype,ok", [
    ("plain", torch.bfloat16, True), ("sliced", torch.bfloat16, False),
    ("offset", torch.bfloat16, False), ("sliced", torch.float32, True),
    ("offset", torch.float32, True)])
def test_cuda_inputs_bf16_rows_must_be_aligned(kind, dtype, ok):
    """The bf16 kernel loads rows 16 bytes at a time; the wrapper refuses
    rows that do not start 16-byte aligned (f32 stages element by element).
    The check reads only metadata, so it runs on CPU tensors here."""
    q = _layout(kind, dtype)
    kv = torch.zeros(1, 8, 2, 64, dtype=dtype)
    if ok:
        _check_cuda_inputs(q, kv, kv)
    else:
        with pytest.raises(ValueError, match="16-byte aligned"):
            _check_cuda_inputs(q, kv, kv)


@pytest.mark.parametrize("hd,dtype,ok", [
    (64, torch.bfloat16, False), (128, torch.bfloat16, False),
    (32, torch.bfloat16, True), (80, torch.bfloat16, True),
    (128, torch.float32, True)])
def test_cuda_inputs_tma_strides(hd, dtype, ok):
    """At hd 64 and 128 the bf16 kernel reads q, k, v through TMA tensor
    maps, which take no zero stride: a kv head broadcast by ``expand`` is
    refused there, and taken by the mma.sync (hd 16, 32, 80) and f32
    kernels, which address rows themselves.  Metadata only: CPU tensors."""
    q = torch.zeros(1, 8, 2, hd, dtype=dtype)
    kv = torch.zeros(1, 8, 1, hd, dtype=dtype).expand(1, 8, 2, hd)
    _check_cuda_inputs(q, q, q)
    if ok:
        _check_cuda_inputs(q, kv, kv)
    else:
        with pytest.raises(ValueError, match="TMA"):
            _check_cuda_inputs(q, kv, kv)


@pytest.mark.parametrize("hd,ok", [(64, False), (128, False), (80, True)])
def test_cuda_inputs_do_tma_strides(hd, ok):
    """The wgmma backward (bf16, hd 64 and 128) reads do through a TMA
    tensor map too: a do with a zero stride is refused there, and taken by
    the mma.sync (hd 80) body, which addresses rows itself."""
    q = torch.zeros(1, 8, 2, hd, dtype=torch.bfloat16)
    broadcast = torch.zeros(1, 8, 1, hd, dtype=torch.bfloat16).expand(
        1, 8, 2, hd)
    _check_cuda_inputs(q, q, q, torch.zeros_like(q))
    if ok:
        _check_cuda_inputs(q, q, q, broadcast)
    else:
        with pytest.raises(ValueError, match="TMA"):
            _check_cuda_inputs(q, q, q, broadcast)
