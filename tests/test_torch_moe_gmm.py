"""Port's grouped expert FFN (its plain version, on the CPU) vs the JAX Pallas
kernel in interpret mode and its jnp reference, over the cases of
tests/test_kernels.py, and the wrapper's refusals on CUDA tensors.

Inputs are drawn once with numpy and handed to both frameworks.  The CUDA
kernel itself runs only on the card: chip_smoke.py holds it against the same
plain version there."""
import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.moe_gmm.ops import grouped_ffn as jax_gffn  # noqa: E402
from repro.kernels.moe_gmm.ops import \
    grouped_ffn_reference as jax_gffn_ref  # noqa: E402
from repro_torch.kernels.moe_gmm import (grouped_ffn,  # noqa: E402
                                         grouped_ffn_reference)
from repro_torch.kernels.moe_gmm.ops import _check_cuda_inputs  # noqa: E402

F32_TOL = dict(atol=2e-5, rtol=1e-4)     # tests/test_kernels.py, f32
BF16_TOL = dict(atol=0.05, rtol=0.05)    # tests/test_kernels.py, bf16

# tests/test_kernels.py:115-120 -- B, E, C, D, F, act, bf (the TPU block)
GMM_CASES = [
    (2, 4, 8, 32, 64, "swiglu", 32),
    (1, 8, 16, 64, 100, "swiglu", 32),    # F not divisible by block
    (2, 2, 4, 16, 48, "gelu", 16),
    (1, 2, 8, 128, 256, "swiglu", 128),
]


def _inputs(b, e, c, d, f, seed=0):
    rng = np.random.default_rng(seed)
    return (0.5 * rng.standard_normal((b, e, c, d), np.float32),
            rng.standard_normal((e, d, f), np.float32) * d ** -0.5,
            rng.standard_normal((e, d, f), np.float32) * d ** -0.5,
            rng.standard_normal((e, f, d), np.float32) * f ** -0.5)


@pytest.mark.parametrize("case", GMM_CASES)
def test_port_gmm_matches_pallas_interpret_and_reference(case):
    b, e, c, d, f, act, bf = case
    arrs = _inputs(b, e, c, d, f)
    jx = [jnp.asarray(a) for a in arrs]
    pallas = jax_gffn(*jx, act=act, bf=bf, interpret=True)
    ref = jax_gffn_ref(*jx, act=act)
    before = grouped_ffn.launches
    got = grouped_ffn(*(torch.from_numpy(a) for a in arrs), act=act)
    assert grouped_ffn.launches == before   # CPU: plain version, no kernel
    assert got.dtype == torch.float32 and got.shape == (b, e, c, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **F32_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_port_gmm_bf16(act):
    # tests/test_kernels.py:134-150: bf16 inputs against the f32 reference
    arrs = _inputs(1, 2, 4, 32, 64, seed=1)
    jx = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrs]
    want = jax_gffn_ref(*(x.astype(jnp.float32) for x in jx), act=act)
    pallas = jax_gffn(*jx, act=act, interpret=True, bf=32)
    got = grouped_ffn(*(torch.from_numpy(a).to(torch.bfloat16)
                        for a in arrs), act=act)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               **BF16_TOL)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas, np.float32), **BF16_TOL)


def test_gelu_ignores_w_gate():
    buf, wi, wg, wo = (torch.from_numpy(a) for a in _inputs(2, 2, 4, 16, 48))
    want = grouped_ffn_reference(buf, wi, wg, wo, act="gelu")
    got = grouped_ffn(buf, wi, torch.zeros(1), wo, act="gelu")
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("kind", ["plain", "mixed_dtype", "bad_shape",
                                  "sliced_rows", "offset_pointer",
                                  "odd_width", "bad_act"])
def test_cuda_inputs_refused(kind):
    """What the CUDA kernel does not take.  The checks read only metadata,
    so they run on CPU tensors here."""
    buf, wi, wg, wo = _bf16(2, 4, 8, 32), _bf16(4, 32, 64), _bf16(4, 32, 64), \
        _bf16(4, 64, 32)
    act, err, match = "swiglu", ValueError, None
    if kind == "mixed_dtype":
        wg, err, match = wg.float(), TypeError, "one dtype"
    elif kind == "bad_shape":
        wo, match = _bf16(4, 32, 64), "shapes disagree"
    elif kind == "sliced_rows":     # row stride 33: not 16-byte aligned
        buf, match = _bf16(2, 4, 8, 33)[..., :32], "16-byte aligned"
    elif kind == "offset_pointer":  # data pointer 8 bytes past an alignment
        n = 4 * 32 * 64
        wi, match = _bf16(n + 4)[4:].view(4, 32, 64), "16-byte aligned"
    elif kind == "odd_width":       # F = 100 is fine in f32, not in bf16
        _check_cuda_inputs(*(x.float() for x in (
            buf, _bf16(4, 32, 100), _bf16(4, 32, 100), _bf16(4, 100, 32))),
            act)
        wi, wg, wo = _bf16(4, 32, 100), _bf16(4, 32, 100), _bf16(4, 100, 32)
        match = "16-byte aligned"
    if kind == "plain":
        _check_cuda_inputs(buf, wi, wg, wo, act)
    elif kind == "bad_act":
        with pytest.raises(ValueError, match="act must be"):
            grouped_ffn(buf, wi, wg, wo, act="relu")
    else:
        with pytest.raises(err, match=match):
            _check_cuda_inputs(buf, wi, wg, wo, act)


def test_cuda_tensor_never_takes_plain_version(monkeypatch):
    """On a CUDA tensor the wrapper checks and launches, or raises; it never
    calls the plain version.  Emulated here with the device check patched."""
    from repro_torch.kernels.moe_gmm import ops
    arrs = [torch.from_numpy(a) for a in _inputs(1, 2, 4, 16, 32)]
    calls = []
    monkeypatch.setattr(ops, "grouped_ffn_reference",
                        lambda *a, **k: calls.append("plain"))
    monkeypatch.setattr(ops, "grouped_ffn_cuda",
                        lambda *a, **k: calls.append("kernel") or a[0])
    monkeypatch.setattr(torch.Tensor, "device", property(
        lambda self: torch.device("cuda", 0)))
    before = ops.grouped_ffn.launches
    ops.grouped_ffn(*arrs)
    assert calls == ["kernel"] and ops.grouped_ffn.launches == before + 1
    with pytest.raises(TypeError, match="one dtype"):
        ops.grouped_ffn(arrs[0].to(torch.bfloat16), *arrs[1:])
    assert calls == ["kernel"] and ops.grouped_ffn.launches == before + 1
    ops.grouped_ffn.launches = before


def _occupied(b, e, c, d, f, occupancy, seed=0):
    """Inputs whose buffer is filled as the MoE dispatch fills it: dead
    experts and dead rows are exact zeros.  ``decode``: one token in slot 0 of
    2 distinct experts per batch row pair; ``last``: one expert whose only
    live row is the last (b, slot) of its (B, C) block; ``routed``: tokens
    in order into their experts' next free slots, expert 0 never chosen;
    ``zero``: nothing live."""
    buf, wi, wg, wo = _inputs(b, e, c, d, f, seed)
    rng = np.random.default_rng(seed + 1)
    mask = np.zeros((b, e, c, 1), np.float32)
    if occupancy == "decode":
        experts = rng.permutation(e)[:2]
        for i in range(b):
            mask[i, experts[i % 2], 0] = 1
    elif occupancy == "last":
        mask[b - 1, e // 2, c - 1] = 1
    elif occupancy == "routed":
        for i in range(b):
            fill = np.zeros(e, int)
            for ex in rng.integers(1, e, size=c * e // 2):
                if fill[ex] < c:
                    mask[i, ex, fill[ex]] = 1
                    fill[ex] += 1
    return buf * mask, wi, wg, wo


OCCUPANCY = [("decode", (4, 8, 4, 32, 64), "swiglu"),
             ("last", (2, 4, 8, 32, 64), "swiglu"),
             ("routed", (2, 6, 8, 32, 48), "swiglu"),
             ("routed", (2, 6, 8, 16, 48), "gelu"),
             ("zero", (1, 4, 4, 32, 64), "swiglu")]


@pytest.mark.parametrize("occupancy,shape,act", OCCUPANCY)
def test_port_gmm_dead_rows_match_jax_and_are_zero(occupancy, shape, act):
    """Buffers with dead experts and dead rows: the port equals the Pallas
    kernel in interpret mode and the jnp reference, and every dead row's
    output is exactly zero (what the CUDA kernel's skip rests on)."""
    arrs = _occupied(*shape, occupancy)
    jx = [jnp.asarray(a) for a in arrs]
    pallas = jax_gffn(*jx, act=act, bf=16, interpret=True)
    ref = jax_gffn_ref(*jx, act=act)
    got = grouped_ffn(*(torch.from_numpy(a) for a in arrs), act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **F32_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)
    dead = (arrs[0] == 0).all(-1)
    assert dead.any()
    assert np.array_equal(got.numpy()[dead], np.zeros_like(got.numpy()[dead]))
    assert np.array_equal(np.asarray(pallas)[dead],
                          np.zeros_like(got.numpy()[dead]))


@pytest.mark.parametrize("occupancy", ["decode", "last", "routed"])
def test_dead_experts_weights_are_never_read(occupancy):
    """The identity the skip rests on: replacing every dead expert's weights
    by other finite values leaves the output bit for bit the same."""
    shape = (4, 8, 4, 32, 64)
    buf, wi, wg, wo = _occupied(*shape, occupancy, seed=2)
    dead_e = ~(buf != 0).any(axis=(0, 2, 3))               # (E,)
    assert dead_e.any()
    rng = np.random.default_rng(5)
    other = [np.where(dead_e[:, None, None],
                      rng.standard_normal(w.shape).astype(np.float32) * 7.0,
                      w) for w in (wi, wg, wo)]
    want = grouped_ffn(*(torch.from_numpy(a) for a in (buf, wi, wg, wo)))
    got = grouped_ffn(*(torch.from_numpy(a) for a in (buf, *other)))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
