"""Port's attention layer vs JAX on the same weights and inputs.

``full_attention`` is held against the JAX layer called with an int window
and ``kernel_mode="interpret"``, which reaches the Pallas flash kernel;
``decode_attention`` against the JAX decode path (plain jnp in both)."""
import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import attention  # noqa: E402

# f32 on both sides; only the order of sums differs (observed ~1e-6)
TOL = dict(atol=3e-5, rtol=1e-4)
CASES = [("deepseek-7b", 0), ("gemma3-27b", 8)]


def _setup(arch, seed=0):
    jcfg = jax_smoke(arch).replace(kernel_mode="interpret")
    jp = jax.device_get(jattn.init_attn_params(jax.random.PRNGKey(seed),
                                               jcfg, jnp.float32))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, get_smoke(arch), jp, tp


@pytest.mark.parametrize("arch,window", CASES)
def test_full_attention_matches_jax(arch, window):
    jcfg, cfg, jp, tp = _setup(arch)
    b, s = 2, 16
    x = np.random.default_rng(1).standard_normal((b, s, cfg.d_model),
                                                 np.float32)
    pos = np.arange(s)[None, :]
    jy, (jk, jv) = jattn.full_attention(jp, jnp.asarray(x), jnp.asarray(pos),
                                        jcfg, window=window)
    ty, (tk, tv) = attention.full_attention(
        tp, torch.from_numpy(x), torch.from_numpy(pos), cfg, window=window)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


@pytest.mark.parametrize("arch,window", CASES)
def test_decode_attention_matches_jax(arch, window):
    jcfg, cfg, jp, tp = _setup(arch)
    b, t = 3, 20
    rng = np.random.default_rng(2)
    x = rng.standard_normal((b, 1, cfg.d_model), np.float32)
    ck = rng.standard_normal((b, t, cfg.n_kv_heads, cfg.head_dim), np.float32)
    cv = rng.standard_normal((b, t, cfg.n_kv_heads, cfg.head_dim), np.float32)
    pos = np.array([0, 9, 19])
    jy, (jk, jv) = jattn.decode_attention(
        jp, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(pos, jnp.int32), jcfg, window=window)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    ty, (tk2, tv2) = attention.decode_attention(
        tp, torch.from_numpy(x), tk, tv, torch.from_numpy(pos), cfg,
        window=window)
    assert tk2 is tk and tv2 is tv            # updated in place
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("n", [2, 4, 16])
def test_combined_partials_equal_whole_attention(n, window):
    """Context-parallel decode's arithmetic: ``decode_partial`` of each of
    n contiguous slices of T positions, at the slices' global positions,
    stacked in slice order and combined (``combine_partials``), equals the
    whole attention
    (``_sdpa`` of every position, and JAX's) within 1e-6 in f32; slices
    with no unmasked position (past ``pos``, or before gemma3's window)
    give l = 0 and no NaN."""
    rng = np.random.default_rng(11)
    b, h, kh, hd, t = 2, 8, 2, 16, 64
    q = torch.from_numpy(rng.standard_normal((b, 1, h, hd), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, t, kh, hd),
                                                 np.float32))
            for _ in range(2))
    pos = torch.tensor([t // 2 + 1, t - 3])
    cols = torch.arange(t)[None, :]
    mask = cols <= pos[:, None]
    if window:
        mask &= cols > pos[:, None] - window
    mask = mask[:, None, None, :]
    want = attention._sdpa(q, k, v, mask)
    s = t // n
    parts = [attention.decode_partial(q, k[:, i * s:(i + 1) * s],
                                      v[:, i * s:(i + 1) * s],
                                      mask[..., i * s:(i + 1) * s])
             for i in range(n)]
    empty = [(r, i) for r in range(b) for i in range(n)
             if not mask[r, ..., i * s:(i + 1) * s].any()]
    assert empty or n == 2
    for r, i in empty:
        assert float(parts[i][1][r].abs().max()) == 0.0
    got = attention.combine_partials(*(torch.stack(leaf)
                                       for leaf in zip(*parts)))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    jwant = jattn._sdpa(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                        jnp.asarray(v.numpy()), jnp.asarray(mask.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("r", [0, 1, 2, 3])
def test_split_write_owns_its_positions_and_fails_alike(r):
    """Context-parallel decode's write on rank r of 4, each holding 4 of
    16 positions: a row whose position the rank holds is written there at
    its local position, a row held elsewhere leaves the rank's part as it
    was, and a position past the last rank's end raises on every rank, as
    past T does without a split."""
    t, n = 4, 4
    row = torch.ones(2, 1, 2)
    got = torch.zeros(2, t, 1, 2)
    attention._write(got, row, torch.tensor([r * t + 1, 0]),
                     (None, None, r, n))
    want = torch.zeros(2, t, 1, 2)
    want[0, 1] = 1.0
    if r == 0:
        want[1, 0] = 1.0
    assert torch.equal(got, want)
    with pytest.raises(IndexError):
        attention._write(torch.zeros(2, t, 1, 2), row,
                         torch.tensor([1, n * t]), (None, None, r, n))
    with pytest.raises(IndexError):
        attention._write(torch.zeros(2, n * t, 1, 2), row,
                         torch.tensor([1, n * t]), None)
