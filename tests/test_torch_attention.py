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
