"""Port's dense LM vs the JAX LM on bridged weights, and the port's own
decode-vs-full-forward consistency (tests/test_models.py:57-93)."""
import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import Model  # noqa: E402

DENSE = ["deepseek-7b", "phi4-mini-3.8b", "granite-34b", "gemma3-27b"]
# JAX parity: f32 on both sides, only the order of sums differs (observed
# <= 1e-6 relative); decode vs full forward: tests/test_models.py:76
JAX_REL = 1e-5
DECODE_REL = 5e-4
KEY = jax.random.PRNGKey(0)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def _pair(arch):
    jm = JaxModel(jax_smoke(arch))
    jp = jm.init(KEY)
    model = Model(get_smoke(arch), device="cpu").load_state(
        params_from_jax(jax.device_get(jp)))
    return jm, jp, model


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, s))


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_jax(arch):
    jm, jp, model = _pair(arch)
    b, s = 2, 12
    toks = _tokens(model.cfg, b, s + 1)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])},
                        pad_to=s + 4)
    tl, tc = model.prefill({"tokens": torch.as_tensor(toks[:, :s])},
                           pad_to=s + 4)
    assert _rel(tl, jl) < JAX_REL
    for key in ("k", "v"):
        assert tc[key].shape == jc[key].shape
        assert _rel(tc[key], jc[key]) < JAX_REL
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))

    jl2, jc2 = jm.decode_step(jp, jnp.asarray(toks[:, s:]), jc)
    tl2, tc2 = model.decode_step(torch.as_tensor(toks[:, s:]), tc)
    assert tc2 is tc                                  # updated in place
    assert _rel(tl2, jl2) < JAX_REL
    for key in ("k", "v"):
        assert _rel(tc2[key], jc2[key]) < JAX_REL
    np.testing.assert_array_equal(tc2["pos"].numpy(), np.asarray(jc2["pos"]))


@pytest.mark.parametrize("arch", DENSE)
def test_forward_logits_match_jax(arch):
    jm, jp, model = _pair(arch)
    toks = _tokens(model.cfg, 2, 16, seed=3)
    want = jm.forward_logits(jp, {"tokens": jnp.asarray(toks)})
    got = model.forward_logits({"tokens": torch.as_tensor(toks)})
    assert got.shape == want.shape
    assert _rel(got, want) < JAX_REL


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_full_forward(arch):
    cfg = get_smoke(arch)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    b, s = 2, 12
    toks = torch.as_tensor(_tokens(cfg, b, s + 1, seed=1))
    ref = model.forward_logits({"tokens": toks})[:, -1, :]
    _, cache = model.prefill({"tokens": toks[:, :s]}, pad_to=s + 4)
    got, _ = model.decode_step(toks[:, s:s + 1], cache)
    assert _rel(got, ref) < DECODE_REL


def test_multi_token_decode_consistency():
    cfg = get_smoke("deepseek-7b")
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    b, s, g = 2, 8, 4
    toks = torch.as_tensor(_tokens(cfg, b, s + g, seed=2))
    full = model.forward_logits({"tokens": toks})
    _, cache = model.prefill({"tokens": toks[:, :s]}, pad_to=s + g)
    for i in range(g):
        got, cache = model.decode_step(toks[:, s + i:s + i + 1], cache)
        assert _rel(got, full[:, s + i, :]) < DECODE_REL, f"step {i}"
