"""Port's hybrid family (zamba2: mamba2 layers with one shared attention +
MLP block every ``attn_every`` layers) vs the JAX package on bridged
weights: the shared attention layer at the smoke width and at zamba2's
served head dim 80 (JAX with an int window and ``kernel_mode="interpret"``,
which reaches the Pallas flash kernel), the smoke model's logits, prefill
cache and decode steps with JAX's SSD in "ref" and Pallas "interpret" mode,
the serving engine, and the port's own decode-vs-forward consistency.
Prompts of 1 and 2 tokens serve the full-forward greedy tokens (the
reference's engine does not: ROADMAP.md, faults of the reference)."""
import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.runtime import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import Model, attention  # noqa: E402
from repro_torch.models.api import flatten  # noqa: E402
from repro_torch.runtime import ServingEngine  # noqa: E402

ARCH = "zamba2-2.7b"
# f32 on both sides, only the order of sums differs (ROADMAP.md)
JAX_REL = 1e-5
DECODE_REL = 5e-4                      # tests/test_models.py:76
ATTN_TOL = dict(atol=3e-5, rtol=1e-4)  # tests/test_torch_attention.py
KEY = jax.random.PRNGKey(0)
F32_LEAVES = ("A_log", "D", "dt_bias")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


@pytest.mark.parametrize("head_dim", [16, 80])
def test_shared_attention_matches_jax(head_dim):
    """The shared block's causal attention at window 0; at hd 80, zamba2's
    served head dim, the JAX side runs the Pallas kernel in interpret
    mode and the port its flash wrapper's plain version."""
    jcfg = jax_smoke(ARCH).replace(head_dim=head_dim, kernel_mode="interpret")
    cfg = get_smoke(ARCH).replace(head_dim=head_dim)
    jp = jax.device_get(jattn.init_attn_params(KEY, jcfg, jnp.float32))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    b, s = 2, 20
    x = np.random.default_rng(1).standard_normal((b, s, cfg.d_model),
                                                 np.float32)
    pos = np.arange(s)[None, :]
    jy, (jk, jv) = jattn.full_attention(jp, jnp.asarray(x), jnp.asarray(pos),
                                        jcfg, window=0)
    before = flash_attention.launches
    ty, (tk, tv) = attention.full_attention(
        tp, torch.from_numpy(x), torch.from_numpy(pos), cfg, window=0)
    assert flash_attention.launches == before   # CPU: plain version
    assert tk.shape == (b, s, cfg.n_kv_heads, head_dim)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **ATTN_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **ATTN_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **ATTN_TOL)


@pytest.fixture(scope="module")
def jax_params():
    return JaxModel(jax_smoke(ARCH)).init(KEY)


def _pair(jp, mode="ref"):
    jm = JaxModel(jax_smoke(ARCH).replace(kernel_mode=mode))
    model = Model(get_smoke(ARCH), device="cpu").load_state(
        params_from_jax(jax.device_get(jp)))
    return jm, model


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, s))


def test_layout_is_the_reference_tree(jax_params):
    """(nb, pb, ...) mamba leaves and one unstacked shared block, as the
    JAX init lays them out; the cache likewise."""
    model = Model(get_smoke(ARCH), device="cpu")
    cfg = model.cfg
    nb, pb = cfg.n_layers // cfg.attn_every, cfg.attn_every
    want = {k: tuple(v.shape) for k, v in flatten(jax_params).items()}
    got = {k: tuple(p.shape) for k, p in model.named_parameters()}
    assert got == want
    assert got["layers.in_proj"][:2] == (nb, pb)
    assert got["shared.attn.wq"] == (cfg.d_model, cfg.n_heads, cfg.head_dim)
    cache = model.init_decode_cache(3, 40)
    jcache = JaxModel(jax_smoke(ARCH)).init_decode_cache(3, 40)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}


@pytest.mark.parametrize("mode", ["ref", "interpret"])
def test_forward_logits_match_jax(jax_params, mode):
    jm, model = _pair(jax_params, mode)
    toks = _tokens(model.cfg, 2, 20, seed=3)    # chunk 8: two and a tail
    want = jm.forward_logits(jax_params, {"tokens": jnp.asarray(toks)})
    got = model.forward_logits({"tokens": torch.as_tensor(toks)})
    assert got.shape == want.shape
    assert _rel(got, want) < JAX_REL


@pytest.mark.parametrize("mode", ["ref", "interpret"])
def test_prefill_and_decode_match_jax(jax_params, mode):
    jm, model = _pair(jax_params, mode)
    b, s = 2, 13
    toks = _tokens(model.cfg, b, s + 3)
    jl, jc = jm.prefill(jax_params, {"tokens": jnp.asarray(toks[:, :s])},
                        pad_to=s + 4)
    tl, tc = model.prefill({"tokens": torch.as_tensor(toks[:, :s])},
                           pad_to=s + 4)
    assert set(tc) == set(jc) == {"conv", "ssm", "k", "v", "pos"}
    assert _rel(tl, jl) < JAX_REL
    for key in ("conv", "ssm", "k", "v"):
        assert tc[key].shape == jc[key].shape, key
        assert _rel(tc[key], jc[key]) < JAX_REL, key
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))

    for t in range(s, s + 3):
        jl, jc = jm.decode_step(jax_params, jnp.asarray(toks[:, t:t + 1]),
                                jc)
        tl, tc2 = model.decode_step(torch.as_tensor(toks[:, t:t + 1]), tc)
        assert tc2 is tc                                # updated in place
        assert _rel(tl, jl) < JAX_REL
        for key in ("conv", "ssm", "k", "v"):
            assert _rel(tc[key], jc[key]) < JAX_REL, key
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))


def test_decode_matches_full_forward():
    cfg = get_smoke(ARCH)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    b, s = 2, 12
    toks = torch.as_tensor(_tokens(cfg, b, s + 4, seed=1))
    _, cache = model.prefill({"tokens": toks[:, :s]}, pad_to=s + 4)
    for t in range(s, s + 4):
        logits, cache = model.decode_step(toks[:, t:t + 1], cache)
        full = model.forward_logits({"tokens": toks[:, :t + 1]})[:, -1]
        assert _rel(logits, full) < DECODE_REL


def test_engine_tokens_match_jax(jax_params):
    jeng = JaxEngine(jax_smoke(ARCH), jax_params, slots=2, max_len=48)
    _, model = _pair(jax_params)
    teng = ServingEngine(model, slots=2, max_len=48, device="cpu")
    rng = np.random.default_rng(1)
    for n in (5, 20, 11, 16):
        p = rng.integers(0, model.cfg.vocab, size=n)
        jeng.submit(p.astype(np.int32), max_new=8)
        teng.submit(p, max_new=8)
    want = [(c.id, c.tokens) for c in jeng.run_until_drained()]
    got = [(c.id, c.tokens) for c in teng.run_until_drained()]
    assert len(got) == 4 and got == want


def _greedy_by_forward(logits_of, prompt, n):
    seq = list(prompt)
    for _ in range(n):
        seq.append(int(np.argmax(logits_of(np.asarray(seq)[None])[0, -1])))
    return seq[len(prompt):]


@pytest.mark.parametrize("n", [1, 2, 3])
def test_short_prompts_serve_full_forward_greedy(jax_params, n):
    """The port's left-padded conv tail carries over to the hybrid: 1- and
    2-token prompts serve the greedy tokens of the full forward, the JAX
    one's included."""
    jm, model = _pair(jax_params)
    prompt = (np.arange(n) * 37 + 11) % model.cfg.vocab
    eng = ServingEngine(model, slots=2, max_len=16, device="cpu")
    eng.submit(prompt, max_new=6)
    got = eng.run_until_drained()[0].tokens
    port = _greedy_by_forward(
        lambda t: model.forward_logits({"tokens": torch.as_tensor(t)})
        .numpy(), prompt, 6)
    ref = _greedy_by_forward(
        lambda t: np.asarray(jm.forward_logits(
            jax_params, {"tokens": jnp.asarray(t, jnp.int32)})), prompt, 6)
    assert got == port == ref


def test_engine_bf16_end_to_end():
    cfg = get_smoke(ARCH).replace(param_dtype="bfloat16",
                                  compute_dtype="bfloat16")
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    eng = ServingEngine(model, slots=2, max_len=32, device="cpu")
    nb = cfg.n_layers // cfg.attn_every
    assert eng.cache["k"].shape == (nb, 2, 32, cfg.n_kv_heads, cfg.head_dim)
    assert eng.cache["ssm"].shape[:3] == (nb, cfg.attn_every, 2)
    assert all(eng.cache[k].dtype == torch.bfloat16
               for k in ("conv", "ssm", "k", "v"))
    rng = np.random.default_rng(4)
    ids = [eng.submit(rng.integers(0, cfg.vocab, size=n), max_new=5)
           for n in (1, 7, 12)]
    done = eng.run_until_drained()
    assert sorted(c.id for c in done) == sorted(ids)
    assert all(len(c.tokens) == 5 for c in done)
    assert all(0 <= t < cfg.vocab for c in done for t in c.tokens)


def test_f32_leaves_stay_f32_in_bf16_model(jax_params):
    cfg = get_smoke(ARCH).replace(param_dtype="bfloat16",
                                  compute_dtype="bfloat16")
    model = Model(cfg, device="cpu").load_state(
        params_from_jax(jax.device_get(jax_params)))
    for name, p in flatten(model.params).items():
        want = torch.float32 if name.split(".")[-1] in F32_LEAVES \
            else torch.bfloat16
        assert p.dtype == want, name


def test_serve_cli_cpu(capsys):
    toks = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "9", "--gen", "4"])
    assert tuple(toks.shape) == (2, 4)
    assert "generated (2, 4) on cpu" in capsys.readouterr().out
