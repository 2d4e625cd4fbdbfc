"""Port's SSM family (mamba2) vs the JAX package on bridged weights: the
Mamba2 block (``mamba_forward``, ``mamba_decode``), the mamba2 smoke model
(logits, prefill cache, decode steps) with JAX's SSD in "ref" and Pallas
"interpret" mode, the serving engine, and the port's own chunk invariance
and decode-vs-forward consistency.  Also the short-prompt repair: prompts of
1 and 2 tokens serve the full-forward greedy tokens."""
import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models.ssm import init_mamba_params as jax_init  # noqa: E402
from repro.models.ssm import mamba_decode as jax_decode  # noqa: E402
from repro.models.ssm import mamba_forward as jax_forward  # noqa: E402
from repro.runtime import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.api import flatten  # noqa: E402
from repro_torch.models.ssm import mamba_decode, mamba_forward  # noqa: E402
from repro_torch.runtime import ServingEngine  # noqa: E402

ARCH = "mamba2-780m"
# f32 on both sides, only the order of sums differs (ROADMAP.md)
JAX_REL = 1e-5
DECODE_REL = 5e-4                      # tests/test_models.py:76
CHUNK_ATOL = 2e-4                      # tests/test_models.py:143-144
KEY = jax.random.PRNGKey(0)
F32_LEAVES = ("A_log", "D", "dt_bias")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def _block(mode):
    jcfg = jax_smoke(ARCH).replace(kernel_mode=mode)
    jp = jax.device_get(jax_init(KEY, jcfg, jnp.float32))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, get_smoke(ARCH), jp, tp


@pytest.mark.parametrize("mode", ["ref", "interpret"])
@pytest.mark.parametrize("s", [2, 13])
def test_mamba_forward_matches_jax(s, mode):
    jcfg, cfg, jp, tp = _block(mode)
    x = np.random.default_rng(s).standard_normal((2, s, cfg.d_model),
                                                 np.float32)
    jy, (jconv, jssm) = jax_forward(jp, jnp.asarray(x), jcfg,
                                    return_state=True)
    y, (conv, ssm) = mamba_forward(tp, torch.from_numpy(x), cfg,
                                   return_state=True)
    assert _rel(y, jy) < JAX_REL
    assert _rel(ssm, jssm) < JAX_REL
    k1 = cfg.ssm_conv - 1
    assert conv.shape == (2, k1, cfg.d_inner + 2 * cfg.ssm_state)
    # the reference returns min(S, K-1) rows; the port left-pads with zeros
    rows = min(s, k1)
    assert _rel(conv[:, k1 - rows:], jconv) < JAX_REL
    assert not conv[:, :k1 - rows].any()


def test_mamba_decode_matches_jax():
    jcfg, cfg, jp, tp = _block("ref")
    rng = np.random.default_rng(1)
    c = cfg.d_inner + 2 * cfg.ssm_state
    x1 = rng.standard_normal((2, 1, cfg.d_model), np.float32)
    conv = rng.standard_normal((2, cfg.ssm_conv - 1, c), np.float32)
    ssm = rng.standard_normal((2, cfg.ssm_heads, cfg.ssm_state,
                               cfg.ssm_head_dim), np.float32)
    jy, (jconv, jssm) = jax_decode(jp, jnp.asarray(x1), jnp.asarray(conv),
                                   jnp.asarray(ssm), jcfg)
    y, (nconv, nssm) = mamba_decode(tp, torch.from_numpy(x1),
                                    torch.from_numpy(conv),
                                    torch.from_numpy(ssm), cfg)
    assert _rel(y, jy) < JAX_REL
    assert _rel(nconv, jconv) < JAX_REL
    assert _rel(nssm, jssm) < JAX_REL
    assert nssm.dtype == torch.float32


def _pair(mode="ref", cfg_port=None):
    jm = JaxModel(jax_smoke(ARCH).replace(kernel_mode=mode))
    jp = jm.init(KEY)
    model = Model(cfg_port or get_smoke(ARCH), device="cpu").load_state(
        params_from_jax(jax.device_get(jp)))
    return jm, jp, model


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, s))


@pytest.mark.parametrize("mode", ["ref", "interpret"])
def test_prefill_and_decode_match_jax(mode):
    jm, jp, model = _pair(mode)
    b, s = 2, 13                       # chunk 8: one full chunk and a tail
    toks = _tokens(model.cfg, b, s + 3)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])},
                        pad_to=s + 4)
    tl, tc = model.prefill({"tokens": torch.as_tensor(toks[:, :s])},
                           pad_to=s + 4)
    assert set(tc) == set(jc) == {"conv", "ssm", "pos"}
    assert _rel(tl, jl) < JAX_REL
    for key in ("conv", "ssm"):
        assert tc[key].shape == jc[key].shape
        assert _rel(tc[key], jc[key]) < JAX_REL
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))

    for t in range(s, s + 3):
        jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]), jc)
        tl, tc2 = model.decode_step(torch.as_tensor(toks[:, t:t + 1]), tc)
        assert tc2 is tc                                # updated in place
        assert _rel(tl, jl) < JAX_REL
        for key in ("conv", "ssm"):
            assert _rel(tc[key], jc[key]) < JAX_REL
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))


@pytest.mark.parametrize("mode", ["ref", "interpret"])
def test_forward_logits_match_jax(mode):
    jm, jp, model = _pair(mode)
    toks = _tokens(model.cfg, 2, 24, seed=3)
    want = jm.forward_logits(jp, {"tokens": jnp.asarray(toks)})
    got = model.forward_logits({"tokens": torch.as_tensor(toks)})
    assert got.shape == want.shape
    assert _rel(got, want) < JAX_REL


@pytest.mark.parametrize("chunk", [4, 24])
def test_chunk_invariance(chunk):
    # port of tests/test_models.py::test_ssd_chunk_invariance
    cfg = get_smoke(ARCH)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    other = Model(cfg.replace(ssm_chunk=chunk), device="cpu").load_state(
        model.state_dict())
    batch = {"tokens": torch.as_tensor(_tokens(cfg, 1, 24, seed=2))}
    np.testing.assert_allclose(other.forward_logits(batch).numpy(),
                               model.forward_logits(batch).numpy(),
                               atol=CHUNK_ATOL)


def test_decode_matches_full_forward():
    cfg = get_smoke(ARCH)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    b, s = 2, 12
    toks = torch.as_tensor(_tokens(cfg, b, s + 4, seed=1))
    _, cache = model.prefill({"tokens": toks[:, :s]})
    for t in range(s, s + 4):
        logits, cache = model.decode_step(toks[:, t:t + 1], cache)
        full = model.forward_logits({"tokens": toks[:, :t + 1]})[:, -1]
        assert _rel(logits, full) < DECODE_REL


def _engines(slots, max_len=48):
    jcfg = jax_smoke(ARCH)
    jp = JaxModel(jcfg).init(KEY)
    model = Model(get_smoke(ARCH), device="cpu").load_state(
        params_from_jax(jax.device_get(jp)))
    return (JaxEngine(jcfg, jp, slots=slots, max_len=max_len),
            ServingEngine(model, slots=slots, max_len=max_len, device="cpu"))


def _prompts_single(vocab):
    # tests/test_serving.py::test_engine_ssm_family
    rng = np.random.default_rng(1)
    return [(rng.integers(0, vocab, size=8), 4)]


def _prompts_mixed(vocab):
    rng = np.random.default_rng(0)
    return [(rng.integers(0, vocab, size=n), 4) for n in (3, 9, 5, 17, 4)]


@pytest.mark.parametrize("slots,prompts", [(2, _prompts_single),
                                           (2, _prompts_mixed)])
def test_engine_tokens_match_jax(slots, prompts):
    jeng, teng = _engines(slots)
    for p, n in prompts(teng.cfg.vocab):
        jeng.submit(p.astype(np.int32), max_new=n)
        teng.submit(p, max_new=n)
    want = [(c.id, c.tokens) for c in jeng.run_until_drained()]
    got = [(c.id, c.tokens) for c in teng.run_until_drained()]
    assert got == want


def _greedy_by_forward(logits_of, prompt, n):
    seq = list(prompt)
    for _ in range(n):
        seq.append(int(np.argmax(logits_of(np.asarray(seq)[None])[0, -1])))
    return seq[len(prompt):]


@pytest.mark.parametrize("n", [1, 2, 3])
def test_short_prompts_serve_full_forward_greedy(n):
    """The reference engine serves 1- and 2-token prompts wrongly (ROADMAP.md,
    faults of the reference); the port's left-padded conv tail does not."""
    jm = JaxModel(jax_smoke(ARCH))
    jp = jm.init(KEY)
    model = Model(get_smoke(ARCH), device="cpu").load_state(
        params_from_jax(jax.device_get(jp)))
    prompt = (np.arange(n) * 37 + 11) % model.cfg.vocab
    eng = ServingEngine(model, slots=2, max_len=16, device="cpu")
    eng.submit(prompt, max_new=6)
    got = eng.run_until_drained()[0].tokens
    port = _greedy_by_forward(
        lambda t: model.forward_logits({"tokens": torch.as_tensor(t)})
        .numpy(), prompt, 6)
    ref = _greedy_by_forward(
        lambda t: np.asarray(jm.forward_logits(
            jp, {"tokens": jnp.asarray(t, jnp.int32)})), prompt, 6)
    assert got == port == ref


def test_engine_bf16_end_to_end():
    cfg = get_smoke(ARCH).replace(param_dtype="bfloat16",
                                  compute_dtype="bfloat16")
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    eng = ServingEngine(model, slots=2, max_len=32, device="cpu")
    assert eng.cache["conv"].dtype == eng.cache["ssm"].dtype == torch.bfloat16
    assert eng.cache["ssm"].shape == (cfg.n_layers, 2, cfg.ssm_heads,
                                      cfg.ssm_state, cfg.ssm_head_dim)
    rng = np.random.default_rng(4)
    ids = [eng.submit(rng.integers(0, cfg.vocab, size=n), max_new=5)
           for n in (1, 7, 12)]
    done = eng.run_until_drained()
    assert sorted(c.id for c in done) == sorted(ids)
    assert all(len(c.tokens) == 5 for c in done)
    assert all(0 <= t < cfg.vocab for c in done for t in c.tokens)
    assert eng.cache["conv"].dtype == eng.cache["ssm"].dtype == torch.bfloat16


def test_f32_leaves_stay_f32_in_bf16_model():
    cfg = get_smoke(ARCH).replace(param_dtype="bfloat16",
                                  compute_dtype="bfloat16")
    jp = JaxModel(jax_smoke(ARCH)).init(KEY)          # an all-f32 tree
    model = Model(cfg, device="cpu").load_state(
        params_from_jax(jax.device_get(jp)))
    for name, p in flatten(model.params).items():
        want = torch.float32 if name.split(".")[-1] in F32_LEAVES \
            else torch.bfloat16
        assert p.dtype == want, name
    a_log = dict(model.named_parameters())["layers.A_log"]
    torch.testing.assert_close(
        a_log, torch.log(torch.linspace(1.0, 16.0, cfg.ssm_heads))
        .expand(cfg.n_layers, -1))


def test_serve_cli_cpu(capsys):
    toks = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "9", "--gen", "4"])
    assert tuple(toks.shape) == (2, 4)
    assert "generated (2, 4) on cpu" in capsys.readouterr().out
