"""Port's ServingEngine vs the JAX engine on bridged weights (greedy tokens
equal, for the dense cases of tests/test_serving.py), a bf16 engine end to
end, and the serve CLI on the CPU."""
import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.runtime import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.runtime import ServingEngine  # noqa: E402

KEY = jax.random.PRNGKey(0)


def _engines(slots, max_len=48, arch="deepseek-7b"):
    jcfg = jax_smoke(arch)
    jp = JaxModel(jcfg).init(KEY)
    model = Model(get_smoke(arch), device="cpu").load_state(
        params_from_jax(jax.device_get(jp)))
    return (JaxEngine(jcfg, jp, slots=slots, max_len=max_len),
            ServingEngine(model, slots=slots, max_len=max_len, device="cpu"))


def _prompts_single(vocab):
    return [(np.arange(5, 13) % vocab, 6),
            ((np.arange(3, 19) * 7) % vocab, 6)]


def _prompts_reuse(vocab):
    rng = np.random.default_rng(0)
    return [(rng.integers(0, vocab, size=6), 3) for _ in range(5)]


def _prompts_priority(vocab):
    return [(np.arange(16) % vocab, 2), (np.arange(4) % vocab, 2)]


@pytest.mark.parametrize("slots,prompts", [
    (2, _prompts_single),      # test_engine_matches_single_request_decode
    (2, _prompts_reuse),       # test_engine_slot_reuse_more_requests_...
    (1, _prompts_priority),    # test_engine_priority_order_admission
])
def test_engine_tokens_match_jax(slots, prompts):
    jeng, teng = _engines(slots)
    for p, n in prompts(teng.cfg.vocab):
        jeng.submit(p.astype(np.int32), max_new=n)
        teng.submit(p, max_new=n)
    want = [(c.id, c.tokens) for c in jeng.run_until_drained()]
    got = [(c.id, c.tokens) for c in teng.run_until_drained()]
    assert got == want


def test_engine_bf16_end_to_end():
    # the JAX engine cannot run this config (its f32 slot cache changes the
    # scan carry dtype); the port allocates the cache in the compute dtype
    cfg = get_smoke("deepseek-7b").replace(param_dtype="bfloat16",
                                           compute_dtype="bfloat16")
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    eng = ServingEngine(model, slots=2, max_len=32, device="cpu")
    assert eng.cache["k"].dtype == torch.bfloat16
    rng = np.random.default_rng(4)
    ids = [eng.submit(rng.integers(0, cfg.vocab, size=n), max_new=5)
           for n in (3, 7, 5)]
    done = eng.run_until_drained()
    assert sorted(c.id for c in done) == sorted(ids)
    assert all(len(c.tokens) == 5 for c in done)
    assert all(0 <= t < cfg.vocab for c in done for t in c.tokens)


def test_engine_rejects_request_past_max_len():
    model = Model(get_smoke("deepseek-7b"), device="cpu").init(
        torch.Generator().manual_seed(0))
    eng = ServingEngine(model, slots=1, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(np.arange(12), max_new=5)
    eng.submit(np.arange(12), max_new=4)
    assert len(eng.run_until_drained()[0].tokens) == 4


def test_serve_cli_cpu(capsys):
    toks = serve.main(["--smoke", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--gen", "4"])
    assert tuple(toks.shape) == (2, 4)
    assert "generated (2, 4) on cpu" in capsys.readouterr().out
