"""Port's MoE family vs the JAX package on bridged weights: the MoE block
against ``_moe_dense_dispatch`` (ref and Pallas-interpret expert FFN), the
arctic and llama4-scout smoke models (prefill, KV cache, decode, full
forward), the serving engine, and the port's own decode-vs-forward
consistency.  Also the init repairs: the router stays f32 in a bf16 model,
and leaves are drawn slice by slice."""
import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models.mlp import _moe_dense_dispatch  # noqa: E402
from repro.models.mlp import init_moe_params as jax_init_moe  # noqa: E402
from repro.runtime import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import Model, common  # noqa: E402
from repro_torch.models.api import flatten  # noqa: E402
from repro_torch.models.mlp import moe_capacity, moe_forward  # noqa: E402
from repro_torch.runtime import ServingEngine  # noqa: E402

MOE = ["arctic-480b", "llama4-scout-17b-a16e"]
# f32 on both sides, only the order of sums differs (observed <= 1e-6)
JAX_REL = 1e-5
AUX_ATOL = 1e-6
DECODE_REL = 5e-4                       # tests/test_models.py:76
KEY = jax.random.PRNGKey(0)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def _dropped(x, router, cfg) -> int:
    """Routed (token, choice) pairs over capacity, counted in numpy."""
    b, s, _ = x.shape
    logits = x.astype(np.float64) @ router.astype(np.float64)
    top_i = np.argsort(-logits, axis=-1)[..., :cfg.top_k].reshape(b, -1)
    cap = moe_capacity(cfg, s)
    counts = np.stack([np.bincount(r, minlength=cfg.n_experts)
                       for r in top_i])
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("mode", ["ref", "interpret"])
@pytest.mark.parametrize("cf", [None, 50.0])
@pytest.mark.parametrize("arch", MOE)
def test_moe_forward_matches_jax(arch, cf, mode):
    jcfg = jax_smoke(arch).replace(kernel_mode=mode)
    cfg = get_smoke(arch)
    if cf is not None:
        jcfg, cfg = jcfg.replace(capacity_factor=cf), \
            cfg.replace(capacity_factor=cf)
    jp = jax_init_moe(KEY, jcfg, jnp.float32)
    params = params_from_jax(jax.device_get(jp))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    # a shared direction skews the routing, so that experts overflow
    x += 1.5 * rng.standard_normal(cfg.d_model).astype(np.float32)
    dropped = _dropped(x, np.asarray(jp["router"]), cfg)
    assert (dropped > 0) == (cf is None), dropped

    jy, jaux = _moe_dense_dispatch(jp, jnp.asarray(x), jcfg)
    y, aux = moe_forward(params, torch.from_numpy(x), cfg)
    assert y.shape == x.shape and y.dtype == torch.float32
    assert _rel(y, jy) < JAX_REL
    assert abs(float(aux) - float(jaux)) < AUX_ATOL
    assert float(aux) >= 0.99     # tests/test_models.py:109-114


def _pair(arch, **repl):
    jcfg, cfg = jax_smoke(arch).replace(**repl), get_smoke(arch).replace(
        **repl)
    jm = JaxModel(jcfg)
    jp = jm.init(KEY)
    model = Model(cfg, device="cpu").load_state(
        params_from_jax(jax.device_get(jp)))
    return jm, jp, model


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, s))


@pytest.mark.parametrize("arch", MOE)
def test_moe_prefill_and_decode_match_jax(arch):
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
    assert tc2 is tc
    assert _rel(tl2, jl2) < JAX_REL
    for key in ("k", "v"):
        assert _rel(tc2[key], jc2[key]) < JAX_REL
    np.testing.assert_array_equal(tc2["pos"].numpy(), np.asarray(jc2["pos"]))


@pytest.mark.parametrize("arch", MOE)
def test_moe_forward_logits_match_jax(arch):
    jm, jp, model = _pair(arch)
    toks = _tokens(model.cfg, 2, 16, seed=3)
    want = jm.forward_logits(jp, {"tokens": jnp.asarray(toks)})
    got = model.forward_logits({"tokens": torch.as_tensor(toks)})
    assert got.shape == want.shape
    assert _rel(got, want) < JAX_REL


@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_matches_full_forward(arch):
    # tests/test_models.py:57-76: no token dropping at capacity_factor 50
    cfg = get_smoke(arch).replace(capacity_factor=50.0)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    b, s = 2, 12
    toks = torch.as_tensor(_tokens(cfg, b, s + 1, seed=1))
    ref = model.forward_logits({"tokens": toks})[:, -1, :]
    _, cache = model.prefill({"tokens": toks[:, :s]}, pad_to=s + 4)
    got, _ = model.decode_step(toks[:, s:s + 1], cache)
    assert _rel(got, ref) < DECODE_REL


@pytest.mark.parametrize("arch", MOE)
def test_moe_engine_tokens_match_jax(arch):
    jm, jp, model = _pair(arch)
    jeng = JaxEngine(jm.cfg, jp, slots=2, max_len=48)
    teng = ServingEngine(model, slots=2, max_len=48, device="cpu")
    rng = np.random.default_rng(5)
    for n, new in ((5, 6), (16, 4), (9, 6), (3, 3)):
        p = rng.integers(0, model.cfg.vocab, size=n)
        jeng.submit(p.astype(np.int32), max_new=new)
        teng.submit(p, max_new=new)
    want = [(c.id, c.tokens) for c in jeng.run_until_drained()]
    got = [(c.id, c.tokens) for c in teng.run_until_drained()]
    assert got == want


def _leaf_dtypes(model):
    return {k: p.dtype for k, p in model.named_parameters()}


@pytest.mark.parametrize("arch", MOE)
def test_router_stays_f32_in_bf16_model(arch):
    cfg = get_smoke(arch).replace(param_dtype="bfloat16",
                                  compute_dtype="bfloat16")
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    f32_state = {k: v.float() for k, v in model.state_dict().items()}
    for m in (model, Model(cfg, device="cpu").load_state(f32_state)):
        dtypes = _leaf_dtypes(m)
        assert dtypes.pop("layers.moe.router") == torch.float32
        assert set(dtypes.values()) == {torch.bfloat16}


def test_normal_init_draws_slice_by_slice(monkeypatch):
    monkeypatch.setattr(common, "_DRAW_CHUNK", 4000)
    drawn = []
    randn = torch.randn

    def spy(*shape, **kw):
        drawn.append(tuple(shape[0]) if len(shape) == 1 else shape)
        return randn(*shape, **kw)

    monkeypatch.setattr(torch, "randn", spy)
    gen = torch.Generator().manual_seed(0)
    x = common.normal_init(gen, (6, 50, 40), 0.5, torch.bfloat16, "cpu")
    assert x.shape == (6, 50, 40) and x.dtype == torch.bfloat16
    assert drawn == [(2, 50, 40)] * 3         # two slices of 2000 per draw
    assert abs(float(x.float().std()) - 0.5) < 0.02
    assert abs(float(x.float().mean())) < 0.02
    assert not torch.equal(x[0], x[2])        # each chunk is a new draw
    drawn.clear()
    y = common.normal_init(gen, (3, 70, 80), 1.0, torch.float32, "cpu")
    assert drawn == [(1, 70, 80)] * 3 and y.shape == (3, 70, 80)
    assert abs(float(y.std()) - 1.0) < 0.03
    meta = common.normal_init(None, (4, 5), 1.0, torch.bfloat16, "meta")
    assert meta.is_meta and meta.dtype == torch.bfloat16


def test_model_init_never_draws_a_whole_stacked_leaf(monkeypatch):
    """At full width one stacked expert leaf is 32 GB in f32; init must draw
    no more than one layer of it (or 2^26 values) at a time."""
    cfg = get_smoke("llama4-scout-17b-a16e").replace(n_layers=4)
    monkeypatch.setattr(common, "_DRAW_CHUNK", 1000)
    drawn = []
    randn = torch.randn
    monkeypatch.setattr(torch, "randn", lambda *s, **kw: (
        drawn.append(int(np.prod(s[0] if len(s) == 1 else s))),
        randn(*s, **kw))[1])
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    w_in = model.state_dict()["layers.moe.w_in"]
    assert max(drawn) == w_in[0].numel() < w_in.numel()
    assert sum(drawn) == sum(
        v.numel() for k, v in flatten(model.params).items()
        if "ln" not in k.split(".")[-1] and k != "final_norm")


@pytest.mark.parametrize("n_experts", [None, 16])
def test_moe_decode_buffer_leaves_experts_dead(monkeypatch, n_experts):
    """At decode, x (4, 1, D) with top-1 routing fills at most 4 rows of the
    (4, E, C, D) dispatch buffer, so at least E - 4 experts hold no live row:
    the rows the grouped FFN kernel skips (moe_gmm.cu).  The block's output
    agrees with JAX's dispatch all the same."""
    from repro_torch.models import mlp
    arch = "llama4-scout-17b-a16e"
    repl = {} if n_experts is None else {"n_experts": n_experts}
    jcfg, cfg = jax_smoke(arch).replace(**repl), get_smoke(arch).replace(
        **repl)
    jp = jax_init_moe(KEY, jcfg, jnp.float32)
    params = params_from_jax(jax.device_get(jp))
    seen = []
    real = mlp.grouped_ffn
    monkeypatch.setattr(mlp, "grouped_ffn",
                        lambda buf, *a: seen.append(buf) or real(buf, *a))
    x = np.random.default_rng(3).standard_normal(
        (4, 1, cfg.d_model)).astype(np.float32)
    y, _ = moe_forward(params, torch.from_numpy(x), cfg)
    (buf,) = seen
    e = cfg.n_experts
    assert buf.shape == (4, e, moe_capacity(cfg, 1), cfg.d_model)
    live_rows = (buf != 0).any(-1)                       # (B, E, C)
    live_experts = int(live_rows.any(-1).any(0).sum())
    assert int(live_rows.sum()) == 4 and 1 <= live_experts <= 4
    assert e - live_experts >= e - 4
    jy, _ = _moe_dense_dispatch(jp, jnp.asarray(x), jcfg)
    assert _rel(y, jy) < JAX_REL
