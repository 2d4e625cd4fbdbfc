"""The port's AdamW (``repro_torch/optim/adamw.py``) against the JAX
package's: the optimizer tests of tests/test_runtime.py ported, and step-
by-step equality on one stream of gradients drawn with numpy."""
import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro_torch.optim.adamw as adamw_mod  # noqa: E402
from repro.optim import AdamW as JaxAdamW  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import schedule as jax_schedule  # noqa: E402
from repro_torch.optim import AdamW, AdamWConfig, schedule  # noqa: E402

# f32 parameters: the same arithmetic in the same order; only the global
# norm's order of sums differs (observed <= 6e-8 relative).  bf16
# parameters: the update is computed in f32 and cast once on both sides, so
# every step must land on the same bf16 values (rounding anywhere else, as
# an in-place bf16 update would, breaks this)
REL = {"float32": 1e-6, "bfloat16": 0.0}
# a matrix (decayed), a vector (not decayed) and a stacked leaf
SHAPES = {"w": (4, 6), "b": (6,), "stack": (3, 4, 5)}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


# ------------------------------------------- tests/test_runtime.py:19-54
def test_adamw_minimizes_quadratic():
    opt = AdamW(AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                            total_steps=200))
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(150):
        opt.update({"w": 2 * params["w"]}, state, params)
    assert float(params["w"].abs().max()) < 0.1


def test_adamw_clips_global_norm():
    opt = AdamW(AdamWConfig(lr=1e-3, clip_norm=1.0))
    params = {"w": torch.zeros(4)}
    state = opt.init(params)
    metrics = opt.update({"w": torch.full((4,), 1e6)}, state, params)
    assert float(metrics["grad_norm"]) > 1e5   # reported pre-clip


def test_schedule_warmup_and_decay():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    s = [float(schedule(cfg, i)) for i in (1, 5, 10, 50, 100)]
    assert s[0] < s[1] < s[2] == pytest.approx(1.0, abs=1e-3)
    assert s[3] > s[4]
    assert s[4] >= 0.099   # floor at 10%


def test_adamw_bf16_moments():
    opt = AdamW(AdamWConfig(moment_dtype="bfloat16"))
    params = {"w": torch.ones(8)}
    state = opt.init(params)
    assert state["m"]["w"].dtype == torch.bfloat16
    before = params["w"].clone()
    opt.update({"w": torch.ones(8)}, state, params)
    assert state["m"]["w"].dtype == torch.bfloat16
    assert float((params["w"] - before).abs().max()) > 0


# ---------------------------------------------- tests/test_runtime.py:318
def test_grad_compression_error_feedback():
    # bf16 + error feedback must track the uncompressed trajectory
    base = AdamW(AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=0,
                             total_steps=100))
    comp = AdamW(AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=0,
                             total_steps=100, grad_compression="bf16_ef"))
    p1 = {"w": torch.tensor([2.0, -1.5, 0.7])}
    p2 = {"w": torch.tensor([2.0, -1.5, 0.7])}
    s1, s2 = base.init(p1), comp.init(p2)
    assert "ef" in s2 and s2["ef"]["w"].dtype == torch.bfloat16
    for _ in range(80):
        base.update({"w": 2 * p1["w"]}, s1, p1)
        comp.update({"w": 2 * p2["w"]}, s2, p2)
    assert float(p2["w"].abs().max()) < 0.15
    np.testing.assert_allclose(p1["w"].numpy(), p2["w"].numpy(), atol=0.05)


# --------------------------------------------------- against the JAX AdamW
def test_schedule_matches_jax():
    for kw in (dict(lr=1.0, warmup_steps=10, total_steps=100),
               dict(lr=3e-4, warmup_steps=0, total_steps=50)):
        got = [float(schedule(AdamWConfig(**kw), i)) for i in range(121)]
        want = [float(jax_schedule(JaxAdamWConfig(**kw), jnp.array(i)))
                for i in range(121)]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("compression", ["none", "bf16_ef"])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_steps_match_jax(param_dtype, moments, compression, monkeypatch):
    """20 steps from the same parameters on the same gradients: every step's
    parameters, lr and global norm agree with the JAX AdamW.  A chunk of 7
    elements makes the in-place update walk each leaf in pieces (the
    stacked leaf's 60 values in 9); only the memory differs."""
    monkeypatch.setattr(adamw_mod, "_CHUNK", 7)
    rng = np.random.default_rng(0)
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in SHAPES.items()}
    grads = [{k: (3 * rng.standard_normal(s)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(20)]
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=20, clip_norm=5.0,
              moment_dtype=moments, grad_compression=compression)
    jdt, tdt = DT[param_dtype]
    jopt = JaxAdamW(JaxAdamWConfig(**kw))
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in p0.items()}
    jstate = jopt.init(jp)
    update = jax.jit(jopt.update)
    opt = AdamW(AdamWConfig(**kw))
    # copies: the update is in place, and jnp.asarray may share p0's memory
    tp = {k: torch.tensor(v, dtype=tdt) for k, v in p0.items()}
    tstate = opt.init(tp)
    for g in grads:
        jp, jstate, jm = update({k: jnp.asarray(v).astype(jdt)
                                 for k, v in g.items()}, jstate, jp)
        tm = opt.update({k: torch.as_tensor(v).to(tdt)
                         for k, v in g.items()}, tstate, tp)
        for k in SHAPES:
            want = np.asarray(jp[k].astype(jnp.float32), np.float64)
            got = tp[k].double().numpy()
            assert tp[k].dtype == tdt
            assert np.max(np.abs(got - want)) <= \
                REL[param_dtype] * np.max(np.abs(want))
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-6)
    assert int(tstate["count"]) == int(jstate["count"]) == 20
    assert tstate["count"].dtype == torch.int32
    for key in ("m", "v") + (("ef",) if compression == "bf16_ef" else ()):
        for k in SHAPES:
            assert str(tstate[key][k].dtype)[6:] == str(jstate[key][k].dtype)
