"""The port's meta-device dry run (``repro_torch/launch/dryrun.py``) and what
it is built from, against the JAX package where it has a counterpart: the
input specs and the shape table, the prefill step, the kernels' meta routes,
and the cells' memory and counts."""
import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import applicable as jax_applicable  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.launch import input_specs as jax_specs  # noqa: E402
from repro.launch.steps import make_prefill_step as jax_prefill  # noqa
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import (ARCHS, SHAPES, applicable,  # noqa: E402
                                 get_config, get_smoke)
from repro_torch.kernels.flash_attention import flash_attention  # noqa
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa
from repro_torch.kernels.moe_gmm import GroupedFFN, grouped_ffn  # noqa
from repro_torch.kernels.ssd import SSDIntraChunk, ssd_intra_chunk  # noqa
from repro_torch.launch import dryrun, shapes_util  # noqa: E402
from repro_torch.launch.input_specs import batch_specs, cache_specs  # noqa
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.roofline import Counter  # noqa: E402

MODEL_REL = 5e-4          # tests/test_models.py:76
META = torch.device("meta")
_DTYPES = {jnp.dtype(jnp.int32): torch.int64,     # tokens: int32 -> int64
           jnp.dtype(jnp.float32): torch.float32,
           jnp.dtype(jnp.bfloat16): torch.bfloat16}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _like(spec, jax_tree) -> None:
    got, want = _flat(spec), _flat(jax_tree)
    assert set(got) == set(want)
    for key, w in want.items():
        assert tuple(got[key].shape) == tuple(w.shape), key
        assert got[key].dtype == _DTYPES[jnp.dtype(w.dtype)], key
        assert got[key].is_meta, key


# ------------------------------------------------------ specs and shapes
def test_shape_table_and_applicable_equal_jax():
    assert {k: tuple(vars(v).values()) for k, v in SHAPES.items()} == \
        {k: tuple(vars(v).values()) for k, v in JAX_SHAPES.items()}
    assert shapes_util.SHAPES is SHAPES
    for arch in ARCHS:
        for name in SHAPES:
            assert applicable(get_config(arch), SHAPES[name]) == \
                jax_applicable(jax_config(arch), JAX_SHAPES[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_jax(arch):
    """batch_specs and cache_specs: the reference's shapes and dtypes,
    meta tensors, tokens int64 for int32."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    for name, shape in SHAPES.items():
        if not applicable(cfg, shape)[0]:
            continue
        _like(batch_specs(cfg, shape), jax_specs.batch_specs(jcfg, shape))
        if shape.kind == "decode":
            _like(cache_specs(cfg, shape),
                  jax_specs.cache_specs(jcfg, shape))


# ----------------------------------------------------------- prefill step
@pytest.mark.parametrize("arch", ["deepseek-7b", "mamba2-780m"])
def test_prefill_step_matches_jax(arch):
    jm = JaxModel(jax_smoke(arch))
    jp = jm.init(jax.random.PRNGKey(0))
    model = Model(get_smoke(arch), device="cpu").load_state(
        params_from_jax(jax.device_get(jp)))
    toks = np.random.default_rng(0).integers(0, model.cfg.vocab, (2, 12))
    jtok, jcache = jax_prefill(jm)(jp, {"tokens": jnp.asarray(toks)})
    tok, cache = make_prefill_step(model)({"tokens": torch.tensor(toks)})
    assert tok.dtype == torch.int64 and tok.shape == (2,)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    assert set(cache) == set(jcache)
    for key, want in jcache.items():
        got = cache[key].detach().numpy().astype(np.float64)
        want = np.asarray(want, np.float64)
        assert got.shape == want.shape, key
        rel = np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9)
        assert rel < MODEL_REL, (key, rel)


# -------------------------------------------------------- the meta routes
def _launches():
    return (flash_attention.launches, flash_attention.backward_launches,
            grouped_ffn.launches, grouped_ffn.backward_launches,
            ssd_intra_chunk.launches, ssd_intra_chunk.backward_launches)


def _leaves(*shapes, dtype=torch.bfloat16):
    return [torch.empty(s, dtype=dtype, device=META, requires_grad=True)
            for s in shapes]


def _grads_like(inputs, out):
    torch.autograd.backward(out, [torch.empty_like(o) for o in out])
    for x in inputs:
        assert x.grad is not None and x.grad.is_meta
        assert x.grad.shape == x.shape and x.grad.dtype == x.dtype
        assert x.grad.is_contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_meta_routes(dtype):
    """Forward (served, and with the row logsumexp for training) and
    backward on meta: the CUDA path's shapes and dtypes, no launch."""
    before = _launches()
    q, k, v = _leaves((2, 40, 8, 64), (2, 56, 2, 64), (2, 56, 2, 64),
                      dtype=dtype)
    with torch.no_grad():
        o = flash_attention(q, k, v)
    assert o.is_meta and o.shape == q.shape and o.dtype == dtype
    o, lse = flash_ops._forward(q, k, v, True, 0, 0.125, with_lse=True)
    assert lse.shape == (2, 8, 40) and lse.dtype == torch.float32
    out = flash_attention(q, k, v, causal=True, window=16)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == \
        "FlashAttentionBackward"
    saved = out.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [
        (2, 40, 8, 64), (2, 56, 2, 64), (2, 56, 2, 64), (2, 40, 8, 64),
        (2, 8, 40)]
    assert all(t.is_meta for t in saved)
    _grads_like((q, k, v), [out])
    assert _launches() == before


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_moe_gmm_meta_routes(act):
    before = _launches()
    buf, w_in, w_gate, w_out = _leaves((2, 4, 8, 64), (4, 64, 96),
                                       (4, 64, 96), (4, 96, 64))
    with torch.no_grad():
        y = grouped_ffn(buf, w_in, w_gate, w_out, act)
    assert y.is_meta and y.shape == buf.shape and y.dtype == buf.dtype
    y = GroupedFFN.apply(buf, w_in, w_gate, w_out, act)
    _grads_like((buf, w_in, w_gate, w_out), [y])
    assert _launches() == before


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_ssd_meta_routes(x_dtype):
    before = _launches()
    (xc,) = _leaves((2, 3, 16, 4, 8), dtype=x_dtype)
    dtc, cum, bc, cc = _leaves((2, 3, 16, 4), (2, 3, 16, 4), (2, 3, 16, 6),
                               (2, 3, 16, 6), dtype=torch.float32)
    with torch.no_grad():
        y, st = ssd_intra_chunk(xc, dtc, cum, bc, cc)
    assert (y.shape, st.shape) == ((2, 3, 16, 4, 8), (2, 3, 4, 6, 8))
    assert y.dtype == st.dtype == torch.float32 and y.is_meta
    y, st = SSDIntraChunk.apply(xc, dtc, cum, bc, cc)
    _grads_like((xc, dtc, cum, bc, cc), [y, st])
    # a loss that reads y alone: the absent cotangent is zeros, as on the card
    for x in (xc, dtc, cum, bc, cc):
        x.grad = None
    y, _ = SSDIntraChunk.apply(xc, dtc, cum, bc, cc)
    _grads_like((xc, dtc, cum, bc, cc), [y])
    assert _launches() == before


def test_wrappers_refuse_mixed_devices():
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="on meta"):
        flash_attention(q, q.to("meta"), q.to("meta"))


# --------------------------------------------------------------- the cells
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_cells_run_on_meta(arch):
    """Every smoke config through every shape kind of the table (cut to
    batch 2 x 32), on meta: status ok, positive counts, a kernel call for
    each kernel the family runs, and the JSON row's fields."""
    cfg = get_smoke(arch)
    for name, shape in SHAPES.items():
        row = dryrun.run_cell(arch, name, verbose=False, batch=2, seq=32,
                              smoke=True)
        if not applicable(cfg, shape)[0]:
            assert row["status"] == "skipped" and row["reason"]
            continue
        assert row["status"] == "ok", row.get("traceback")
        counts = row["counts"]
        assert counts["flops"] > 0 and counts["bytes"] > 0
        assert row["roofline"]["flops_per_device"] == counts["flops"]
        assert row["roofline"]["bottleneck"] in ("compute", "memory")
        assert row["memory"]["fits"] and row["kind"] == shape.kind
        if shape.kind != "decode" and cfg.family != "ssm":
            assert counts["calls"]["flash_attn_fwd"] > 0
        if shape.kind == "train" and cfg.n_experts:
            assert counts["calls"]["moe_gmm_bwd"] == cfg.n_layers


def test_deepseek_state_f32_moments_does_not_fit():
    """Full deepseek-7b at 2 x 2048: f32 moments need 12 bytes a parameter
    (82.9 GB) and do not fit one card; bf16 moments 8 bytes, and fit."""
    n = sum(p.numel() for p in
            Model(get_config("deepseek-7b"), device="meta").parameters())
    f32 = dryrun.run_cell("deepseek-7b", "train_4k", verbose=False, batch=2,
                          seq=2048, moments="float32")
    assert f32["status"] == "ok"
    assert f"{f32['memory']['state_bytes'] / 1e9:.1f}" == "82.9"
    assert f32["memory"]["state_bytes"] == 12 * n + 4    # + the int32 count
    assert not f32["memory"]["fits"]
    bf16 = dryrun.run_cell("deepseek-7b", "train_4k", verbose=False,
                           batch=2, seq=2048, moments="bfloat16")
    assert bf16["memory"]["state_bytes"] == 8 * n + 4
    assert bf16["memory"]["fits"]
    # the two steps do the same work but for the moments' bytes
    assert bf16["counts"]["calls"] == f32["counts"]["calls"] == {
        "flash_attn_fwd": 60, "flash_attn_bwd": 30}
    assert bf16["counts"]["flops"] == f32["counts"]["flops"]


def test_llama4_two_layers_state():
    row = dryrun.run_cell("llama4-scout-17b-a16e", "train_4k", verbose=False,
                          batch=2, seq=2048, moments="bfloat16",
                          cfg_overrides={"n_layers": 2})
    assert f"{row['memory']['state_bytes'] / 1e9:.1f}" == "51.8"
    assert row["memory"]["fits"]
    assert row["counts"]["calls"] == {"flash_attn_bwd": 2,
                                      "flash_attn_fwd": 4, "moe_gmm": 4,
                                      "moe_gmm_bwd": 2}


def test_cli_writes_rows(tmp_path, capsys):
    """The CLI at a path's own sizes (whisper-medium at full width, 2 of
    its decoder layers, batch 1 x 16 tokens): every shape, one JSON row
    each, long_500k skipped."""
    rows = dryrun.main(["--arch", "whisper-medium", "--layers", "2",
                        "--batch", "1", "--seq", "16", "--moments",
                        "bfloat16", "--out", str(tmp_path)])
    assert [r["status"] for r in rows] == ["ok", "ok", "ok", "skipped"]
    assert rows[0]["moments"] == "bfloat16" and rows[0]["n_layers"] == 2
    assert len(list(tmp_path.glob("whisper-medium__*__1xH100.json"))) == 4
    assert "DRY-RUN SUMMARY: 3 ok, 1 skipped" in capsys.readouterr().out
    with Counter("meta"):           # nothing is left active after a cell
        pass
