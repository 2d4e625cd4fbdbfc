"""Port's encoder-decoder (whisper) vs the JAX package on bridged weights:
``cross_attention`` and ``encode_kv``, the encoder, the decoder's logits,
the prefill cache (k, v, xk, xv) and decode steps, with JAX's decoder
self-attention in "ref" mode and on the Pallas flash kernel in "interpret"
mode (the one model path of the reference that reaches that kernel); the
encoder's self-attention and the full-sequence cross-attention, which the
port runs on flash, against the Pallas kernel with ``causal=False``; the
port's own decode-vs-forward consistency; ``Model.train_loss``'s dispatch
to ``encdec.train_loss``; and the serving entry points."""
import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.kernels.flash_attention.ops import \
    flash_attention as jax_flash  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import Model, attention, encdec  # noqa: E402
from repro_torch.runtime import ServingEngine  # noqa: E402

ARCH = "whisper-medium"
# f32 on both sides, only the order of sums differs (ROADMAP.md)
JAX_REL = 1e-5
DECODE_REL = 5e-4                      # tests/test_models.py:76
KEY = jax.random.PRNGKey(0)


def _rel(got, want) -> float:
    if isinstance(got, torch.Tensor):    # the parameters require grad
        got = got.detach()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


@pytest.fixture(scope="module")
def jax_params():
    return JaxModel(jax_smoke(ARCH)).init(KEY)


def _pair(jp, mode="ref"):
    jm = JaxModel(jax_smoke(ARCH).replace(kernel_mode=mode))
    model = Model(get_smoke(ARCH), device="cpu").load_state(
        params_from_jax(jax.device_get(jp)))
    return jm, model


def _batch(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, size=(b, s)),
            "frames": 0.1 * rng.standard_normal((b, cfg.enc_len, cfg.d_model),
                                                np.float32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _attn_params(cfg_jax):
    jp = jax.device_get(jattn.init_attn_params(KEY, cfg_jax, jnp.float32))
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def test_cross_attention_and_encode_kv_match_jax():
    jcfg, cfg = jax_smoke(ARCH), get_smoke(ARCH)
    jp, tp = _attn_params(jcfg)
    rng = np.random.default_rng(1)
    enc_out = rng.standard_normal((2, cfg.enc_len, cfg.d_model), np.float32)
    x = rng.standard_normal((2, 5, cfg.d_model), np.float32)
    jk, jv = jattn.encode_kv(jp, jnp.asarray(enc_out))
    tk, tv = attention.encode_kv(tp, torch.from_numpy(enc_out), cfg)
    assert tk.shape == (2, cfg.enc_len, cfg.n_kv_heads, cfg.head_dim)
    assert _rel(tk, jk) < JAX_REL and _rel(tv, jv) < JAX_REL
    want = jattn.cross_attention(jp, jnp.asarray(x), jk, jv, jcfg)
    got = attention.cross_attention(tp, torch.from_numpy(x), tk, tv, cfg)
    assert got.shape == (2, 5, cfg.d_model)
    assert _rel(got, want) < JAX_REL


# (label, decoder rows S, keys T): the encoder's self-attention over a
# ragged number of frames (T = S, not a multiple of the 8-row blocks), and
# the cross-attention of more and of fewer decoder rows than frames
NON_CAUSAL = [("encoder", 21, 21), ("cross T > S", 12, 32),
              ("cross T < S", 40, 21)]


@pytest.mark.parametrize("label,s,t", NON_CAUSAL,
                         ids=[c[0] for c in NON_CAUSAL])
def test_non_causal_attention_matches_pallas_interpret(label, s, t):
    """The two attentions the port sends through flash with
    ``causal=False`` against the same layer spelled with the JAX package's
    projections and its Pallas flash kernel, ``causal=False``, in interpret
    mode (blocks of 8 rows): ``full_attention(causal=False)`` for the
    encoder, ``cross_attention`` for the decoder's S rows against T
    encoder positions."""
    jcfg, cfg = jax_smoke(ARCH), get_smoke(ARCH)
    jp, tp = _attn_params(jcfg)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, s, cfg.d_model), np.float32)
    flash = dict(causal=False, interpret=True, bq=8, bk=8)
    if label == "encoder":
        positions = np.arange(s)[None, :]
        q, k, v = jattn._qkv(jp, jnp.asarray(x), jnp.asarray(positions),
                             jcfg)
        got, (tk, _) = attention.full_attention(
            tp, torch.from_numpy(x), torch.as_tensor(positions), cfg,
            causal=False)
        assert _rel(tk, k) < JAX_REL
    else:
        enc_out = rng.standard_normal((2, t, cfg.d_model), np.float32)
        k, v = jattn.encode_kv(jp, jnp.asarray(enc_out))
        q = jnp.einsum("bsd,dhk->bshk", jnp.asarray(x), jp["wq"])
        tk, tv = attention.encode_kv(tp, torch.from_numpy(enc_out), cfg)
        got = attention.cross_attention(tp, torch.from_numpy(x), tk, tv, cfg)
    want = jnp.einsum("bshk,hkd->bsd", jax_flash(q, k, v, **flash), jp["wo"])
    assert k.shape[1] == t and got.shape == want.shape == (2, s, cfg.d_model)
    assert _rel(got, want) < JAX_REL


def test_model_train_loss_reaches_encdec_train_loss(jax_params,
                                                     monkeypatch):
    """``Model.train_loss`` dispatches by family as the reference's does:
    whisper's goes to ``encdec.train_loss`` (frames through the encoder, CE
    of the decoder's logits), whose loss it returns."""
    _, model = _pair(jax_params)
    calls = []
    real = encdec.train_loss

    def spy(params, batch, cfg):
        calls.append(cfg.name)
        return real(params, batch, cfg)

    monkeypatch.setattr(encdec, "train_loss", spy)
    batch = _torch(_batch(model.cfg, 2, 10, seed=5))
    batch["labels"] = torch.roll(batch["tokens"], -1, dims=1)
    loss, met = model.train_loss(batch)
    assert calls == [ARCH] and set(met) == {"ce"} and met["ce"] is loss
    with torch.no_grad():
        logits = model.forward_logits(batch)
    want = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]).float(),
        batch["labels"].reshape(-1))
    assert abs(float(loss.detach()) - float(want)) <= 1e-6 * float(want)


def test_encode_matches_jax(jax_params):
    _, model = _pair(jax_params)
    frames = _batch(model.cfg, 2, 4)["frames"]
    want = jencdec.encode(jax_params, jnp.asarray(frames), jax_smoke(ARCH))
    got = encdec.encode(model.params, torch.from_numpy(frames), model.cfg)
    assert got.shape == want.shape
    assert _rel(got, want) < JAX_REL


@pytest.mark.parametrize("mode", ["ref", "interpret"])
def test_dec_forward_logits_match_jax(jax_params, mode):
    jm, model = _pair(jax_params, mode)
    batch = _batch(model.cfg, 2, 12, seed=3)
    want = jm.forward_logits(jax_params, _jax(batch))
    got = model.forward_logits(_torch(batch))
    assert got.shape == want.shape == (2, 12, model.cfg.vocab)
    assert _rel(got, want) < JAX_REL


@pytest.mark.parametrize("mode", ["ref", "interpret"])
def test_prefill_and_decode_match_jax(jax_params, mode):
    jm, model = _pair(jax_params, mode)
    b, s = 2, 10
    batch = _batch(model.cfg, b, s + 3)
    toks = batch["tokens"]
    batch["tokens"] = toks[:, :s]
    jl, jc = jm.prefill(jax_params, _jax(batch), pad_to=s + 4)
    tl, tc = model.prefill(_torch(batch), pad_to=s + 4)
    assert set(tc) == set(jc) == {"k", "v", "xk", "xv", "pos"}
    assert tc["k"].shape[2] == s + 4                 # only k, v are padded
    assert tc["xk"].shape[2] == model.cfg.enc_len
    assert _rel(tl, jl) < JAX_REL
    for key in ("k", "v", "xk", "xv"):
        assert tc[key].shape == jc[key].shape, key
        assert _rel(tc[key], jc[key]) < JAX_REL, key
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))

    for t in range(s, s + 3):
        jl, jc = jm.decode_step(jax_params, jnp.asarray(toks[:, t:t + 1]),
                                jc)
        tl, tc2 = model.decode_step(torch.as_tensor(toks[:, t:t + 1]), tc)
        assert tc2 is tc                                # updated in place
        assert _rel(tl, jl) < JAX_REL
        for key in ("k", "v"):
            assert _rel(tc[key], jc[key]) < JAX_REL, key
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))


def test_decode_matches_full_forward():
    cfg = get_smoke(ARCH)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    b, s = 2, 12
    batch = _torch(_batch(cfg, b, s + 4, seed=1))
    toks = batch["tokens"]
    _, cache = model.prefill({**batch, "tokens": toks[:, :s]}, pad_to=s + 4)
    for t in range(s, s + 4):
        logits, cache = model.decode_step(toks[:, t:t + 1], cache)
        full = model.forward_logits({**batch, "tokens": toks[:, :t + 1]})
        assert _rel(logits, full[:, -1]) < DECODE_REL


def test_decode_cache_layout(jax_params):
    model = Model(get_smoke(ARCH), device="cpu")
    cache = model.init_decode_cache(3, 40)
    jcache = JaxModel(jax_smoke(ARCH)).init_decode_cache(3, 40)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}


def test_engine_refuses_encdec(jax_params):
    """A request is a token prompt; a whisper prefill needs audio frames
    too, so the engine refuses the model and names the batched loop (the
    JAX engine fails later, on a missing "frames" key)."""
    _, model = _pair(jax_params)
    with pytest.raises(ValueError, match="launch.serve"):
        ServingEngine(model, device="cpu")


def test_serve_cli_cpu(capsys):
    toks = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "9", "--gen", "4"])
    assert tuple(toks.shape) == (2, 4)
    assert "generated (2, 4) on cpu" in capsys.readouterr().out
