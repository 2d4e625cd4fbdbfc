"""Port's VLM family (llava-next: projected image patches prepended to the
token embeddings, then the dense stack) vs the JAX package on bridged
weights: ``_embed`` with patches, the logits, the prefill cache and its
``pos`` (prompt + n_patches), decode steps; the port's own
decode-vs-forward consistency; the loss on the text positions; and the
serving entry points."""
import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import Model, lm  # noqa: E402
from repro_torch.runtime import ServingEngine  # noqa: E402

ARCH = "llava-next-mistral-7b"
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
            "patches": 0.1 * rng.standard_normal((b, cfg.n_patches, 1024),
                                                 np.float32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def test_embed_with_patches_matches_jax(jax_params):
    _, model = _pair(jax_params)
    cfg = model.cfg
    batch = _batch(cfg, 2, 6)
    want = jlm._embed(jax_params, jnp.asarray(batch["tokens"]),
                      jax_smoke(ARCH), jnp.asarray(batch["patches"]))
    got = lm._embed(model.params, torch.as_tensor(batch["tokens"]), cfg,
                    torch.as_tensor(batch["patches"]))
    assert got.shape == want.shape == (2, cfg.n_patches + 6, cfg.d_model)
    assert _rel(got, want) < JAX_REL
    with pytest.raises(ValueError, match="patch"):
        lm._embed(model.params, torch.as_tensor(batch["tokens"]), cfg)


@pytest.mark.parametrize("mode", ["ref", "interpret"])
def test_forward_logits_match_jax(jax_params, mode):
    jm, model = _pair(jax_params, mode)
    batch = _batch(model.cfg, 2, 12, seed=3)
    want = jm.forward_logits(jax_params, _jax(batch))
    got = model.forward_logits(_torch(batch))
    assert got.shape == want.shape == (2, model.cfg.n_patches + 12,
                                       model.cfg.vocab)
    assert _rel(got, want) < JAX_REL


def test_train_loss_takes_text_positions_only(jax_params):
    """The VLM's loss is the CE of the text positions alone, the last
    ``labels.shape[1]`` rows of the logits, as the reference's
    ``logits[:, -labels.shape[1]:]``; ``forward(last=n)`` applies the final
    norm and the head to those rows only and gives the full logits' last n
    rows."""
    jm, model = _pair(jax_params)
    cfg = model.cfg
    batch = _batch(cfg, 2, 12, seed=6)
    batch["labels"] = np.roll(batch["tokens"], -1, axis=1)
    jloss, jmet = jm.train_loss(jax_params, _jax(batch))
    loss, met = model.train_loss(_torch(batch))
    assert _rel(loss, jloss) < JAX_REL
    assert _rel(met["ce"], jmet["ce"]) < JAX_REL
    with torch.no_grad():
        full = model.forward_logits(_torch(batch))
        text, _, _ = lm.forward(model.params, torch.as_tensor(batch["tokens"]),
                                cfg, last=12,
                                patches=torch.as_tensor(batch["patches"]))
    assert full.shape[1] == cfg.n_patches + 12 and text.shape[1] == 12
    assert _rel(text, full[:, -12:]) < JAX_REL
    want = torch.nn.functional.cross_entropy(
        full[:, -12:].reshape(-1, cfg.vocab),
        torch.as_tensor(batch["labels"]).reshape(-1))
    assert abs(float(loss.detach()) - float(want)) <= 1e-6 * float(want)


def test_prefill_pos_and_decode_match_jax(jax_params):
    jm, model = _pair(jax_params)
    cfg = model.cfg
    b, s = 2, 10
    batch = _batch(cfg, b, s + 3)
    toks = batch["tokens"]
    batch["tokens"] = toks[:, :s]
    pad_to = cfg.n_patches + s + 4
    jl, jc = jm.prefill(jax_params, _jax(batch), pad_to=pad_to)
    tl, tc = model.prefill(_torch(batch), pad_to=pad_to)
    assert set(tc) == set(jc) == {"k", "v", "pos"}
    assert tc["pos"].tolist() == [cfg.n_patches + s] * b
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    assert _rel(tl, jl) < JAX_REL
    for key in ("k", "v"):
        assert tc[key].shape == jc[key].shape == (
            cfg.n_layers, b, pad_to, cfg.n_kv_heads, cfg.head_dim)
        assert _rel(tc[key], jc[key]) < JAX_REL, key

    for t in range(s, s + 3):
        jl, jc = jm.decode_step(jax_params, jnp.asarray(toks[:, t:t + 1]),
                                jc)
        tl, tc2 = model.decode_step(torch.as_tensor(toks[:, t:t + 1]), tc)
        assert tc2 is tc                                # updated in place
        assert _rel(tl, jl) < JAX_REL
        for key in ("k", "v"):
            assert _rel(tc[key], jc[key]) < JAX_REL, key


def test_decode_matches_full_forward():
    cfg = get_smoke(ARCH)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    b, s = 2, 12
    batch = _torch(_batch(cfg, b, s + 4, seed=1))
    toks = batch["tokens"]
    _, cache = model.prefill({**batch, "tokens": toks[:, :s]},
                             pad_to=cfg.n_patches + s + 4)
    for t in range(s, s + 4):
        logits, cache = model.decode_step(toks[:, t:t + 1], cache)
        full = model.forward_logits({**batch, "tokens": toks[:, :t + 1]})
        assert _rel(logits, full[:, -1]) < DECODE_REL


def test_engine_refuses_vlm(jax_params):
    """A request is a token prompt; a llava prefill needs image patches
    too, so the engine refuses the model and names the batched loop."""
    _, model = _pair(jax_params)
    with pytest.raises(ValueError, match="launch.serve"):
        ServingEngine(model, device="cpu")


def test_serve_cli_cpu(capsys):
    toks = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "9", "--gen", "4"])
    assert tuple(toks.shape) == (2, 4)
    assert "generated (2, 4) on cpu" in capsys.readouterr().out
    cfg = get_smoke(ARCH)
    batch = serve.make_batch(cfg, 2, 9, "cpu")
    assert batch["patches"].shape == (2, cfg.n_patches, 1024)
    assert serve.pad_len(cfg, 9, 4) == cfg.n_patches + 13
