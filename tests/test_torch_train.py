"""The port's training path on the CPU against the JAX package: the loss
and every gradient leaf (every family: dense, MoE, SSM, hybrid, the
encoder-decoder and the VLM), one train step, the data loader's token
stream,
the trainer (the tests of tests/test_runtime.py and tests/test_system.py
ported), and checkpoints that cross between the two packages.

Weights come from the JAX init through ``bridge.params_from_jax``; batches
are numpy arrays handed to both."""
import tempfile

import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.data import PrefetchingLoader as JaxLoader  # noqa: E402
from repro.data import SyntheticCorpus as JaxCorpus  # noqa: E402
from repro.launch.input_specs import batch_specs  # noqa: E402
from repro.launch.shapes_util import ShapeSpec  # noqa: E402
from repro.launch.steps import make_train_step as jax_train_step  # noqa
from repro.models import Model as JaxModel  # noqa: E402
from repro.optim import AdamW as JaxAdamW  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.runtime import CheckpointManager as JaxCheckpoints  # noqa: E402
from repro.runtime import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.runtime import Trainer as JaxTrainer  # noqa: E402
from repro_torch.bridge import opt_state_from_jax, params_from_jax  # noqa
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.data import PrefetchingLoader, SyntheticCorpus  # noqa
from repro_torch.kernels.flash_attention import flash_attention  # noqa
from repro_torch.kernels.moe_gmm import grouped_ffn  # noqa: E402
from repro_torch.kernels.ssd import ssd_intra_chunk  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.api import flatten  # noqa: E402
from repro_torch.optim import AdamW, AdamWConfig  # noqa: E402
from repro_torch.runtime import (CheckpointManager, TrainConfig,  # noqa
                                 Trainer)
from repro_torch.runtime.checkpoint import flatten_state  # noqa: E402

DENSE = ["deepseek-7b", "phi4-mini-3.8b", "gemma3-27b"]
MOE = ["llama4-scout-17b-a16e", "arctic-480b"]
SSM = ["mamba2-780m", "zamba2-2.7b"]
# the encoder-decoder and the VLM, whose batches carry frames or patches;
# (arch, seq): whisper's smoke encoder has 32 frames, so 16 decoder tokens
# attend to more keys than rows and 40 to fewer; llava's 24 positions are 8
# patches and 16 text tokens
ENC_VLM = [("whisper-medium", 16), ("whisper-medium", 40),
           ("llava-next-mistral-7b", 24)]
# f32 on both sides, only the order of sums differs (observed <= 1e-7 for
# the loss, <= 1.4e-6 for a gradient leaf)
LOSS_REL = 1e-5
GRAD_REL = 1e-4
KEY = jax.random.PRNGKey(0)


def _batch(cfg, b=2, s=16, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab,
                                                size=(b, s + 1))
    return ({"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])},
            {"tokens": torch.as_tensor(toks[:, :-1]),
             "labels": torch.as_tensor(toks[:, 1:])})


def _spec_batch(cfg, b=2, s=24, seed=0):
    """A training batch in the layout of the reference's launch/
    input_specs.py::batch_specs at global batch ``b`` and seq ``s``: tokens
    and labels (one draw, shifted by one), and frames (encdec) or patches
    (vlm) as 0.1 N(0, 1) in the smoke configs' f32; drawn with numpy,
    copied for torch."""
    specs = batch_specs(cfg, ShapeSpec("train", "train", s, b))
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(b, specs["tokens"].shape[1] + 1))
    arrays = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    for key in ("frames", "patches"):
        if key in specs:
            arrays[key] = 0.1 * rng.standard_normal(specs[key].shape,
                                                    np.float32)
    assert set(arrays) == set(specs)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.tensor(v) for k, v in arrays.items()})


def _leaf_rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_every_gradient_match_jax(arch):
    """Model.train_loss and every gradient leaf against jax.grad of the JAX
    Model.train_loss; remat none, full and dots give the port the same
    gradients (gemma3 runs its sliding-window layers through flash)."""
    jm = JaxModel(jax_smoke(arch))
    jp = jm.init(KEY)
    jb, tb = _batch(jm.cfg)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.train_loss(p, jb), has_aux=True))(jp)
    jgrads = flatten(jax.device_get(jgrads))
    state = params_from_jax(jax.device_get(jp))
    grads = {}
    for remat in ("none", "full", "dots"):
        model = Model(get_smoke(arch).replace(remat=remat),
                      device="cpu").load_state(state)
        loss, met = model.train_loss(tb)
        for got, want in ((loss, jloss), (met["ce"], jmet["ce"])):
            got, want = float(got.detach()), float(want)
            assert abs(got - want) <= LOSS_REL * abs(want)
        assert float(met["aux"]) == float(jmet["aux"]) == 0.0
        loss.backward()
        grads[remat] = {n: p.grad for n, p in model.named_parameters()}
        assert set(grads[remat]) == set(jgrads)
        for name, g in grads[remat].items():
            assert g is not None and g.shape == jgrads[name].shape, name
            assert _leaf_rel(g, jgrads[name]) <= GRAD_REL, (remat, name)
    for remat in ("full", "dots"):
        for name, g in grads["none"].items():
            assert _leaf_rel(grads[remat][name], g) <= GRAD_REL


@pytest.mark.parametrize("arch", MOE)
def test_moe_loss_and_every_gradient_match_jax(arch):
    """The MoE family: total loss, ce and the load-balancing aux against
    the JAX train_loss with kernel_mode "ref" (the reference trains MoE only
    so: jax.grad fails through its Pallas kernel), and every gradient leaf,
    the router's through the dispatch and the aux included, against
    jax.grad; remat none and full, the expert FFN through GroupedFFN's plain
    backward."""
    jm = JaxModel(jax_smoke(arch))
    assert jm.cfg.kernel_mode == "ref"
    jp = jm.init(KEY)
    jb, tb = _batch(jm.cfg, seed=5)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.train_loss(p, jb), has_aux=True))(jp)
    jgrads = flatten(jax.device_get(jgrads))
    assert float(jmet["aux"]) > 0
    state = params_from_jax(jax.device_get(jp))
    for remat in ("none", "full"):
        model = Model(get_smoke(arch).replace(remat=remat),
                      device="cpu").load_state(state)
        before = grouped_ffn.launches, grouped_ffn.backward_launches
        loss, met = model.train_loss(tb)
        for got, want in ((loss, jloss), (met["ce"], jmet["ce"]),
                          (met["aux"], jmet["aux"])):
            got, want = float(got.detach()), float(want)
            assert abs(got - want) <= LOSS_REL * abs(want), (remat, got, want)
        loss.backward()
        assert (grouped_ffn.launches, grouped_ffn.backward_launches) == before
        grads = {n: p.grad for n, p in model.named_parameters()}
        assert set(grads) == set(jgrads)
        for name, g in grads.items():
            assert g is not None and g.shape == jgrads[name].shape, name
            assert _leaf_rel(g, jgrads[name]) <= GRAD_REL, (remat, name)


@pytest.mark.parametrize("seq", [16, 21], ids=["whole chunks", "ragged"])
@pytest.mark.parametrize("arch", SSM)
def test_ssm_loss_and_every_gradient_match_jax(arch, seq):
    """The SSM and hybrid families: the loss and every gradient leaf
    against jax.grad of the JAX train_loss with kernel_mode "ref" (the
    reference trains them only so: jax.grad fails through its Pallas SSD
    kernel); remat none and full, SSD through SSDIntraChunk's plain
    backward, the hybrid's shared block through FlashAttention's.  The smoke
    configs' chunk is 8: 16 tokens are two whole chunks, 21 leave a ragged
    tail that ssd_chunked pads."""
    jm = JaxModel(jax_smoke(arch))
    assert jm.cfg.kernel_mode == "ref" and seq % jm.cfg.ssm_chunk in (0, 5)
    jp = jm.init(KEY)
    jb, tb = _batch(jm.cfg, s=seq, seed=7)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.train_loss(p, jb), has_aux=True))(jp)
    jgrads = flatten(jax.device_get(jgrads))
    state = params_from_jax(jax.device_get(jp))
    for remat in ("none", "full"):
        model = Model(get_smoke(arch).replace(remat=remat),
                      device="cpu").load_state(state)
        before = ssd_intra_chunk.launches, ssd_intra_chunk.backward_launches
        loss, met = model.train_loss(tb)
        for got, want in ((loss, jloss), (met["ce"], jmet["ce"])):
            got, want = float(got.detach()), float(want)
            assert abs(got - want) <= LOSS_REL * abs(want), (remat, got, want)
        assert float(met["aux"]) == float(jmet["aux"]) == 0.0
        loss.backward()
        # the CPU runs the plain versions: no kernel is launched
        assert (ssd_intra_chunk.launches,
                ssd_intra_chunk.backward_launches) == before
        grads = {n: p.grad for n, p in model.named_parameters()}
        assert set(grads) == set(jgrads)
        for name, g in grads.items():
            assert g is not None and g.shape == jgrads[name].shape, name
            assert _leaf_rel(g, jgrads[name]) <= GRAD_REL, (remat, name)


def test_ssm_stacked_leaves_unbound_once():
    """Under autograd each stacked leaf of the mamba layers is unbound once,
    not indexed per layer (which would add a zero gradient of the whole
    leaf for every layer): the leaf's one consumer in the graph is an
    unbind, and for the hybrid's (nb, pb) leaves each of its nb blocks is
    unbound once more."""
    for arch in SSM:
        model = Model(get_smoke(arch), device="cpu").init(
            torch.Generator().manual_seed(0))
        _, tb = _batch(model.cfg, seed=8)
        loss, _ = model.train_loss(tb)
        consumers, seen, todo = {}, set(), [loss.grad_fn]
        while todo:
            fn = todo.pop()
            if fn is None or fn in seen:
                continue
            seen.add(fn)
            for nxt, _ in fn.next_functions:
                if nxt is not None:
                    consumers.setdefault(nxt, []).append(fn)
                    todo.append(nxt)
        leaf = model.params["layers"]["in_proj"]
        acc = next(f for f in seen if getattr(f, "variable", None) is leaf)
        (unbind,) = consumers[acc]
        assert type(unbind).__name__.startswith("UnbindBackward")
        if model.cfg.family == "hybrid":
            inner = consumers[unbind]
            assert len(inner) == leaf.shape[0]
            assert all(type(f).__name__.startswith("UnbindBackward")
                       for f in inner)


def test_moe_router_gradient_stays_f32_in_bf16_model():
    """In a bf16 model the router stays f32 (``Model.load_state``), and so
    does its gradient; the expert weights' gradients come back in bf16."""
    cfg = get_smoke("llama4-scout-17b-a16e").replace(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    _, tb = _batch(cfg, seed=6)
    loss, _ = model.train_loss(tb)
    loss.backward()
    params = dict(model.named_parameters())
    assert params["layers.moe.router"].grad.dtype == torch.float32
    for name in ("w_in", "w_gate", "w_out"):
        g = params[f"layers.moe.{name}"].grad
        assert g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all())
        assert g.abs().max() > 0


@pytest.mark.parametrize("arch,seq", ENC_VLM, ids=["whisper T>S",
                                                     "whisper T<S", "llava"])
def test_encdec_vlm_loss_and_every_gradient_match_jax(arch, seq):
    """The encoder-decoder and the VLM: Model.train_loss (encdec.train_loss
    for whisper, the text positions' CE for llava) and every gradient leaf
    against jax.grad of the JAX Model.train_loss with kernel_mode "ref" (the
    reference trains them only so: jax.grad fails through its Pallas flash
    kernel); remat none and full, every attention through FlashAttention's
    plain backward, whisper's encoder and cross-attention non-causal.  The
    batch is the input_specs layout."""
    jm = JaxModel(jax_smoke(arch))
    assert jm.cfg.kernel_mode == "ref"
    jp = jm.init(KEY)
    jb, tb = _spec_batch(jm.cfg, s=seq, seed=11)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.train_loss(p, jb), has_aux=True))(jp)
    jgrads = flatten(jax.device_get(jgrads))
    state = params_from_jax(jax.device_get(jp))
    for remat in ("none", "full"):
        model = Model(get_smoke(arch).replace(remat=remat),
                      device="cpu").load_state(state)
        before = flash_attention.launches, flash_attention.backward_launches
        loss, met = model.train_loss(tb)
        assert set(met) == set(jmet)
        for key, got, want in (("loss", loss, jloss),
                               *((k, met[k], jmet[k]) for k in met)):
            got, want = float(got.detach()), float(want)
            assert abs(got - want) <= LOSS_REL * abs(want), (remat, key)
        loss.backward()
        # the CPU runs the plain versions: no kernel is launched
        assert (flash_attention.launches,
                flash_attention.backward_launches) == before
        grads = {n: p.grad for n, p in model.named_parameters()}
        assert set(grads) == set(jgrads)
        for name, g in grads.items():
            assert g is not None and g.shape == jgrads[name].shape, name
            assert _leaf_rel(g, jgrads[name]) <= GRAD_REL, (remat, name)


def test_encdec_stacked_leaves_unbound_once():
    """whisper's encoder and decoder stacks, as the mamba stacks: under
    autograd each stacked leaf's one consumer is an unbind."""
    model = Model(get_smoke("whisper-medium"), device="cpu").init(
        torch.Generator().manual_seed(0))
    _, tb = _spec_batch(model.cfg, s=16, seed=12)
    loss, _ = model.train_loss(tb)
    consumers, seen, todo = {}, set(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        for nxt, _ in fn.next_functions:
            if nxt is not None:
                consumers.setdefault(nxt, []).append(fn)
                todo.append(nxt)
    for stack in ("enc_layers", "dec_layers"):
        leaf = model.params[stack]["attn"]["wq"]
        acc = next(f for f in seen if getattr(f, "variable", None) is leaf)
        (unbind,) = consumers[acc]
        assert type(unbind).__name__.startswith("UnbindBackward"), stack


@pytest.mark.parametrize("arch", ["whisper-medium", "llava-next-mistral-7b"])
def test_trainer_refuses_encdec_and_vlm(arch):
    """The loader yields tokens and labels only, as the reference's does:
    Trainer refuses the families whose batches carry frames or patches and
    names the step function and the batch layout to train them with."""
    with pytest.raises(ValueError, match="make_train_step") as err:
        Trainer(get_smoke(arch), TrainConfig(steps=1), device="cpu")
    assert "input_specs" in str(err.value)
    with pytest.raises(ValueError, match="make_train_step"):
        train_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--steps", "1"])


def test_train_step_matches_jax():
    """One make_train_step on the same parameters, optimizer state and
    batch: the metrics and every updated parameter and moment agree."""
    _train_step_matches_jax("deepseek-7b", param_rel=1e-6)


@pytest.mark.parametrize("arch", MOE)
def test_moe_train_step_matches_jax(arch):
    """The same for the MoE family.  Its gradients hold leaf elements at the
    level of rounding noise (llama4's smallest attention-key gradient is
    1.4e-8, below AdamW's eps once clipped), which the first step's update
    lr * g / (|g| + eps) turns into moves of a sizeable share of lr: the
    updated parameters are held leaf by leaf at GRAD_REL (observed <= 3e-5),
    the metrics and moments as for the dense family."""
    _train_step_matches_jax(arch, param_rel=GRAD_REL)


@pytest.mark.parametrize("arch", SSM)
def test_ssm_train_step_matches_jax(arch):
    """The same for the SSM and hybrid families, held as the MoE family is:
    mamba2's conv_b, zeros at init, is after one step its update alone, and
    one of its gradient elements is 1.2e-7 (3.2e-8 once clipped, near
    AdamW's eps), whose rounding noise (9e-5 of it) moves that element's
    update by 7.7e-4 of lr; the leaf is held at GRAD_REL (observed 3.3e-5,
    every other leaf <= 1.8e-6)."""
    _train_step_matches_jax(arch, param_rel=GRAD_REL)


@pytest.mark.parametrize("arch", ["whisper-medium", "llava-next-mistral-7b"])
def test_encdec_vlm_train_step_matches_jax(arch):
    """The same for the encoder-decoder and the VLM, on a batch of the
    input_specs layout, held as the MoE family is: whisper's encoder
    attention-key gradient holds an element of 1.5e-7 (2.4e-8 once its norm
    of 6.2 is clipped to 1, near AdamW's eps) with 5 % rounding noise, and
    llava's projector one of 3.2e-7 (2.2e-8 after a clip from 14.4) with
    11 %; the first update turns that noise into moves of a sizeable share
    of lr (those leaves 1.09e-6 and 3.27e-6 off after the step)."""
    _train_step_matches_jax(arch, param_rel=GRAD_REL, spec_batch=True)


def _train_step_matches_jax(arch, param_rel, spec_batch=False):
    cfg = jax_smoke(arch)
    jm = JaxModel(cfg)
    jp = jm.init(KEY)
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jopt = JaxAdamW(JaxAdamWConfig(**ocfg))
    jstate = {"params": jp, "opt": jopt.init(jp)}
    jb, tb = (_spec_batch(cfg, seed=3) if spec_batch
              else _batch(cfg, seed=3))
    jstate, jmet = jax.jit(jax_train_step(jm, jopt))(jstate, jb)

    model = Model(get_smoke(arch), device="cpu").load_state(
        params_from_jax(jax.device_get(jp)))
    opt = AdamW(AdamWConfig(**ocfg))
    params = dict(model.named_parameters())
    state = {"params": params, "opt": opt.init(params)}
    state, met = make_train_step(model, opt)(state, tb)
    # whisper's loss reports no aux, as the reference's encdec.train_loss
    assert set(met) == set(jmet) == {"loss", "ce", "lr", "grad_norm"} | (
        set() if cfg.family == "encdec" else {"aux"})
    for key in met:
        np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                   rtol=1e-5)
    want = flatten(jax.device_get(jstate["params"]))
    for name, p in params.items():
        assert p.grad is None
        assert _leaf_rel(p.detach(), want[name]) <= param_rel, name
    for key in ("m", "v"):
        mom = flatten(jax.device_get(jstate["opt"][key]))
        for name, m in state["opt"][key].items():
            assert _leaf_rel(m, mom[name]) <= GRAD_REL, (key, name)
    assert int(state["opt"]["count"]) == int(jstate["opt"]["count"]) == 1


def test_loader_token_stream_matches_reference():
    ours = PrefetchingLoader(SyntheticCorpus(vocab=300, seq_len=24, seed=5),
                             batch=3, seq_len=24, start_step=2)
    ref = JaxLoader(JaxCorpus(vocab=300, seq_len=24, seed=5), batch=3,
                    seq_len=24, start_step=2)
    try:
        for _ in range(3):
            a, b = next(ours), next(ref)
            for key in ("tokens", "labels"):
                np.testing.assert_array_equal(a[key], b[key])
                assert a[key].shape == (3, 24)
    finally:
        ours.close()
        ref.close()


def test_loader_moves_batches_with_to_device():
    loader = PrefetchingLoader(SyntheticCorpus(100, 8, seed=1), 2, 8,
                               to_device=lambda x: torch.as_tensor(
                                   x, dtype=torch.int64))
    try:
        batch = next(loader)
        assert batch["tokens"].dtype == torch.int64
        assert torch.equal(batch["tokens"][:, 1:], batch["labels"][:, :-1])
    finally:
        loader.close()


# ------------------------------------------------- tests/test_runtime.py
def test_checkpoint_roundtrip():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        state = {"a": torch.arange(6.0).reshape(2, 3),
                 "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
        mgr.save(7, state)
        like = {"a": torch.zeros(2, 3),
                "b": {"c": torch.zeros(4, dtype=torch.bfloat16)}}
        restored, step = mgr.restore(like)
        assert step == 7 and restored is like
        assert torch.equal(like["a"], state["a"])
        assert like["b"]["c"].dtype == torch.bfloat16
        with pytest.raises(ValueError, match="float32"):
            mgr.restore({"a": torch.zeros(2, 3, dtype=torch.bfloat16),
                         "b": {"c": torch.zeros(4, dtype=torch.bfloat16)}})


def test_checkpoint_gc_keeps_latest():
    import os
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2)
        for s in range(5):
            mgr.save(s, {"x": torch.zeros(1)})
        assert mgr.latest_step() == 4
        assert sorted(int(p.split("_")[1]) for p in os.listdir(d)) == [3, 4]


def test_crash_resume_matches_uninterrupted():
    cfg = get_smoke("deepseek-7b")
    ocfg = AdamWConfig(warmup_steps=1, total_steps=6)   # shared LR schedule
    with tempfile.TemporaryDirectory() as d:
        _, straight = Trainer(cfg, TrainConfig(
            batch=2, seq_len=16, steps=6, log_every=0), ocfg,
            device="cpu").run()
        Trainer(cfg, TrainConfig(batch=2, seq_len=16, steps=3, ckpt_every=3,
                                 ckpt_dir=d, log_every=0), ocfg,
                device="cpu").run()
        _, resumed = Trainer(cfg, TrainConfig(
            batch=2, seq_len=16, steps=6, ckpt_every=3, ckpt_dir=d,
            log_every=0), ocfg, device="cpu").run(resume=True)
        # the resumed tail must equal the uninterrupted run step for step
        np.testing.assert_allclose(straight[3:], resumed, rtol=1e-4)


def test_training_reduces_loss():
    t = Trainer(get_smoke("deepseek-7b"),
                TrainConfig(batch=4, seq_len=32, steps=30, log_every=0),
                device="cpu")
    _, losses = t.run()
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - 0.1, f"no learning: {first:.3f} -> {last:.3f}"
    assert all(np.isfinite(m["grad_norm"]) for m in t.metrics)


def test_grad_accumulation_matches_large_batch():
    cfg = get_smoke("deepseek-7b")
    runs = [Trainer(cfg, TrainConfig(batch=4, seq_len=16, steps=3,
                                     microbatches=n, log_every=0),
                    device="cpu").run()[1] for n in (1, 2)]
    # same data, same init: losses must track closely (order of sums)
    np.testing.assert_allclose(runs[0], runs[1], rtol=2e-2, atol=2e-2)


# --------------------------------------------- tests/test_system.py:54
def test_e2e_trained_model_improves():
    t = Trainer(get_smoke("phi4-mini-3.8b"),
                TrainConfig(batch=4, seq_len=32, steps=25, log_every=0),
                device="cpu")
    _, losses = t.run()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_trainer_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(get_smoke("deepseek-7b"), TrainConfig(steps=1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--smoke", "--steps", "1"])


def test_train_cli_on_cpu(capsys):
    flash_attention.launches = flash_attention.backward_launches = 0
    train_cli.main(["--arch", "gemma3-27b", "--smoke", "--device", "cpu",
                    "--steps", "3", "--batch", "2", "--seq", "16"])
    assert "final loss" in capsys.readouterr().out
    # the CPU runs the plain versions: no kernel is launched
    assert flash_attention.launches == flash_attention.backward_launches == 0


def test_train_cli_on_cpu_moe(capsys):
    before = grouped_ffn.launches, grouped_ffn.backward_launches
    train_cli.main(["--arch", "llama4-scout-17b-a16e", "--smoke", "--device",
                    "cpu", "--steps", "3", "--batch", "2", "--seq", "16"])
    assert "final loss" in capsys.readouterr().out
    assert (grouped_ffn.launches, grouped_ffn.backward_launches) == before


@pytest.mark.parametrize("arch", SSM)
def test_train_cli_on_cpu_ssm(arch, capsys):
    before = ssd_intra_chunk.launches, ssd_intra_chunk.backward_launches
    flash = flash_attention.launches, flash_attention.backward_launches
    train_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                    "3", "--batch", "2", "--seq", "20"])
    assert "final loss" in capsys.readouterr().out
    assert (ssd_intra_chunk.launches,
            ssd_intra_chunk.backward_launches) == before
    assert (flash_attention.launches,
            flash_attention.backward_launches) == flash


# ------------------------------------------ checkpoints across packages
def test_jax_checkpoint_resumes_in_the_port():
    """A JAX Trainer's checkpoint at step 3 restores into the port, whose
    steps 4-6 then match the uninterrupted JAX run."""
    ocfg = dict(warmup_steps=1, total_steps=6)
    cfg = get_smoke("deepseek-7b")
    with tempfile.TemporaryDirectory() as d:
        _, straight = JaxTrainer(jax_smoke("deepseek-7b"), JaxTrainConfig(
            batch=2, seq_len=16, steps=6, log_every=0),
            JaxAdamWConfig(**ocfg)).run()
        JaxTrainer(jax_smoke("deepseek-7b"), JaxTrainConfig(
            batch=2, seq_len=16, steps=3, ckpt_every=3, ckpt_dir=d,
            log_every=0), JaxAdamWConfig(**ocfg)).run()
        port = Trainer(cfg, TrainConfig(batch=2, seq_len=16, steps=6,
                                        ckpt_every=3, ckpt_dir=d,
                                        log_every=0),
                       AdamWConfig(**ocfg), device="cpu")
        _, resumed = port.run(resume=True)
    assert len(resumed) == 3
    np.testing.assert_allclose(resumed, straight[3:], rtol=1e-4)


def test_port_checkpoint_restores_in_jax():
    """The port's checkpoint, written in the JAX leaf order, restores
    through the JAX CheckpointManager (which matches leaves by position)
    into the JAX state: every leaf, the step count included, equal."""
    cfg = get_smoke("deepseek-7b").replace(param_dtype="bfloat16",
                                           compute_dtype="bfloat16")
    jcfg = jax_smoke("deepseek-7b").replace(param_dtype="bfloat16",
                                            compute_dtype="bfloat16")
    jtrainer = JaxTrainer(jcfg, JaxTrainConfig(steps=2))
    like = jtrainer.init_state()
    port = Trainer(cfg, TrainConfig(batch=2, seq_len=16, steps=2,
                                    log_every=0), device="cpu",
                   params=params_from_jax(jax.device_get(like["params"])),
                   opt_state=opt_state_from_jax(jax.device_get(like["opt"])))
    state, _ = port.run()
    with tempfile.TemporaryDirectory() as d:
        CheckpointManager(d).save(1, state)
        restored, step = JaxCheckpoints(d).restore(like)
    assert step == 1
    ours = flatten_state(state)
    names = ["/".join(str(getattr(k, "key", k)) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(restored)[0]]
    assert names == list(ours)
    for name, leaf in zip(names, jax.tree_util.tree_leaves(restored)):
        want = ours[name]
        assert str(leaf.dtype) == str(want.dtype)[6:], name
        np.testing.assert_array_equal(
            np.asarray(leaf.astype(jnp.float32)),
            want.detach().float().numpy())
    assert int(restored["opt"]["count"]) == 2
