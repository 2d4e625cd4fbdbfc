"""The port's H100 roofline (``repro_torch/roofline``) against the JAX
package's: ``model_flops`` equal, ``RooflineReport`` of the same fields and
logic; each kernel's work (``kernel_model``) against the bounds PERF.md
prints; and the counter (``counting.Counter``): its rules, the FLOPs it
counts for deepseek's smoke steps against the reference's HLO count, and the
same count on meta as on the CPU for every family."""
import dataclasses
import math

import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.optim import AdamW as JaxAdamW  # noqa: E402
from repro.roofline import analyze  # noqa: E402
from repro.roofline import model_flops as jax_model_flops  # noqa: E402
from repro.roofline.model import RooflineReport as JaxReport  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import ARCHS, get_config, get_smoke  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.input_specs import batch_specs  # noqa: E402
from repro_torch.launch.shapes_util import ShapeSpec  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention, mlp, ssm  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.roofline import (HBM_BW, NVLINK_BW, PEAK_FLOPS,  # noqa
                                  Counter, RooflineReport, counting,
                                  kernel_model, model_flops)

# ----------------------------------------------------------- the model
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_jax(arch):
    """The copy keeps the reference's formula exactly, whisper's count of
    its decoder tokens alone included."""
    for kind in ("train", "prefill", "decode"):
        for batch, seq in ((2, 2048), (8, 448)):
            got = model_flops(get_config(arch), kind, batch, seq)
            assert got == jax_model_flops(jax_config(arch), kind, batch,
                                          seq)


def test_report_fields_equal_jax():
    ours = [(f.name, f.type, f.default) for f in
            dataclasses.fields(RooflineReport)]
    theirs = [(f.name, f.type, f.default) for f in
              dataclasses.fields(JaxReport)]
    assert ours == theirs


def test_roofline_report_bottleneck_h100():
    """tests/test_roofline.py's bottleneck case at the H100's peaks."""
    rep = RooflineReport(
        arch="a", shape="s", mesh="1xH100", chips=1,
        flops_per_device=PEAK_FLOPS,            # exactly 1 s of compute
        bytes_per_device=HBM_BW / 2,            # 0.5 s of memory
        collective_bytes_per_device=NVLINK_BW * 2,   # 2 s of collectives
        collective_by_kind={}, model_flops_global=PEAK_FLOPS,
    ).finalize()
    assert rep.bottleneck == "collective"
    assert rep.compute_s == pytest.approx(1.0)
    assert rep.memory_s == pytest.approx(0.5)
    assert rep.collective_s == pytest.approx(2.0)
    assert rep.useful_ratio == pytest.approx(1.0)
    assert rep.peak_fraction == pytest.approx(0.5)
    assert (PEAK_FLOPS, HBM_BW) == (989e12, 3.35e12)


# --------------------------------------------- each kernel's work, bounds
# PERF.md's kernel table: (work, bound in ms, GFLOP where it prints them)
KERNEL_BOUNDS = [
    ("flash fwd (1,2048,32,128) causal",
     kernel_model.flash_fwd(1, 2048, 2048, 32, 32, 128, True), 0.0348, None),
    ("flash fwd whisper encoder",
     kernel_model.flash_fwd(8, 1500, 1500, 16, 16, 64, False), 0.0745,
     73.73),
    ("flash bwd (2,2048,32,128)",
     kernel_model.flash_bwd(2, 2048, 2048, 32, 32, 128, True), 0.1738,
     None),
    ("flash bwd whisper encoder",
     kernel_model.flash_bwd(8, 1500, 1500, 16, 16, 64, False), 0.1864,
     184.32),
    ("moe_gmm fwd training shape",
     kernel_model.moe_gmm(2, 16, 160, 5120, 8192), 1.3028, None),
    ("moe_gmm bwd training shape",
     kernel_model.moe_gmm_bwd(2, 16, 160, 5120, 8192), 2.6056, None),
    ("ssd fwd (1,3,256,48,64) N 128",
     kernel_model.ssd(1, 3, 256, 48, 64, 128), 0.0060, None),
    ("ssd bwd (2,8,256,48,64) N 128",
     kernel_model.ssd_bwd(2, 8, 256, 48, 64, 128), 0.0410, None),
    ("ssd bwd (2,8,256,80,64) N 64",
     kernel_model.ssd_bwd(2, 8, 256, 80, 64, 64), 0.0592, None),
]


@pytest.mark.parametrize("label, work, bound_ms, gflop", KERNEL_BOUNDS,
                         ids=[c[0] for c in KERNEL_BOUNDS])
def test_kernel_model_reproduces_perf_bounds(label, work, bound_ms, gflop):
    flops, nbytes = work
    got = max(flops / PEAK_FLOPS, nbytes / HBM_BW) * 1e3
    assert f"{got:.4f}" == f"{bound_ms:.4f}", got      # as PERF.md prints
    if gflop is not None:
        assert f"{flops / 1e9:.2f}" == f"{gflop:.2f}"


def test_moe_gmm_live_rows_and_experts():
    """The served decode bound counts the live rows and experts only."""
    full = kernel_model.moe_gmm(4, 16, 4, 5120, 8192)
    live = kernel_model.moe_gmm(4, 16, 4, 5120, 8192, live_rows=4,
                                live_experts=4)
    assert live[0] == full[0] * 4 // (4 * 16 * 4)
    assert live[1] == 2 * (3 * 4 * 5120 * 8192 + 2 * 4 * 16 * 4 * 5120)


def test_attention_pairs_against_the_mask():
    from repro_torch.kernels.flash_attention.ref import _scores
    for s, t, causal, window in [(7, 7, True, 0), (5, 9, True, 0),
                                 (6, 6, True, 3), (4, 10, False, 0),
                                 (8, 8, False, 2), (9, 4, False, 0)]:
        q = torch.zeros(1, s, 1, 4)
        k = torch.zeros(1, t, 1, 4)
        _, mask = _scores(q, k, causal, window, 1.0)
        assert kernel_model.attention_pairs(s, t, causal, window) == \
            int(mask.sum())


# ------------------------------------------------------- the counter's rules
def test_counter_rules():
    """Products by flop_counter's formula, views and allocations free, an
    in-place op's operand once, host tensors skipped by a meta count."""
    a = torch.empty(8, 16, device="meta")
    b = torch.empty(16, 4, device="meta")
    host = torch.zeros(3)
    with Counter("meta") as c:
        y = a @ b                                  # mm: 2*8*16*4
        yt = y.t()                                 # a view: free
        z = torch.empty(4, 8, device="meta")       # an allocation: free
        z.add_(yt)                                 # in place: z + yt once
        host.clone()                               # not on the device
    assert c.kinds["products"] == {"flops": 2 * 8 * 16 * 4,
                                   "bytes": 4 * (8 * 16 + 16 * 4 + 8 * 4)}
    assert c.kinds["rest"] == {"flops": 0, "bytes": 4 * (32 + 32)}
    assert c.peak == 4 * (8 * 4 + 4 * 8)
    assert counting.active is None


def test_peak_follows_storage_lifetimes():
    with Counter("meta") as c:
        x = torch.ones(1000, device="meta")
        y = x * 2
        del x
        z = y * 3                                  # x freed: 2 alive at once
        del y, z
    assert c.peak == 2 * 4000 and c.live == 0


def test_regions_and_kernel_calls():
    with Counter("cpu") as c:
        with counting.region(counting.OPTIMIZER):
            torch.ones(4) * 2                      # write 4; read 4, write 4
        counting.record_kernel("moe_gmm", 10, 20)
    assert c.kinds["optimizer"]["bytes"] == 3 * 16
    assert c.kinds["moe_gmm"] == {"flops": 10, "bytes": 20}
    assert c.calls == {"moe_gmm": 1}
    counting.record_kernel("moe_gmm", 10, 20)     # no counter: nothing
    assert c.calls == {"moe_gmm": 1}


# ------------------------------------------ FLOPs against the reference's
def _jax_flops(fn, *args) -> float:
    return analyze(jax.jit(fn).lower(*args).compile().as_text(), 1).flops


def test_deepseek_smoke_flops_match_jax_hlo():
    """deepseek's smoke prefill, decode and train steps counted on the CPU
    against the reference's HLO count of its own steps (kernel_mode "ref",
    f32), within 1%.  Prefill and decode agree exactly; the training step
    differs by one product a layer, named here: the plain attention
    backward recomputes the scores q kᵀ (as the kernel does), where
    jax.grad keeps them from the forward."""
    jm = JaxModel(jax_smoke("deepseek-7b").replace(kernel_mode="ref"))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_smoke("deepseek-7b")
    model = Model(cfg, device="cpu").load_state(
        params_from_jax(jax.device_get(jp)))
    b, s, t = 2, 16, 32
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (b, s + 1))
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.tensor(toks[:, :-1]),
          "labels": torch.tensor(toks[:, 1:])}

    want = _jax_flops(jax_steps.make_prefill_step(jm), jp,
                      {"tokens": jb["tokens"]})
    with Counter("cpu") as c:
        steps.make_prefill_step(model)({"tokens": tb["tokens"]})
    assert c.flops == want

    want = _jax_flops(jax_steps.make_serve_step(jm), jp, jb["tokens"][:, :1],
                      jm.init_decode_cache(b, t))
    cache = model.init_decode_cache(b, t)
    with Counter("cpu") as c:
        steps.make_serve_step(model)(tb["tokens"][:, :1], cache)
    assert c.flops == want

    jopt = JaxAdamW()
    want = _jax_flops(jax_steps.make_train_step(jm, jopt),
                      {"params": jp, "opt": jopt.init(jp)}, jb)
    opt = AdamW()
    params = dict(model.named_parameters())
    with Counter("cpu") as c:
        steps.make_train_step(model, opt)(
            {"params": params, "opt": opt.init(params)}, tb)
    recompute = cfg.n_layers * 2 * b * cfg.n_heads * s * s * cfg.head_dim
    assert c.flops == pytest.approx(want, rel=0.01)
    assert c.flops - recompute == want


# -------------------------------------------- the same count on two devices
def _step(arch, kind, device, remat=None):
    """``kind``'s step of ``arch``'s smoke config on ``device``, ready to
    run: weights drawn from seed 0 on the CPU, shapes alone on meta."""
    cfg = get_smoke(arch)
    if remat:
        cfg = cfg.replace(remat=remat)
    model = Model(cfg, device=device)
    gen = torch.Generator().manual_seed(0)
    if device == "cpu":
        model.init(gen)
    spec = batch_specs(cfg, ShapeSpec(kind, kind, 24, 2))
    batch = spec if device == "meta" else {
        k: (torch.randint(0, cfg.vocab, v.shape, generator=gen)
            if v.dtype == torch.int64 else
            0.1 * torch.randn(v.shape, generator=gen).to(v.dtype))
        for k, v in spec.items()}
    if kind == "train":
        opt = AdamW()
        params = dict(model.named_parameters())
        state = {"params": params, "opt": opt.init(params)}
        step = steps.make_train_step(model, opt)
        return lambda: step(state, batch)
    if kind == "prefill":
        step = steps.make_prefill_step(model)
        return lambda: step(batch)
    cache = model.init_decode_cache(2, 32)
    step = steps.make_serve_step(model)
    return lambda: step(batch["tokens"], cache)


class _Spy:
    """Records the kernels' calls from the model's side (the names the
    model modules call), and each call's work from ``kernel_model``."""

    def __init__(self, monkeypatch):
        self.work: dict[str, list] = {}
        for mod, name in ((attention, "flash_attention"),
                          (mlp, "grouped_ffn"),
                          (ssm, "ssd_intra_chunk")):
            monkeypatch.setattr(mod, name, self._wrap(getattr(mod, name)))

    def add(self, kind, work):
        self.work.setdefault(kind, []).append(work)

    def _wrap(self, fn):
        def call(*args, **kw):
            x = args[0]
            grad = torch.is_grad_enabled() and any(
                isinstance(a, torch.Tensor) and a.requires_grad
                for a in args)
            if fn.__name__ == "flash_attention":
                q, k = args[0], args[1]
                b, s, h, hd = q.shape
                t, kh = k.shape[1], k.shape[2]
                causal, window = kw.get("causal", True), kw.get("window", 0)
                self.add("flash_attn_fwd", kernel_model.flash_fwd(
                    b, s, t, h, kh, hd, causal, window, q.dtype, grad))
                if grad:
                    self.add("flash_attn_bwd", kernel_model.flash_bwd(
                        b, s, t, h, kh, hd, causal, window, q.dtype))
            elif fn.__name__ == "grouped_ffn":
                shape = (*x.shape, args[1].shape[-1], args[4], x.dtype)
                # the routed pairs bound the rows and experts booked
                pairs = args[5]
                live = dict(live_rows=min(pairs, math.prod(x.shape[:3])),
                            live_experts=min(x.shape[1], pairs))
                self.add("moe_gmm", kernel_model.moe_gmm(*shape, **live))
                if grad:
                    self.add("moe_gmm_bwd",
                             kernel_model.moe_gmm_bwd(*shape, **live))
            else:
                shape = (*x.shape, args[3].shape[-1], x.dtype)
                self.add("ssd_intra_chunk", kernel_model.ssd(*shape))
                if grad:
                    self.add("ssd_intra_chunk_bwd",
                             kernel_model.ssd_bwd(*shape))
            return fn(*args, **kw)
        call.__name__ = fn.__name__
        return call

    def kinds(self) -> dict:
        return {k: {"flops": sum(w[0] for w in v),
                    "bytes": sum(w[1] for w in v)}
                for k, v in self.work.items()}


def _non_kernel(summary: dict) -> dict:
    return {k: v for k, v in summary["kinds"].items()
            if k not in counting.KERNELS}


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_count_equals_cpu_count(arch, monkeypatch):
    """Every family's smoke train, prefill and decode steps: the meta
    count's products, optimizer and rest equal the CPU count's exactly, the
    kernel calls are the same, and the meta count's kernel kinds are the
    sum of ``kernel_model`` over the calls the model made (the CPU books
    the plain versions' own aten work there)."""
    for kind in ("train", "prefill", "decode"):
        cpu_step = _step(arch, kind, "cpu")
        with Counter("cpu") as cpu:
            cpu_step()
        meta_step = _step(arch, kind, "meta")
        spy = _Spy(monkeypatch)
        with Counter("meta") as meta:
            meta_step()
        monkeypatch.undo()
        c, m = cpu.summary(), meta.summary()
        assert _non_kernel(m) == _non_kernel(c), kind
        assert m["calls"] == c["calls"], kind
        assert m["flops"] > 0 and m["bytes"] > 0
        assert {k: v for k, v in m["kinds"].items()
                if k in counting.KERNELS} == spy.kinds(), kind


@pytest.mark.parametrize("arch", ["deepseek-7b", "llama4-scout-17b-a16e",
                                  "mamba2-780m", "zamba2-2.7b",
                                  "whisper-medium"])
def test_meta_count_equals_cpu_count_under_remat(arch):
    """The full configs' remat, "full" (the RNG state the CPU stashes is no
    device work; meta stashes none): the training step counts the same."""
    counts = {}
    for device in ("cpu", "meta"):
        step = _step(arch, "train", device, "full")
        with Counter(device) as c:
            step()
        counts[device] = c.summary()
    assert _non_kernel(counts["meta"]) == _non_kernel(counts["cpu"])
    assert counts["meta"]["calls"] == counts["cpu"]["calls"]
