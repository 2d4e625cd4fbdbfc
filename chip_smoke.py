#!/usr/bin/env python3
"""Proof that the PyTorch port (``src/repro_torch``) runs on one NVIDIA Hopper
card, and the numbers of its kernels there.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero, printing no
result line):

1. info: card name and power limit, torch and CUDA versions; TF32 off.
2. build: every CUDA kernel from the sources in the checkout, in parallel.
3. kernels vs their plain PyTorch versions on the card, at the cases of
   tests/test_kernels.py, at hd-128 prefill shapes, and at the very shapes
   that phase 5 serves.
4. the port on the card vs the same port code on the CPU (f32 smoke
   configs of deepseek-7b and gemma3-27b): greedy serving tokens equal,
   prefill logits within rel 5e-4.
5. the main path: full-width deepseek-7b (bf16, random weights from a seed)
   served by ``ServingEngine``, with every kernel launch counted.
6. kernel timing with CUDA events beside the plain version, one PyTorch
   library call as a yardstick, and the card's bound for the same work.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12          # H100 SXM HBM3

# tests/test_kernels.py:20-28 -- B, Sq, Skv, H, K, hd, causal, window
FLASH_CASES = [
    (2, 64, 64, 4, 2, 32, True, 0),
    (1, 100, 100, 4, 4, 64, True, 0),
    (2, 32, 128, 4, 1, 16, True, 0),
    (1, 128, 128, 8, 2, 64, True, 24),
    (1, 96, 96, 2, 2, 32, False, 0),
    (1, 64, 64, 2, 2, 128, True, 0),
]
# hd-128 prefill shapes at deepseek-7b's width (bf16): B, S, H, K, hd,
# window; the last adds GQA (K=8) and a sliding window of 256
PREFILL_CASES = [(1, 512, 32, 32, 128, 0), (1, 2048, 32, 32, 128, 0),
                 (2, 1024, 32, 8, 128, 256)]
TIMED = (1, 2048, 32, 32, 128, 0)
F32_TOL = dict(atol=3e-5, rtol=1e-4)       # tests/test_kernels.py
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
# Bound on row_rel_err.  Late rows of a long causal prefill average many
# values and are small (|o| ~ sqrt(e/S)), so the absolute tolerance above
# cannot see a wrong weight there; this can.  The bounds are set from the
# rounding error of sound runs on the H100 (PERF.md).
ROW_REL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -5}
MODEL_REL = 5e-4                           # tests/test_models.py:76
# the main path's traffic: 8 requests, prompts of 64-768 tokens from a seed
SERVE_REQUESTS, SERVE_NEW, SERVE_SLOTS, SERVE_MAX_LEN = 8, 32, 4, 1024


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / (want.abs().max() + 1e-9))


def row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest rms(got - want) / rms(want) over the (b, s, h) rows: the same
    yardstick for a short softmax and a long one.  (The rms, not the max, of
    a row's error: one-ulp roundings of a row's largest values set a floor
    under the max that hides a small wrong weight.)"""
    got, want = got.float(), want.float()
    err = (got - want).pow(2).mean(-1).sqrt()
    rms = want.pow(2).mean(-1).sqrt().clamp_min(1e-30)
    return float((err / rms).max())


def serve_prompts(vocab: int) -> list[np.ndarray]:
    """The prompts phase 5 serves, drawn from a fixed seed."""
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 769, size=SERVE_REQUESTS)
    return [rng.integers(0, vocab, size=int(n)) for n in lens]


def qkv(b, s, t, h, k, hd, dtype, gen):
    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return draw(b, s, h, hd), draw(b, t, k, hd), draw(b, t, k, hd)


# ------------------------------------------------------------------ phases
def phase_info() -> str:
    line = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[info] card: {line}")
    say(f"[info] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, devices "
        f"{torch.cuda.device_count()}")
    return line


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build_all()
    say(f"[build] {len(paths)} kernel(s) built in "
        f"{time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}")
    for name in paths:
        for ln in _build.build_log(name).splitlines():
            if "registers" in ln or "spill" in ln:
                say(f"[build] {name}: {ln.strip()}")


def phase_kernels() -> float:
    """Kernel vs plain version; returns the largest abs error at the
    main path's shapes (those served in phase 5, and PREFILL_CASES)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (attention_reference,
                                                     flash_attention)
    cfg = get_config("deepseek-7b")
    windows = sorted({0 if cfg.is_global_layer(i) else cfg.sliding_window
                      for i in range(cfg.n_layers)})
    gen = torch.Generator("cuda").manual_seed(0)
    dtypes = ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL))
    cases = [(b, s, t, h, k, hd, c, w, dt, tol)
             for b, s, t, h, k, hd, c, w in FLASH_CASES for dt, tol in dtypes]
    cases += [(1, 64, 64, 4, 2, 32, True, 0, dt, tol) for dt, tol in dtypes]
    main = [(b, s, s, h, k, hd, True, w, torch.bfloat16, BF16_TOL)
            for b, s, h, k, hd, w in PREFILL_CASES]
    main += [(1, len(p), len(p), cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
              True, w, torch.bfloat16, BF16_TOL)
             for p in serve_prompts(cfg.vocab) for w in windows]
    main_err, worst = 0.0, {}
    for case in cases + main:
        b, s, t, h, k, hd, causal, window, dtype, tol = case
        q, kk, v = qkv(b, s, t, h, k, hd, dtype, gen)
        got = flash_attention(q, kk, v, causal=causal, window=window)
        want = attention_reference(q, kk, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == want.shape
        err = float((got.float() - want.float()).abs().max())
        rel = row_rel_err(got, want)
        if case in main:
            main_err = max(main_err, err)
        worst[dtype] = max(worst.get(dtype, 0.0), rel)
        say(f"[kernels] flash_attn_fwd {tuple(case[:8])} "
            f"{str(dtype)[6:]}: max abs err {err:.3e} (atol {tol['atol']}, "
            f"rtol {tol['rtol']}), row rel err {rel:.3e} "
            f"(< {ROW_REL[dtype]:.3e})")
        torch.testing.assert_close(got.float(), want.float(), **tol)
        assert rel < ROW_REL[dtype], f"row rel err {rel} at {case[:8]}"
    say(f"[kernels] {len(cases + main)} cases agree; largest row rel err: "
        + ", ".join(f"{str(dt)[6:]} {r:.3e}" for dt, r in worst.items())
        + f"; largest abs err at the main path's shapes {main_err:.3e}")
    return main_err


def phase_card_vs_cpu() -> None:
    from repro_torch.configs import get_smoke
    from repro_torch.models import Model
    from repro_torch.runtime import ServingEngine
    for arch in ("deepseek-7b", "gemma3-27b"):
        cfg = get_smoke(arch)
        cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        gpu = Model(cfg, device="cuda").load_state(cpu.state_dict())
        rng = np.random.default_rng(1)
        toks = rng.integers(0, cfg.vocab, size=(2, 24))
        lc, _ = cpu.prefill({"tokens": torch.as_tensor(toks)}, pad_to=32)
        lg, _ = gpu.prefill({"tokens": torch.as_tensor(toks, device="cuda")},
                            pad_to=32)
        rel = rel_err(lg, lc)
        assert rel < MODEL_REL, f"{arch}: prefill rel {rel}"
        engines = [ServingEngine(m, slots=2, max_len=48, device=m.device)
                   for m in (cpu, gpu)]
        prompts = [rng.integers(0, cfg.vocab, size=n) for n in (5, 20, 11, 16)]
        done = []
        for eng in engines:
            for p in prompts:
                eng.submit(p, max_new=8)
            done.append([(c.id, c.tokens) for c in eng.run_until_drained()])
        assert done[0] == done[1], f"{arch}: tokens differ {done}"
        say(f"[card-vs-cpu] {arch} smoke f32: prefill logits rel {rel:.2e} "
            f"(< {MODEL_REL}); {len(done[1])} requests, greedy tokens equal")


def phase_serve(card: str) -> dict:
    """Full-width deepseek-7b through ServingEngine; the main path."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import Model
    from repro_torch.runtime import ServingEngine

    cfg = get_config("deepseek-7b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda").init(
        torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(f"[serve] deepseek-7b: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads x {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.param_dtype}: {n_params:,} "
        f"params, init {time.perf_counter() - t0:.1f} s")

    prefill_s, decode_s = [], []
    prefill, decode = model.prefill, model.decode_step

    def timed_prefill(batch, pad_to=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = prefill(batch, pad_to=pad_to)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t)
        assert bool(torch.isfinite(logits).all()), "prefill logits not finite"
        return logits, cache

    def timed_decode(tokens, cache):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = decode(tokens, cache)
        torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t)
        return out

    model.prefill, model.decode_step = timed_prefill, timed_decode
    engine = ServingEngine(model, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN)
    prompts = serve_prompts(cfg.vocab)
    lens = [len(p) for p in prompts]
    ids = [engine.submit(p, max_new=SERVE_NEW) for p in prompts]

    flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention.launches

    assert sorted(c.id for c in done) == sorted(ids), "not all completed"
    assert all(len(c.tokens) == SERVE_NEW for c in done), "wrong token counts"
    assert all(0 <= t < cfg.vocab for c in done for t in c.tokens)
    assert len(prefill_s) == SERVE_REQUESTS
    assert launches == cfg.n_layers * len(prefill_s), (
        f"flash launches {launches} != {cfg.n_layers} x {len(prefill_s)}")
    n_tok = sum(len(c.tokens) for c in done)
    res = {
        "card": card,
        "prompt_lens": [int(n) for n in lens],
        "prefill_ms_per_request": 1e3 * sum(prefill_s) / len(prefill_s),
        "prefill_ms": [1e3 * s for s in prefill_s],
        "decode_steps": len(decode_s),
        "decode_ms_per_step": 1e3 * sum(decode_s) / len(decode_s),
        "generated_tokens": n_tok,
        "drain_s": wall,
        "tokens_per_s": n_tok / wall,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "flash_launches": launches,
    }
    say(f"[serve] {len(done)} requests (prompts {res['prompt_lens']}, "
        f"{SERVE_NEW} new tokens each), slots {SERVE_SLOTS}, max_len "
        f"{SERVE_MAX_LEN}")
    say(f"[serve] prefill {res['prefill_ms_per_request']:.2f} ms/request, "
        f"decode {res['decode_ms_per_step']:.2f} ms/step over "
        f"{len(decode_s)} steps, {res['tokens_per_s']:.1f} generated "
        f"tokens/s ({n_tok} in {wall:.2f} s), max memory allocated "
        f"{res['max_memory_allocated_gb']:.2f} GB, flash launches "
        f"{launches} = {cfg.n_layers} x {len(prefill_s)} prefills "
        f"[{card}]")
    model.prefill, model.decode_step = prefill, decode
    res["profile"] = phase_profile(model, card)
    del engine, model
    torch.cuda.empty_cache()
    return res


def profile_region(fn, label: str, card: str, top: int = 8) -> dict:
    """Run ``fn`` under torch.profiler; device busy share and top kernels."""
    from torch.profiler import ProfilerActivity, profile
    fn()                                     # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + \
                ev.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
           "busy_share": busy_us / wall_us if wall_us else 0.0,
           "top": [(name[:90], us / 1e3) for name, us in ranked[:top]]}
    if busy_us == 0:
        say(f"[profile] {label}: the profiler saw no device time; "
            f"device share not measured")
        return out
    say(f"[profile] {label}: wall {out['wall_ms']:.2f} ms, device busy "
        f"{out['device_busy_ms']:.2f} ms ({100 * out['busy_share']:.1f}%) "
        f"[{card}]")
    for name, ms in out["top"]:
        say(f"[profile]   {ms:9.3f} ms  {100 * ms * 1e3 / busy_us:5.1f}%  "
            f"{name}")
    return out


def phase_profile(model, card: str) -> dict:
    """Where a full-width prefill (512 tokens) and a decode step (4 slots,
    512 cached tokens) spend their time."""
    cfg = model.cfg
    gen = torch.Generator("cuda").manual_seed(3)
    prompt = torch.randint(0, cfg.vocab, (1, 512), device="cuda",
                           generator=gen)
    cache = model.init_decode_cache(4, 1024)
    cache["pos"].fill_(512)
    tok = torch.randint(0, cfg.vocab, (4, 1), device="cuda", generator=gen)

    def decode():
        cache["pos"].fill_(512)
        model.decode_step(tok, cache)

    return {
        "prefill_512": profile_region(
            lambda: model.prefill({"tokens": prompt}, pad_to=1024),
            "prefill of 512 tokens", card),
        "decode_b4": profile_region(decode, "decode step, 4 slots", card),
    }


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_timing(card: str) -> dict:
    from repro_torch.kernels.flash_attention import (attention_reference,
                                                     flash_attention)
    b, s, h, k, hd, window = TIMED
    gen = torch.Generator("cuda").manual_seed(2)
    q, kk, v = qkv(b, s, s, h, k, hd, torch.bfloat16, gen)
    # SDPA takes (B, H, S, hd): transposed once, outside the timed call
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kk, v))
    saved = flash_attention.launches
    kernel_ms = time_ms(lambda: flash_attention(q, kk, v, causal=True), 20)
    plain_ms = time_ms(lambda: attention_reference(q, kk, v, causal=True), 5)
    library_ms = time_ms(lambda: torch.nn.functional.
                         scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True), 20)
    flash_attention.launches = saved     # comparisons do not count
    pairs = s * (s + 1) // 2             # (q, k) pairs the causal mask keeps
    flops = 4 * b * h * pairs * hd       # q.k and p.v, 2 flops per MAC
    nbytes = 2 * (2 * b * s * h * hd + 2 * b * s * k * hd)   # q, o, k, v
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    res = {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "flops": flops, "bytes": nbytes}
    say(f"[timing] flash_attn_fwd {TIMED[:5]} bf16 causal: kernel "
        f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa (yardstick) "
        f"{library_ms:.4f} ms; bound {bound_ms:.4f} ms by "
        f"{res['bound_by']} ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} "
        f"MB); {flops / kernel_ms / 1e9:.2f} TFLOP/s achieved [{card}]")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; nothing run", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    card = phase_info()
    phase_build()
    main_err = phase_kernels()
    phase_card_vs_cpu()
    serve = phase_serve(card)
    timing = phase_timing(card)

    kernels = [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attn_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:24",
        "launches": serve["flash_launches"], "max_abs_err": main_err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }]
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
