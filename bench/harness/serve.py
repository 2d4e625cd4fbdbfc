"""Serving cells: the port's ``ServingEngine`` (``submit`` and ``step``)
over the seed's weights, fed the traffic's backlog: every request
submitted as the window opens; the window reports the tokens generated
over it.

The harness watches the engine from its public face alone: the requests
it submits, the completions ``step`` returns, ``utilization``, and the
model's ``prefill`` and ``decode_step``, wrapped on the model instance to
note each call and, for a prefill, which submitted prompt it took.  A
prefill gives its request's first token, a decode step one to each
active request (``replay``); every token of an engine step exists when
the step returns, since the engine reads each on the host, so each is
stamped with its step's end.  Only a traced run also times each
``decode_step`` to a synchronize, for the per-layer readers; an untraced
run adds no synchronize to the engine's own.

What decides ``correct``: a sample drawn from the seed of the requests
finished in the window, with the longest of them; the reference runs over
each prompt with its served tokens, and the number compared is the widest
gap by which a served token's reference logit lies below the reference's
best at its position."""
from __future__ import annotations

import gc
import time
import weakref
from contextlib import nullcontext

import numpy as np
import torch

from . import traffic as traffic_mod
from . import weights
from .reference import Reference
from .stats import percentile
from .trace import label


def run(ctx) -> None:
    from repro_torch.models import ArchConfig, Model
    from repro_torch.runtime.serving import ServingEngine

    tr, arch, seed = ctx.traffic, ctx.arch, ctx.seed
    device = ctx.device
    model = Model(ArchConfig(**ctx.config["arch"]), device=device)
    model.load_state(weights.draw(arch, seed, device))
    engine = ServingEngine(model, slots=tr["slots"], max_len=tr["max_len"],
                           device=device)
    requests = traffic_mod.requests(tr, seed, arch.vocab)

    by_prompt = {r["prompt"].tobytes(): i for i, r in enumerate(requests)}
    calls = []      # the model's calls in the current engine step
    events = []     # ("p", end, request index) a prefill; ("d", end, n) a decode
    decodes = []    # traced runs: (end, seconds) of each decode step
    prefill, decode = model.prefill, model.decode_step
    timed = ctx.trace_on
    mark = label if timed else (lambda name: nullcontext())

    def noted_prefill(batch, pad_to=None):
        # the prompt's tokens, just copied to the device by the engine
        key = batch["tokens"][0].cpu().numpy().astype(np.int64).tobytes()
        with mark("prefill"):
            out = prefill(batch, pad_to=pad_to)
        calls.append(("p", by_prompt.get(key)))
        return out

    def noted_decode(tokens, cache):
        calls.append(("d", round(engine.utilization * engine.slots)))
        if not timed:
            return decode(tokens, cache)
        with label("decode_step"):
            a = time.perf_counter()
            out = decode(tokens, cache)
            ctx.sync()
            e = time.perf_counter()
        decodes.append((e, e - a))
        return out

    model.prefill, model.decode_step = noted_prefill, noted_decode
    held = weakref.ref(model)       # the closer must not keep the weights
    ctx.closers.append(lambda: held() is not None and _unwrap(held()))

    # warm: the shortest and longest prompts of the mix, a few decode steps
    lens = sorted(len(r["prompt"]) for r in requests)
    for n in (lens[0], lens[-1]):
        engine.submit(np.zeros(n, np.int64) + 1, max_new=4)
    engine.run_until_drained()
    calls.clear()
    decodes.clear()
    if timed:
        ctx.wrap_kernels()

    done, ids = {}, {}

    def serve_once():
        """One engine step; its tokens stamped with its end."""
        with mark("engine.step"):
            out = engine.step()
        end = time.perf_counter()
        events.extend((kind, end, x) for kind, x in calls)
        calls.clear()
        for c in out:
            done[c.id] = c.tokens

    ctx.open_window()
    t0 = ctx.t0
    for i, r in enumerate(requests):
        ids[engine.submit(r["prompt"], max_new=r["max_new"])] = i
    steps = 0
    while True:
        ctx.trace_step(steps)
        serve_once()
        steps += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    t1 = time.perf_counter()
    ctx.close_window(t1)
    # serve on past the window (untimed) until one request has finished,
    # a minute at most
    while not done and time.perf_counter() - t1 < 60:
        serve_once()

    per = replay(events, requests, engine.slots)
    kept = [x for x in per["tokens"] if t0 < x[0] <= t1]
    ctx.values.update(
        decodes=[x for x in decodes if t0 < x[0] <= t1],
        window=(t0, t1), slots=engine.slots,
        occupancy=[(t, f) for t, f in per["occupancy"] if t0 < t <= t1],
        work=[(t, kind, n) for t, _, kind, n in kept])
    tpot = [g for _, g, _, _ in kept if g is not None]
    ctx.attempted, ctx.failed = len(requests), 0
    ctx.end_to_end["gen_tokens_per_s"] = len(kept) / (t1 - t0)
    ctx.end_to_end["tpot_p95_ms"] = 1e3 * percentile(tpot, 95)

    ctx.read_memory()
    sample = traffic_mod.check_sample(tr, seed, done)
    served = {i: (requests[ids[i]]["prompt"], done[i]) for i in sample}
    _unwrap(model)
    del engine, model, prefill, decode
    ctx.free()
    ctx.values["checked"] = served
    gap = served_gap(arch, seed, served, device)
    ctx.checks = {"logit_gap": {"value": gap,
                                "limit": ctx.limits["logit_gap"]}}


def _unwrap(model) -> None:
    for name in ("prefill", "decode_step"):
        model.__dict__.pop(name, None)


def replay(events, requests, slots: int) -> dict:
    """Each token from the model's calls in order: a prefill admits its
    request (its first token), each decode step gives every active request
    its next, a request retiring at its ``max_new``-th.  Returns
    ``tokens``, (time, gap since the request's previous token or None for
    its first, kind, context) per token, kind "prefill" with the prompt's
    length or "decode" with the positions it attends to; ``occupancy``,
    (time, active / slots) per decode step.  Raises where a decode step
    holds other requests than the replay (the engine served something else
    than was submitted)."""
    active, tokens, occupancy = {}, [], []
    for ev in events:
        if ev[0] == "p":
            _, end, i = ev
            if i is None:
                raise RuntimeError("a prefill of no submitted prompt")
            prompt = len(requests[i]["prompt"])
            active[i] = [prompt, requests[i]["max_new"] - 1, end]
            tokens.append((end, None, "prefill", prompt))
            if active[i][1] == 0:
                del active[i]
            continue
        _, end, n = ev
        if n != len(active):
            raise RuntimeError(f"a decode step of {n} active requests, "
                               f"{len(active)} admitted and unfinished")
        occupancy.append((end, n / slots))
        for i, st in list(active.items()):
            tokens.append((end, end - st[2], "decode", st[0] + 1))
            st[0], st[1], st[2] = st[0] + 1, st[1] - 1, end
            if st[1] == 0:
                del active[i]
    return {"tokens": tokens, "occupancy": occupancy}


def served_gap(arch, seed: int, served: dict, device,
               precision: str = "float32", control: bool = False) -> float:
    """The widest gap, over the served tokens of ``served`` ({id: (prompt,
    tokens)}), of the reference's best logit over the served token's.
    With ``control`` the served token at each position is instead the one
    the ``precision`` reference puts first (the control's reading)."""
    params = weights.draw(arch, seed, device)
    ref = Reference(arch, params)
    low = Reference(arch, params, precision) if control else None
    widest = 0.0
    for prompt, toks in served.values():
        seq = torch.as_tensor(np.concatenate([prompt, toks[:-1]]),
                              dtype=torch.int64, device=device)
        logits = ref.sequence_logits(seq)[len(prompt) - 1:]
        if control:
            picked = low.sequence_logits(seq)[len(prompt) - 1:].argmax(-1)
        else:
            picked = torch.as_tensor(toks, device=device)
        best = logits.max(-1).values
        got = logits.gather(-1, picked[:, None])[:, 0]
        widest = max(widest, float((best - got).max()))
        del logits
    del params, ref, low
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return widest
