"""Helpers of tests/test_torch_dryrun_mesh.py, importable by the processes
it starts.

``worker`` is one rank r of a world of 2 or 4.  It first counts, in a world
of the "fake" backend at rank r (``launch/mesh.fake_world``), every count
case of its meshes on meta, as the mesh dry run counts a rank; then it joins
a gloo group and counts the same cases on the CPU with real tensors, and runs
the decode cases: ``make_serve_step`` on each mesh of SERVE_MESHES with the
whole tokens and the rank's part of a whole prefill cache, and in "tp" the
chain from ``make_prefill_step`` to it; and on each mesh of CP_MESHES the
context-parallel cases: CP_ARCHS at a batch of one, CP_STEPS chained
``make_serve_step`` steps from the rank's part of a one-process prefill's
cache of CP_LEN positions, the positions over "data".  It writes
``dm_w<world>rank<r>.json`` (the counts) and ``.npz`` (the decode outputs).

``jax_reference`` runs the JAX package on 4 forced host devices: each
SERVE_ARCHS' prefill of the prompts and its serve step jitted with the
reference's decode cell's shardings (``tok_shard`` from ``batch_shardings``
in "tp" mode, ``cache_shardings``) on each mesh of SERVE_MESHES, and each
CP_ARCHS' CP_STEPS chained steps of it on each mesh of CP_MESHES beside
one device's ``decode_step`` logits; and
deepseek-7b's train, prefill and decode steps on FLOPS_MESH in "tp" with its
shardings, measured by ``repro.roofline.analyze``.  ``jax_state_bytes``
(512 forced host devices) gives each arch's per-device parameter and
optimizer-state bytes on both production meshes from ``shard_shape``, and
the decode cache's bytes by leaf of CACHE_CELLS.
"""
from __future__ import annotations

import json
import os

import numpy as np

import _torch_tp as tt

AXES = ("data", "model")
# meta against gloo: the five families of the mesh dry run's cells
COUNT_ARCHS = ("deepseek-7b", "llama4-scout-17b-a16e", "mamba2-780m",
               "whisper-medium", "llava-next-mistral-7b")
COUNT_MESHES = [(1, 2), (2, 2)]
MODES = ("tp", "fsdp")
KINDS = ("train", "prefill", "decode")
SEQ = 16
ROWS = 4
# an "fsdp" batch smaller than the mesh: its sequence split over "model"
SPLIT_ROWS = {(1, 2): 1, (2, 2): 2}
# the decode step's rows against JAX's
SERVE_ARCHS = ("deepseek-7b", "llama4-scout-17b-a16e", "mamba2-780m",
               "zamba2-2.7b", "whisper-medium", "llava-next-mistral-7b")
SERVE_MESHES = [(1, 2), (2, 2), (2, 1)]
MESHES = {2: [(1, 2), (2, 1)], 4: [(2, 2)]}
PROMPT = 8            # the prompts: the first PROMPT tokens of tt's batch
PAD = 4               # decode slots past the prompt
FLOPS_ARCH = "deepseek-7b"
FLOPS_MESH = (2, 2)
# context-parallel decode of a batch of one: CP_PROMPT tokens prefilled
# into a cache of CP_LEN positions, then CP_STEPS chained steps, so that
# each rank of "data" holds CP_LEN / 2 positions, ``pos`` crosses from the
# prompt's rank to the next, and gemma3's windowed layers (window 8) leave
# rank 0 no position at the last step; whisper's 32 encoder positions lie
# over "data" too
CP_ARCHS = ("gemma3-27b", "zamba2-2.7b", "deepseek-7b", "whisper-medium")
CP_MESHES = [(2, 1), (2, 2)]
CP_PROMPT, CP_LEN, CP_STEPS = 8, 16, 8
INPUT_ARCHS = SERVE_ARCHS + ("gemma3-27b",)
# the per-rank decode-cache bytes held against the reference's shard_shape
CACHE_CELLS = (("mamba2-780m", "long_500k"), ("zamba2-2.7b", "long_500k"),
               ("gemma3-27b", "long_500k"), ("deepseek-7b", "decode_32k"))


def tag(shape) -> str:
    return "x".join(map(str, shape))


def count_cfg(arch: str):
    from repro_torch.configs import get_smoke
    return tt.smoke(arch, get_smoke).replace(remat="full")


def count_cases(shape) -> list[tuple[str, str, str, int]]:
    """(arch, mode, kind, rows) of a mesh: each family's three steps in
    both modes on ROWS rows, and its fsdp train and prefill steps on a
    batch smaller than the mesh."""
    out = [(a, m, k, ROWS) for a in COUNT_ARCHS for m in MODES for k in KINDS]
    out += [(a, "fsdp", k, SPLIT_ROWS[shape]) for a in COUNT_ARCHS
            for k in ("train", "prefill")]
    return out


def case_key(shape, arch: str, mode: str, kind: str, rows: int) -> str:
    return f"{tag(shape)}/{arch}/{mode}/{kind}/{rows}"


def count_step(arch: str, mode: str, kind: str, rows: int, mesh,
               device: str):
    """The step of a count case ready to run, on ``device``: "meta" (shapes
    alone, the dry run's inputs: the rank's decode cache from
    ``cache_specs``) or "cpu" (seed-0 weights, seed-1 inputs, the rank's
    part of a whole zero cache)."""
    import torch

    from repro_torch.launch.input_specs import batch_specs, cache_specs
    from repro_torch.launch.shapes_util import ShapeSpec
    from repro_torch.launch.steps import (make_prefill_step,
                                          make_serve_step, make_train_step)
    from repro_torch.models import Model
    from repro_torch.models.common import set_sharding_mode
    from repro_torch.optim import AdamW
    cfg = count_cfg(arch)
    set_sharding_mode(mode)
    try:
        model = Model(cfg, device=device, mesh=mesh)
    finally:
        set_sharding_mode("tp")
    shape = ShapeSpec(kind, kind, SEQ, rows)
    spec = batch_specs(cfg, shape)
    if device == "meta":
        batch = spec
    else:
        model.init(torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(1)
        batch = {k: (torch.randint(0, cfg.vocab, v.shape, generator=gen)
                     if v.dtype == torch.int64 else
                     0.1 * torch.randn(v.shape, generator=gen).to(v.dtype))
                 for k, v in spec.items()}
    if kind == "train":
        opt = AdamW()
        params = dict(model.named_parameters())
        state = {"params": params, "opt": opt.init(params, model, zero1=True)}
        step = make_train_step(model, opt)
        return lambda: step(state, batch)
    if kind == "prefill":
        step = make_prefill_step(model)
        return lambda: step(batch)
    if device == "meta":
        cache = cache_specs(cfg, shape, mesh, mode)
    else:
        cache = model.cache_part(Model(cfg, device="cpu").init_decode_cache(
            rows, SEQ))
    step = make_serve_step(model)
    return lambda: step(batch["tokens"], cache)


def digest(summary: dict) -> dict:
    """What a rank's count holds to the other device's: the kinds but the
    kernels' (whose work the CPU books as its plain versions' aten ops),
    the kernel calls and every collective figure."""
    from repro_torch.roofline import counting
    return {"kinds": {k: v for k, v in summary["kinds"].items()
                      if k not in counting.KERNELS},
            "flops": summary["flops"],
            **{k: summary[k] for k in ("calls", "collective_counts",
                                       "collective_by_kind",
                                       "collective_by_axis",
                                       "collective_calls")}}


def count(arch, mode, kind, rows, mesh, device: str) -> dict:
    from repro_torch.roofline import Counter
    run = count_step(arch, mode, kind, rows, mesh, device)
    with Counter(device, mesh) as c:
        run()
    return digest(c.summary())


def prompts(data, arch: str) -> dict:
    """The prompts: the first PROMPT tokens of tt's batch, and its frames
    or patches."""
    b = tt.batch(data, arch)
    out = {"tokens": b["tokens"][:, :PROMPT].contiguous()}
    for key in ("frames", "patches"):
        if key in b:
            out[key] = b[key]
    return out


def _pad_kv(cache: dict, t: int) -> dict:
    """k/v padded with zeros to ``t`` positions (decode slots)."""
    import torch.nn.functional as F
    out = dict(cache)
    for key in ("k", "v"):
        if key in out:
            out[key] = F.pad(out[key], (0, 0, 0, 0, 0, t - out[key].shape[2]))
    return out


def serve_cases(data, mesh, shape, res: dict) -> None:
    """Each SERVE_ARCHS' decode step on ``mesh``: the whole prefill of one
    process, then in both modes ``make_serve_step`` on the whole greedy
    tokens and the rank's part of that cache; in "tp" also the chain from
    ``make_prefill_step`` on the mesh."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import Model
    from repro_torch.models.common import set_sharding_mode
    t = tag(shape)
    for arch in SERVE_ARCHS:
        cfg = tt.smoke(arch, get_smoke)
        batch = prompts(data, arch)
        whole = Model(cfg, device="cpu").load_state(tt.state(data, arch))
        n = PROMPT + (cfg.n_patches if cfg.family == "vlm" else 0)
        logits, cache0 = whole.prefill(batch, pad_to=n + PAD)
        tok0 = whole.greedy(logits)[:, None]
        res[f"serve/{t}/{arch}/tok0"] = tok0.numpy()
        for mode in MODES:
            set_sharding_mode(mode)
            try:
                model = Model(cfg, device="cpu", mesh=mesh).load_state(
                    tt.state(data, arch))
            finally:
                set_sharding_mode("tp")
            part = model.cache_part({k: v.clone() for k, v in
                                     cache0.items()})
            tok1, cache1 = make_serve_step(model)(tok0, part)
            res[f"serve/{t}/{arch}/{mode}/tok1"] = tok1.numpy()
            for k, v in cache1.items():
                res[f"serve/{t}/{arch}/{mode}/cache/{k}"] = v.numpy()
            if mode == "tp":
                toks, c = make_prefill_step(model)(batch)
                res[f"serve/{t}/{arch}/chain/tok0"] = toks.numpy()
                tok1, cache1 = make_serve_step(model)(tok0,
                                                      _pad_kv(c, n + PAD))
                res[f"serve/{t}/{arch}/chain/tok1"] = tok1.numpy()
                for k, v in cache1.items():
                    res[f"serve/{t}/{arch}/chain/cache/{k}"] = v.numpy()


def cp_prompt(data, arch: str) -> dict:
    """The context-parallel cases' batch of one: the first CP_PROMPT tokens
    of tt's first row, and its frames."""
    b = prompts(data, arch)
    return {k: v[:1, :CP_PROMPT] if k == "tokens" else v[:1]
            for k, v in b.items()}


def cp_cases(data, mesh, shape, res: dict) -> None:
    """Each CP_ARCHS' batch of one on ``mesh``: a one-process prefill of
    ``cp_prompt`` into CP_LEN positions, CP_STEPS chained
    ``make_serve_step`` steps without a mesh (its tokens and logits), then
    in both modes the same steps from the rank's part of that cache
    (``Model.cache_part``): the rank's tokens, logits and cache."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import Model
    from repro_torch.models.common import set_sharding_mode
    t = tag(shape)
    for arch in CP_ARCHS:
        cfg = tt.smoke(arch, get_smoke)
        whole = Model(cfg, device="cpu").load_state(tt.state(data, arch))
        logits, cache0 = whole.prefill(cp_prompt(data, arch), pad_to=CP_LEN)
        tok0 = whole.greedy(logits)[:, None]
        models = {"one": whole}
        for mode in MODES:
            set_sharding_mode(mode)
            try:
                models[mode] = Model(cfg, device="cpu", mesh=mesh
                                     ).load_state(tt.state(data, arch))
            finally:
                set_sharding_mode("tp")
        for key, model in models.items():
            cache = model.cache_part({k: v.clone() for k, v in
                                      cache0.items()})
            seen: list = []
            greedy = model.greedy
            model.greedy = lambda x, g=greedy: (seen.append(x.clone()),
                                                g(x))[1]
            step, tok, toks = make_serve_step(model), tok0, []
            for _ in range(CP_STEPS):
                tok, cache = step(tok, cache)
                toks.append(tok)
            pre = f"cp/{t}/{arch}/{key}"
            res[f"{pre}/tok"] = np.stack([x.numpy() for x in toks])
            res[f"{pre}/logits"] = np.stack([x.numpy() for x in seen])
            if key != "one":
                for k, v in cache.items():
                    res[f"{pre}/cache/{k}"] = v.numpy()


def worker(rank: int, world: int, store: str, inputs: str,
           out_dir: str) -> None:
    """One rank of a world of ``world``: the meta counts in a fake world,
    then a gloo group's counts and decode cases (see the docstring)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import MeshSpec, fake_world, make_mesh
    torch.set_num_threads(1)
    counts: dict = {}
    for shape in MESHES[world]:
        if shape not in COUNT_MESHES:
            continue
        with fake_world(MeshSpec(AXES, shape), rank) as mesh:
            for case in count_cases(shape):
                counts[f"meta/{case_key(shape, *case)}"] = count(
                    *case, mesh, "meta")
    data = np.load(inputs)
    res: dict = {}
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        for shape in MESHES[world]:
            mesh = make_mesh(shape, AXES, device="cpu")
            if shape in COUNT_MESHES:
                for case in count_cases(shape):
                    counts[f"cpu/{case_key(shape, *case)}"] = count(
                        *case, mesh, "cpu")
            if shape in SERVE_MESHES:
                serve_cases(data, mesh, shape, res)
            if shape in CP_MESHES:
                cp_cases(data, mesh, shape, res)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"dm_w{world}rank{rank}.json"), "w") as f:
        json.dump(counts, f)
    np.savez(os.path.join(out_dir, f"dm_w{world}rank{rank}.npz"), **res)


def jax_reference(inputs: str, out: str) -> None:
    """The JAX package on 4 forced host devices (see the docstring)."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs import get_smoke
    from repro.launch import steps
    from repro.launch.shardings import (batch_shardings, cache_shardings,
                                        opt_shardings, param_shardings)
    from repro.models import Model
    from repro.optim import AdamW
    from repro.roofline import analyze
    data = np.load(inputs)
    res: dict = {}
    meshes = {s: jax.make_mesh(s, AXES, axis_types=(AxisType.Auto,) * 2,
                               devices=jax.devices()[:int(np.prod(s))])
              for s in SERVE_MESHES}

    def shapes_of(tree):
        return jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                            tree)

    jobs: list = []           # (key, lowered, arguments)
    for arch in SERVE_ARCHS:
        cfg = tt.smoke(arch, get_smoke).replace(kernel_mode="ref")
        jm = Model(cfg)
        tree = tt._tree(data, arch)
        toks = data[f"{arch}/tokens"]
        batch = {"tokens": toks[:, :PROMPT]}
        for key in ("frames", "patches"):
            if f"{arch}/{key}" in data.files:
                batch[key] = data[f"{arch}/{key}"]
        n = PROMPT + (cfg.n_patches if cfg.family == "vlm" else 0)
        logits, cache0 = jm.prefill(tree, batch, pad_to=n + PAD)
        tok0 = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        res[f"{arch}/tok0"] = tok0
        for key, v in cache0.items():
            res[f"{arch}/cache0/{key}"] = v
        step = steps.make_serve_step(jm)
        for shape, mesh in meshes.items():
            fn = jax.jit(step, in_shardings=(
                param_shardings(shapes_of(tree), mesh, "tp"),
                batch_shardings({"tokens": shapes_of(tok0)}, mesh)["tokens"],
                cache_shardings(shapes_of(cache0), cfg, mesh)),
                out_shardings=(None, cache_shardings(shapes_of(cache0), cfg,
                                                     mesh)))
            with jax.set_mesh(mesh):
                jobs.append((f"{arch}/{tag(shape)}", fn.lower(
                    tree, tok0, cache0), (tree, tok0, cache0)))
    # the context-parallel cases: CP_STEPS chained steps of the serve step
    # jitted with cache_shardings (the positions of a batch of one over
    # "data"), and one device's decode_step for the logits
    cp_jobs: list = []        # (key, lowered, (tree, tok0, cache0))
    for arch in CP_ARCHS:
        cfg = tt.smoke(arch, get_smoke).replace(kernel_mode="ref")
        jm = Model(cfg)
        tree = tt._tree(data, arch)
        batch = {"tokens": data[f"{arch}/tokens"][:1, :CP_PROMPT]}
        for key in ("frames", "patches"):
            if f"{arch}/{key}" in data.files:
                batch[key] = data[f"{arch}/{key}"][:1]
        logits, cache0 = jm.prefill(tree, batch, pad_to=CP_LEN)
        tok0 = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        step = steps.make_serve_step(jm)
        for shape in CP_MESHES:
            mesh = meshes[shape]
            sh = cache_shardings(shapes_of(cache0), cfg, mesh)
            fn = jax.jit(step, in_shardings=(
                param_shardings(shapes_of(tree), mesh, "tp"),
                batch_shardings({"tokens": shapes_of(tok0)}, mesh)["tokens"],
                sh), out_shardings=(None, sh))
            with jax.set_mesh(mesh):
                cp_jobs.append((f"cp/{arch}/{tag(shape)}", fn.lower(
                    tree, tok0, cache0), (tree, tok0, cache0)))
        dec = jax.jit(jm.decode_step)
        tok, cache, seen = tok0, cache0, []
        for _ in range(CP_STEPS):
            lg, cache = dec(tree, tok, cache)
            seen.append(lg)
            tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)[:, None]
        res[f"cp/{arch}/one/logits"] = np.stack(seen)
    jobs += cp_jobs
    # deepseek-7b's steps on FLOPS_MESH in "tp" with the reference's
    # shardings, as its dry run lowers them: per-device FLOPs of the HLO
    cfg = tt.smoke(FLOPS_ARCH, get_smoke).replace(remat="full",
                                                  kernel_mode="ref")
    jm = Model(cfg)
    mesh = meshes[FLOPS_MESH]
    tree = tt._tree(data, FLOPS_ARCH)
    ps = shapes_of(tree)
    p_shard = param_shardings(ps, mesh, "tp")
    toks = data[f"{FLOPS_ARCH}/tokens"][:ROWS, :SEQ + 1]
    train = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    opt = AdamW()
    os_ = jax.eval_shape(opt.init, ps)
    st_shard = {"params": p_shard,
                "opt": opt_shardings(os_, ps, mesh, zero1=True, mode="tp")}
    flops_jobs = {}
    with jax.set_mesh(mesh):
        fn = jax.jit(steps.make_train_step(jm, opt),
                     in_shardings=(st_shard, batch_shardings(
                         shapes_of(train), mesh)),
                     out_shardings=(st_shard, None))
        flops_jobs["train"] = fn.lower({"params": ps, "opt": os_},
                                        shapes_of(train))
        pre = {"tokens": train["tokens"]}
        prefill = steps.make_prefill_step(jm)
        out_shape = jax.eval_shape(prefill, ps, shapes_of(pre))
        fn = jax.jit(prefill, in_shardings=(p_shard, batch_shardings(
            shapes_of(pre), mesh)), out_shardings=(None, cache_shardings(
                out_shape[1], cfg, mesh)))
        flops_jobs["prefill"] = fn.lower(ps, shapes_of(pre))
        cache = jax.eval_shape(lambda: jm.init_decode_cache(ROWS, SEQ))
        tok = jax.ShapeDtypeStruct((ROWS, 1), jnp.int32)
        c_shard = cache_shardings(cache, cfg, mesh)
        fn = jax.jit(steps.make_serve_step(jm), in_shardings=(
            p_shard, batch_shardings({"tokens": tok}, mesh)["tokens"],
            c_shard), out_shardings=(None, c_shard))
        flops_jobs["decode"] = fn.lower(ps, tok, cache)
    everything = [j[1] for j in jobs] + list(flops_jobs.values())
    with ThreadPoolExecutor(4) as pool:
        compiled = list(pool.map(lambda lo: lo.compile(), everything))
    for (key, _, args), fn in zip(jobs, compiled):
        if key.startswith("cp/"):
            tree, tok, cache = args
            toks = []
            for _ in range(CP_STEPS):
                tok, cache = fn(tree, tok, cache)
                tok = np.asarray(tok)
                toks.append(tok)
            res[f"{key}/tok"] = np.stack(toks)
            for k, v in cache.items():
                res[f"{key}/cache/{k}"] = v
            continue
        tok1, cache1 = fn(*args)
        res[f"{key}/tok1"] = tok1
        for k, v in cache1.items():
            res[f"{key}/cache1/{k}"] = v
    for kind, fn in zip(flops_jobs, compiled[len(jobs):]):
        st = analyze(fn.as_text(), int(np.prod(FLOPS_MESH)))
        res[f"flops/{kind}"] = st.flops
        for k, v in st.collective_by_kind.items():
            res[f"flops/{kind}/collective/{k}"] = v
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})


def jax_state_bytes(out: str) -> None:
    """Each arch's per-device parameter and optimizer-state bytes on both
    production meshes, each mode, with and without ZeRO-1: the sum over the
    leaves of ``NamedSharding.shard_shape`` times the item size, on
    ``eval_shape`` trees (512 forced host devices; nothing compiled); and
    each CACHE_CELLS decode cache's bytes by leaf, by ``cache_shardings``."""
    import jax

    from repro.configs import ARCHS, SHAPES, get_config
    from repro.launch.input_specs import cache_specs
    from repro.launch.mesh import make_production_mesh
    from repro.launch.shardings import (cache_shardings, opt_shardings,
                                        param_shardings)
    from repro.models import Model
    from repro.optim import AdamW, AdamWConfig

    def nbytes(tree, shard) -> int:
        return sum(int(np.prod(s.shard_shape(x.shape))) * x.dtype.itemsize
                   for x, s in zip(jax.tree.leaves(tree),
                                   jax.tree.leaves(shard)))

    res = {}
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        for arch in ARCHS:
            cfg = get_config(arch)
            ps = jax.eval_shape(Model(cfg).init, jax.random.key(0))
            moments = ("bfloat16" if cfg.param_counts()["total"] > 1e11
                       else "float32")
            os_ = jax.eval_shape(AdamW(AdamWConfig(
                moment_dtype=moments)).init, ps)
            for mode in MODES:
                pb = nbytes(ps, param_shardings(ps, mesh, mode=mode))
                for zero1 in (True, False):
                    ob = nbytes(os_, opt_shardings(os_, ps, mesh, zero1=zero1,
                                                   mode=mode))
                    res[f"{int(multi_pod)}/{arch}/{mode}/{int(zero1)}"] = \
                        (pb, ob)
        for arch, shape in CACHE_CELLS:
            cache = cache_specs(get_config(arch), SHAPES[shape])
            sh = cache_shardings(cache, get_config(arch), mesh)
            res[f"cache/{int(multi_pod)}/{arch}/{shape}"] = {
                k: nbytes(v, sh[k]) for k, v in cache.items()}
    with open(out, "w") as f:
        json.dump(res, f)
