"""Helpers of tests/test_torch_seq_split.py, importable by the processes
they start (tests/_torch_seq_families.py reuses them).

The "fsdp" layout of a batch smaller than the mesh: ``small_rows(shape)``
rows of SEQ tokens on (1, 2), (1, 4) and (2, 2), whose rows the rules put
over "data" and whose sequence over "model".  ``make_inputs`` draws the
weights (the port's init, seed 0) and the tokens once, into an npz that
both sides read.  ``worker`` is one rank of a gloo group on the CPU: at
world 1 one process without a mesh on the first 1 and 2 rows (the
references), at world 2 and 4 every mesh of that world in "fsdp" mode
through ``make_train_step`` and ``make_prefill_step`` on the whole small
batch, and the MoE's ``make_prefill_step`` on a batch that divides the
mesh (MOE_ARCH on MOE_MESHES); it writes ``seq_w<world>rank<r>.npz``.  ``jax_reference`` runs the
JAX package's GSPMD fsdp step and prefill step on 4 forced host devices
(``set_sharding_mode("fsdp")``, ``in_shardings`` from ``param_shardings``
and ``batch_shardings`` in "fsdp" mode, ``AxisType.Auto`` meshes).
"""
from __future__ import annotations

import os

import numpy as np

import _torch_tp as tt

AXES = ("data", "model")
MESHES = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}
ALL_MESHES = [s for w in (2, 4) for s in MESHES[w]]
# the dense (gemma3-27b: a window of 8 over 16 tokens, which crosses the
# ranks' boundaries), SSM and hybrid families, which carry the split out
ARCHS = ("deepseek-7b", "gemma3-27b", "mamba2-780m", "zamba2-2.7b")
# the MoE's prefill in "fsdp" mode on a batch of as many rows as the mesh
# has ranks, its rows over every axis, "model" too (the all-to-all's row
# exchange): llama4-scout's smoke config at a capacity no row's pairs
# reach, so that the capacity of a slice of the sequence keeps every pair
# one process keeps
MOE_ARCH = "llama4-scout-17b-a16e"
MOE_MESHES = [(1, 2), (2, 2)]
MOE_ROWS = sorted(int(np.prod(s)) for s in MOE_MESHES)
SEQ = 16
TRAIN_STEPS = 3
OPT = tt.OPT


def tag(shape) -> str:
    return "x".join(map(str, shape))


def small_rows(shape) -> int:
    """A batch smaller than a mesh of ``shape``: half its ranks' rows."""
    return max(1, int(np.prod(shape)) // 2)


ROWS = sorted({small_rows(s) for s in ALL_MESHES})


def train_cfg(arch: str):
    from repro_torch.configs import get_smoke
    cfg = get_smoke(arch).replace(remat="full")
    if arch == MOE_ARCH:
        return cfg.replace(capacity_factor=float(cfg.n_experts))
    return cfg


def make_inputs(path) -> None:
    import torch

    from repro_torch.models import Model
    out = {}
    for i, arch in enumerate((*ARCHS, MOE_ARCH)):
        model = Model(train_cfg(arch), device="cpu").init(
            torch.Generator().manual_seed(0))
        for name, p in model.named_parameters():
            out[f"{arch}/state/{name}"] = p.detach().numpy()
        rng = np.random.default_rng(70 + i)
        rows = max(MOE_ROWS) if arch == MOE_ARCH else max(ROWS)
        out[f"{arch}/tokens"] = rng.integers(
            0, model.cfg.vocab, size=(rows, SEQ + 1))
    np.savez(path, **out)


def batch(data, arch: str, rows: int) -> dict:
    """The first ``rows`` rows of the training batch."""
    import torch
    toks = torch.tensor(data[f"{arch}/tokens"][:rows])
    return {"tokens": toks[:, :-1].contiguous(),
            "labels": toks[:, 1:].contiguous()}


def train_run(model, data, arch: str, rows: int) -> dict:
    """TRAIN_STEPS ``make_train_step`` steps on the whole batch of
    ``rows`` rows: the losses and grad norms, the step-1 gradients as
    AdamW receives them and the parameters after the steps (the rank's
    parts on a mesh)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamW, AdamWConfig
    opt = AdamW(AdamWConfig(**OPT))
    grads: dict = {}
    update = opt.update

    def keep(g, *args, **kw):
        if not grads:
            grads.update({n: t.detach().clone() for n, t in g.items()})
        return update(g, *args, **kw)

    opt.update = keep
    params = dict(model.named_parameters())
    st = {"params": params, "opt": opt.init(params, model)}
    step = make_train_step(model, opt)
    hist: dict = {"loss": [], "grad_norm": []}
    for _ in range(TRAIN_STEPS):
        st, met = step(st, batch(data, arch, rows))
        for k in hist:
            hist[k].append(float(met[k]))
    res = {k: np.array(v) for k, v in hist.items()}
    res.update({f"grad/{n}": t.numpy() for n, t in grads.items()})
    res.update({f"param/{n}": p.detach().numpy().copy()
                for n, p in params.items()})
    return res


def prefill_run(model, data, arch: str, rows: int) -> dict:
    """``make_prefill_step`` on the whole prompts (the batch's tokens):
    the greedy tokens and every cache leaf (the rank's rows on a mesh)."""
    import torch

    from repro_torch.launch.steps import make_prefill_step
    with torch.no_grad():
        toks, cache = make_prefill_step(model)(
            {"tokens": batch(data, arch, rows)["tokens"]})
    out = {"prefill/tokens": toks.numpy()}
    out.update({f"prefill/cache/{k}": v.numpy() for k, v in cache.items()})
    return out


def worker(rank: int, world: int, store: str, inputs: str,
           out_dir: str) -> None:
    """One rank of a gloo group of ``world``: every case of that world
    size, written to ``out_dir/seq_w<world>rank<rank>.npz``."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import split_batch
    from repro_torch.models import Model
    from repro_torch.models.common import set_sharding_mode
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    data = np.load(inputs)
    res: dict = {}
    try:
        if world == 1:
            for arch in ARCHS:
                for rows in ROWS:
                    for run in (train_run, prefill_run):
                        model = Model(train_cfg(arch), device="cpu") \
                            .load_state(tt.state(data, arch))
                        for k, v in run(model, data, arch, rows).items():
                            res[f"one{rows}/{arch}/{k}"] = v
            for rows in MOE_ROWS:
                model = Model(train_cfg(MOE_ARCH), device="cpu") \
                    .load_state(tt.state(data, MOE_ARCH))
                for k, v in prefill_run(model, data, MOE_ARCH, rows).items():
                    res[f"one{rows}/{MOE_ARCH}/{k}"] = v
        for shape in MESHES.get(world, ()):
            mesh = make_mesh(shape, AXES, device="cpu")
            t = tag(shape)
            rows = small_rows(shape)
            for arch in ARCHS:
                _, row_ax, seq_ax, _ = split_batch(batch(data, arch, rows),
                                                   mesh, "fsdp")
                res[f"{t}/{arch}/rows"] = np.array(row_ax)
                res[f"{t}/{arch}/seq"] = np.array(seq_ax)
                for run in (train_run, prefill_run):
                    set_sharding_mode("fsdp")
                    try:
                        model = Model(train_cfg(arch), device="cpu",
                                      mesh=mesh).load_state(
                                          tt.state(data, arch))
                    finally:
                        set_sharding_mode("tp")
                    for k, v in run(model, data, arch, rows).items():
                        res[f"{t}/{arch}/{k}"] = v
            if shape in MOE_MESHES:
                set_sharding_mode("fsdp")
                try:
                    model = Model(train_cfg(MOE_ARCH), device="cpu",
                                  mesh=mesh).load_state(
                                      tt.state(data, MOE_ARCH))
                finally:
                    set_sharding_mode("tp")
                for k, v in prefill_run(model, data, MOE_ARCH,
                                        int(np.prod(shape))).items():
                    res[f"{t}/{MOE_ARCH}/{k}"] = v
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"seq_w{world}rank{rank}.npz"), **res)


def jax_reference(inputs: str, out: str) -> None:
    """The JAX package's GSPMD fsdp steps on the same inputs: for each
    arch and mesh, ``value_and_grad`` of ``train_loss`` and
    ``make_prefill_step`` on the mesh's small batch."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    from jax.sharding import AxisType

    from repro.configs import get_smoke
    from repro.launch.shardings import batch_shardings, param_shardings
    from repro.launch.steps import make_prefill_step
    from repro.models import Model
    from repro.models.common import set_sharding_mode
    data = np.load(inputs)
    res: dict = {}
    jobs: list = []
    meshes = {s: jax.make_mesh(s, AXES, axis_types=(AxisType.Auto,) * 2,
                               devices=jax.devices()[:int(np.prod(s))])
              for s in ALL_MESHES}

    def name_of(path) -> str:
        return ".".join(str(p.key) for p in path)

    def sds(tree):
        return jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                            tree)

    set_sharding_mode("fsdp")
    for arch in ARCHS:
        tree = tt._tree(data, arch)
        jm = Model(get_smoke(arch).replace(kernel_mode="ref", remat="full"))
        vg = jax.value_and_grad(lambda p, bb, jm=jm: jm.train_loss(p, bb)[0])
        pre = make_prefill_step(jm)
        for shape, mesh in meshes.items():
            toks = data[f"{arch}/tokens"][:small_rows(shape)]
            b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            pb = {"tokens": b["tokens"]}
            psh = param_shardings(sds(tree), mesh, "fsdp")
            t = f"{tag(shape)}/{arch}"
            with jax.set_mesh(mesh):
                jobs.append((f"{t}/gspmd", jax.jit(vg, in_shardings=(
                    psh, batch_shardings(sds(b), mesh, "fsdp"))).lower(
                        tree, b), (tree, b)))
                jobs.append((f"{t}/gspmd_prefill", jax.jit(
                    pre, in_shardings=(psh, batch_shardings(
                        sds(pb), mesh, "fsdp"))).lower(tree, pb),
                             (tree, pb)))
    # XLA compiles outside the interpreter lock: compile side by side
    with ThreadPoolExecutor(4) as pool:
        compiled = list(pool.map(lambda j: j[1].compile(), jobs))
    for (key, _, args), fn in zip(jobs, compiled):
        first, second = fn(*args)
        if key.endswith("prefill"):
            res[f"{key}/tokens"] = first
            for k, v in second.items():
                res[f"{key}/cache/{k}"] = v
            continue
        res[f"{key}/loss"] = first
        for path, g in jax.tree_util.tree_leaves_with_path(second):
            res[f"{key}/grad/{name_of(path)}"] = g
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
