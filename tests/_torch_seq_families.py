"""Helpers of tests/test_torch_seq_split_families.py, importable by the
processes they start.

The sequence split of an "fsdp" batch smaller than the mesh for the
families that carry a second layout besides the dense one: the MoE (the
all-to-all path on the reference's blocks, and the dense dispatch where
"model" does not divide the experts), whisper (its frames split as the
tokens are, or whole on every rank) and llava (its patches and tokens
joined and cut into contiguous slices, the tail padded where its
patches lie whole), and deepseek-7b on the three-axis mesh.  Each CASE is
a smoke config with fields replaced, the length of its frames or patches,
and the meshes it runs on; ``rows_of(shape)`` rows of SEQ tokens a batch.

``make_inputs`` draws each case's weights (the port's init, seed 0), its
tokens and its frames or patches once, into an npz that both sides read.
``worker`` is one rank of a gloo group on the CPU: at world 1 one process
without a mesh on every case's rows (the references), at world 2 and 4
every case of each mesh of that world in "fsdp" mode through
``make_train_step`` (one step; the MoE's also with CE alone as the loss,
the reference's aux being one shard's) and ``make_prefill_step``; it writes
``fam_w<world>rank<r>.npz``.  ``jax_reference`` runs the JAX package's
GSPMD fsdp step and prefill step on 4 forced host devices, under ``with
mesh:`` so that its MoE takes its own expert-parallel paths.
"""
from __future__ import annotations

import os

import numpy as np

import _torch_seq as ts
import _torch_tp as tt

SEQ = ts.SEQ
OPT = ts.OPT
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
MESHES = {2: [(1, 2)], 4: [(1, 4), (2, 2), (1, 2, 2)]}
LLAMA4 = "llama4-scout-17b-a16e"
ARCTIC = "arctic-480b"
TWO = [(1, 2), (1, 4), (2, 2)]
# name -> (smoke arch, fields replaced, frames or patches a row, meshes).
# The MoE where the slices' capacity drops pairs (held to JAX): llama4-scout
# at its own capacity factor, arctic at 1.0 (at its own 1.25 a slice of 8
# tokens has capacity 8 and drops nothing); and at E / k, where nothing
# drops (held to one process too).  A case and its "-no-drop" twin share
# weights and tokens.  On (1, 2, 2) one row puts the sequence over
# ("data", "model"), so that the reference's block is every row of a model
# slice, which other ranks' parts make up.  Six experts on (1, 4): "model"
# does not divide them, and the dense dispatch's capacity and slots are the
# whole rows'.  whisper's 32 frames split as its tokens; 31 divide no
# sequence split and lie whole beside them (on (2, 2) with the rows split
# over "data").  llava's 8 patches + 16 tokens on 4
# ranks: rank 0 holds patches only.  6 and 7 patches divide no split and lie
# whole, rows and all: 6 + 16 = 22 positions in slices of 6 on (1, 4) (the
# last rank 4 real and 2 pads), 7 + 16 = 23 in slices of 12 over "model"'s
# 2 ranks on (2, 2), the rows over "data" (the last 11 real and a pad).
CASES = {
    "llama4": (LLAMA4, {}, 0, [*TWO, (1, 2, 2)]),
    "llama4-no-drop": (LLAMA4, dict(capacity_factor=4.0), 0,
                       [*TWO, (1, 2, 2)]),
    "arctic": (ARCTIC, dict(capacity_factor=1.0), 0, [*TWO, (1, 2, 2)]),
    "arctic-no-drop": (ARCTIC, dict(capacity_factor=2.0), 0,
                       [*TWO, (1, 2, 2)]),
    "llama4-6-experts": (LLAMA4, dict(n_experts=6), 0, [(1, 4)]),
    "whisper": ("whisper-medium", {}, 32, TWO),
    "whisper-31-frames": ("whisper-medium", {}, 31, TWO),
    "llava": ("llava-next-mistral-7b", {}, 8, TWO),
    "llava-6-patches": ("llava-next-mistral-7b", dict(n_patches=6), 6,
                        [(1, 4)]),
    "deepseek": ("deepseek-7b", {}, 0, [(1, 2, 2)]),
    "llava-7-patches": ("llava-next-mistral-7b", dict(n_patches=7), 7,
                        [(2, 2)]),
}
# the cases whose pairs the slices' capacity may drop: held to JAX alone
DROPS = ("llama4", "arctic")
MOE = tuple(n for n, c in CASES.items() if c[0] in (LLAMA4, ARCTIC))
# the inputs' seeds: one a smoke arch and length of frames or patches
BASES = list(dict.fromkeys(c[:3:2] for c in CASES.values()))
ALL_MESHES = [s for w in (2, 4) for s in MESHES[w]]


def tag(shape) -> str:
    return "x".join(map(str, shape))


def axes_of(shape) -> tuple:
    return AXES[len(shape)]


def rows_of(shape) -> int:
    """Rows of a batch smaller than the mesh: half its ranks', one on three
    axes (two would lie over ("pod", "data"), the sequence over "model")."""
    return 1 if len(shape) == 3 else max(1, int(np.prod(shape)) // 2)


def cases_on(shape) -> list:
    return [n for n, c in CASES.items() if tuple(shape) in c[3]]


def rows_needed(name: str) -> list:
    return sorted({rows_of(s) for s in CASES[name][3]})


def cfg_of(name: str, get_smoke):
    """The case's config from either package's ``get_smoke``."""
    base, over, _, _ = CASES[name]
    return get_smoke(base).replace(**over)


def train_cfg(name: str):
    from repro_torch.configs import get_smoke
    return cfg_of(name, get_smoke).replace(remat="full")


def make_inputs(path) -> None:
    import torch

    from repro_torch.models import Model
    from repro_torch.models.lm import PATCH_DIM
    out = {}
    for name in CASES:
        cfg = train_cfg(name)
        model = Model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        for leaf, p in model.named_parameters():
            out[f"{name}/state/{leaf}"] = p.detach().numpy()
        rng = np.random.default_rng(90 + BASES.index(CASES[name][:3:2]))
        rows = max(rows_needed(name))
        out[f"{name}/tokens"] = rng.integers(0, cfg.vocab,
                                             size=(rows, SEQ + 1))
        side = CASES[name][2]
        if cfg.family == "encdec":
            out[f"{name}/frames"] = rng.standard_normal(
                (rows, side, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            out[f"{name}/patches"] = rng.standard_normal(
                (rows, side, PATCH_DIM)).astype(np.float32)
    np.savez(path, **out)


def batch(data, name: str, rows: int, labels: bool = True) -> dict:
    """The first ``rows`` rows of the case's whole batch."""
    import torch
    toks = torch.tensor(data[f"{name}/tokens"][:rows])
    out = {"tokens": toks[:, :-1].contiguous()}
    if labels:
        out["labels"] = toks[:, 1:].contiguous()
    for key in ("frames", "patches"):
        if f"{name}/{key}" in data.files:
            out[key] = torch.tensor(data[f"{name}/{key}"][:rows])
    return out


def model_of(data, name: str, mesh=None):
    from repro_torch.models import Model
    from repro_torch.models.common import set_sharding_mode
    if mesh is None:
        return Model(train_cfg(name), device="cpu").load_state(
            tt.state(data, name))
    set_sharding_mode("fsdp")
    try:
        return Model(train_cfg(name), device="cpu", mesh=mesh).load_state(
            tt.state(data, name))
    finally:
        set_sharding_mode("tp")


def step_run(model, b: dict, ce_only: bool = False) -> dict:
    """One ``make_train_step`` step on the whole batch ``b``: the loss and
    the metrics, and the gradients as AdamW receives them (the rank's parts
    on a mesh).  ``ce_only``: the step differentiates CE alone (the model's
    ``train_loss`` returns its "ce" as the loss), as the JAX reference's
    CE is held."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamW, AdamWConfig
    opt = AdamW(AdamWConfig(**OPT))
    grads: dict = {}
    update = opt.update

    def keep(g, *args, **kw):
        grads.update({n: t.detach().clone() for n, t in g.items()})
        return update(g, *args, **kw)

    opt.update = keep
    if ce_only:
        whole = model.train_loss

        def ce(bb):
            _, met = whole(bb)
            return met["ce"], met

        model.train_loss = ce
    params = dict(model.named_parameters())
    st = {"params": params, "opt": opt.init(params, model)}
    _, met = make_train_step(model, opt)(st, b)
    out = {k: np.array(float(met[k])) for k in ("loss", "ce", "aux")
           if k in met}
    out.update({f"grad/{n}": t.numpy() for n, t in grads.items()})
    return out


def prefill_run(model, b: dict) -> dict:
    """``make_prefill_step`` on the whole prompts: the greedy tokens and
    every cache leaf (the rank's rows on a mesh)."""
    import torch

    from repro_torch.launch.steps import make_prefill_step
    with torch.no_grad():
        toks, cache = make_prefill_step(model)(b)
    out = {"prefill/tokens": toks.numpy()}
    out.update({f"prefill/cache/{k}": v.numpy() for k, v in cache.items()})
    return out


def _runs(model_fn, b_train: dict, b_pre: dict, name: str) -> dict:
    """The full step (but where the slices drop pairs), the CE step (the
    MoE) and the prefill, each on a fresh model."""
    out = {}
    if name not in DROPS:
        out.update({f"full/{k}": v for k, v in
                    step_run(model_fn(), b_train).items()})
    if name in MOE:
        out.update({f"ce/{k}": v for k, v in
                    step_run(model_fn(), b_train, ce_only=True).items()})
    out.update(prefill_run(model_fn(), b_pre))
    return out


def worker(rank: int, world: int, store: str, inputs: str,
           out_dir: str) -> None:
    """One rank of a gloo group of ``world``: every case of that world
    size, written to ``out_dir/fam_w<world>rank<rank>.npz``."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import split_batch
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    data = np.load(inputs)
    res: dict = {}
    try:
        if world == 1:
            for name in CASES:
                for rows in rows_needed(name):
                    for k, v in _runs(
                            lambda: model_of(data, name), batch(
                                data, name, rows), batch(
                                data, name, rows, labels=False),
                            name).items():
                        res[f"one{rows}/{name}/{k}"] = v
        for shape in MESHES.get(world, ()):
            mesh = make_mesh(shape, axes_of(shape), device="cpu")
            t, rows = tag(shape), rows_of(shape)
            for name in cases_on(shape):
                b = batch(data, name, rows)
                _, row_ax, seq_ax, whole = split_batch(b, mesh, "fsdp")
                res[f"{t}/{name}/rows"] = np.array(row_ax)
                res[f"{t}/{name}/seq"] = np.array(seq_ax)
                res[f"{t}/{name}/whole"] = np.array(whole, dtype=str)
                for k, v in _runs(lambda: model_of(data, name, mesh), b,
                                  batch(data, name, rows, labels=False),
                                  name).items():
                    res[f"{t}/{name}/{k}"] = v
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"fam_w{world}rank{rank}.npz"), **res)


def jax_reference(inputs: str, out: str) -> None:
    """The JAX package's GSPMD fsdp steps on the same inputs: for each case
    and mesh, ``value_and_grad`` of ``train_loss`` (of its CE for the MoE,
    its aux besides) and ``make_prefill_step`` on the mesh's small batch,
    lowered under ``with mesh:`` (the MoE's ``ambient_mesh`` reads it)."""
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
    meshes = {s: jax.make_mesh(s, axes_of(s),
                               axis_types=(AxisType.Auto,) * len(s),
                               devices=jax.devices()[:int(np.prod(s))])
              for s in ALL_MESHES}

    def name_of(path) -> str:
        return ".".join(str(p.key) for p in path)

    def sds(tree):
        return jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                            tree)

    set_sharding_mode("fsdp")
    for name in CASES:
        tree = tt._tree(data, name)
        jm = Model(cfg_of(name, get_smoke).replace(kernel_mode="ref",
                                                   remat="full"))
        moe = name in MOE

        def loss(p, bb, jm=jm, moe=moe):
            total, met = jm.train_loss(p, bb)
            return (met["ce"] if moe else total), met

        vg = jax.value_and_grad(loss, has_aux=True)
        pre = make_prefill_step(jm)
        for shape in CASES[name][3]:
            mesh = meshes[shape]
            rows = rows_of(shape)
            toks = data[f"{name}/tokens"][:rows]
            b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            for key in ("frames", "patches"):
                if f"{name}/{key}" in data.files:
                    b[key] = data[f"{name}/{key}"][:rows]
            pb = {k: v for k, v in b.items() if k != "labels"}
            psh = param_shardings(sds(tree), mesh, "fsdp")
            t = f"{tag(shape)}/{name}"
            with mesh:
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
        (value, met), grads = first, second
        res[f"{key}/loss"] = value
        for k, v in met.items():
            res[f"{key}/{k}"] = v
        for path, g in jax.tree_util.tree_leaves_with_path(grads):
            res[f"{key}/grad/{name_of(path)}"] = g
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
