"""Helpers of tests/test_torch_fsdp.py and tests/test_torch_zero1.py,
importable by the processes they start.

``make_inputs`` draws the weights (the port's init, seed 0), a training
batch and the served prompts once, into an npz that both sides read.
``worker`` is one rank of a gloo process group on the CPU, for one file's
``kind``: "fsdp" runs one process's reference (no mesh) and a (1, 1) mesh at
world 1, and every mesh of world 2 and 4 in "fsdp" mode (ZeRO-3); "zero1"
runs every mesh of world 2 and 4 in "tp" mode with and without ZeRO-1
moments.  Each writes ``<kind>_w<world>rank<r>.npz``.  ``jax_reference``
runs the JAX package on 4 forced host devices: the index of every leaf's
shard on every device of each mesh (``param_shardings(..., "fsdp")``, or
for "zero1" ``param_shardings(..., "tp")`` and ``opt_shardings(...,
zero1=True)``'s moments), and for "fsdp" ``value_and_grad`` of
``train_loss`` without shardings and JAX's own fsdp step: GSPMD under
``set_sharding_mode("fsdp")``, ``in_shardings`` from ``param_shardings``
and ``batch_shardings`` in "fsdp" mode on ``AxisType.Auto`` meshes.
"""
from __future__ import annotations

import os

import numpy as np

import _torch_tp as tt

AXES = ("data", "model")
MESHES = {2: [(1, 2), (2, 1)], 4: [(1, 4), (2, 2)]}
ALL_MESHES = [s for w in (2, 4) for s in MESHES[w]]
# arch -> (the smoke config it varies, fields replaced, sequence length)
VARIANTS = {
    # capacity factor E / k: no slice of the all-to-all drops a token, so
    # one process's dense dispatch is its reference
    "llama4-scout-no-drop": ("llama4-scout-17b-a16e",
                             dict(capacity_factor=4.0), 16),
    # "model" divides no 15-token sequence: the all-reduce path with the
    # rows gathered over "model"
    "llama4-scout-odd-seq": ("llama4-scout-17b-a16e",
                             dict(capacity_factor=4.0), 15),
    # 2 experts: on (1, 4) "model" does not divide them, and each rank runs
    # the dense dispatch over every expert on its own rows
    "llama4-scout-2-experts": ("llama4-scout-17b-a16e",
                               dict(n_experts=2, capacity_factor=2.0), 16),
    # A_log, D and dt_bias (8, 8): the fsdp rule splits the layers
    "mamba2-780m-8-layers": ("mamba2-780m", dict(n_layers=8), 16),
    # A_log, D and dt_bias (3, 2): no dim divides 4 ranks, so on 4 ranks
    # they stay whole and their gradients are all-reduced
    "mamba2-780m-3x2-heads": ("mamba2-780m",
                              dict(n_layers=3, ssm_head_dim=64), 16),
}
ARCHS = {"fsdp": ("deepseek-7b", "llama4-scout-no-drop",
                  "llama4-scout-odd-seq", "llama4-scout-2-experts",
                  "mamba2-780m",
                  "mamba2-780m-8-layers", "mamba2-780m-3x2-heads",
                  "whisper-medium"),
         "zero1": ("deepseek-7b", "llama4-scout-17b-a16e", "mamba2-780m",
                   "mamba2-780m-8-layers", "whisper-medium")}
ALL_ARCHS = tuple(dict.fromkeys(a for v in ARCHS.values() for a in v))
# llama4's aux is the whole batch's in the port, one shard's in JAX's
# expert-parallel step (ROADMAP.md section 3): held to one process only
GSPMD = tuple(a for a in ARCHS["fsdp"] if not a.startswith("llama4"))
ROWS = 4
TRAIN_STEPS = 3
OPT = tt.OPT
# served in "fsdp" mode on these meshes, as _torch_tp serves them
SERVED = ("deepseek-7b", "llama4-scout-no-drop", "mamba2-780m",
          "whisper-medium")
SERVE_MESHES = ((1, 2), (2, 2))


def tag(shape) -> str:
    return "x".join(map(str, shape))


def small_rows(shape) -> int:
    """A batch smaller than a mesh of ``shape``: half its ranks' rows."""
    return max(1, int(np.prod(shape)) // 2)


def cfg_of(arch: str, get_smoke):
    base, over, _ = VARIANTS.get(arch, (arch, {}, 16))
    return get_smoke(base).replace(**over)


def seq_of(arch: str) -> int:
    return VARIANTS.get(arch, (arch, {}, 16))[2]


def train_cfg(arch: str):
    from repro_torch.configs import get_smoke
    return cfg_of(arch, get_smoke).replace(remat="full")


def make_inputs(path) -> None:
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.models import Model
    from repro_torch.models.lm import PATCH_DIM
    out = {}
    for i, arch in enumerate(ALL_ARCHS):
        cfg = cfg_of(arch, get_smoke)
        model = Model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        for name, p in model.named_parameters():
            out[f"{arch}/state/{name}"] = p.detach().numpy()
        rng = np.random.default_rng(50 + i)
        out[f"{arch}/tokens"] = rng.integers(0, cfg.vocab,
                                             size=(ROWS, seq_of(arch) + 1))
        if cfg.family == "encdec":
            out[f"{arch}/frames"] = rng.standard_normal(
                (ROWS, cfg.enc_len, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            out[f"{arch}/patches"] = rng.standard_normal(
                (ROWS, cfg.n_patches, PATCH_DIM)).astype(np.float32)
        for j, n in enumerate(tt.PROMPTS):
            out[f"{arch}/prompt{j}"] = rng.integers(0, cfg.vocab, size=n)
    np.savez(path, **out)


def train_run(model, data, arch: str, zero1: bool = False) -> dict:
    """TRAIN_STEPS ``make_train_step`` steps on the whole batch (of which
    the step keeps the rank's part in the model's mode on a mesh): the
    losses and grad norms, the
    step-1 gradients as AdamW receives them, both moments after step 1 and
    at the end, and the parameters at the end."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamW, AdamWConfig
    b = tt.batch(data, arch)
    opt = AdamW(AdamWConfig(**OPT))
    out: dict = {}
    update = opt.update

    def keep(g, st, *args, **kw):
        first = "grad" not in out
        if first:
            out["grad"] = {n: t.detach().clone() for n, t in g.items()}
        met = update(g, st, *args, **kw)
        if first:
            for k in ("m", "v"):
                out[f"{k}1"] = {n: t.clone() for n, t in st[k].items()}
        return met

    opt.update = keep
    params = dict(model.named_parameters())
    st = {"params": params, "opt": opt.init(params, model, zero1=zero1)}
    step = make_train_step(model, opt)
    hist: dict = {"loss": [], "grad_norm": []}
    for _ in range(TRAIN_STEPS):
        st, met = step(st, b)
        for k in hist:
            hist[k].append(float(met[k]))
    res = {k: np.array(v) for k, v in hist.items()}
    for key, tree in (("grad", out["grad"]), ("m1", out["m1"]),
                      ("v1", out["v1"]), ("m", st["opt"]["m"]),
                      ("v", st["opt"]["v"]), ("param", params)):
        for n, t in tree.items():
            res[f"{key}/{n}"] = t.detach().numpy().copy()
    return res


def _order(mesh, res: dict, key: str) -> None:
    """``gather_leaf`` over both axes of a (data, model) mesh, of the
    rank's part of an (8, 3) leaf whose rows all differ; backward, a
    cotangent of (rank + 1) * the leaf: the gathered leaf, and the rank's
    part of the summed gradient."""
    import torch

    from repro_torch.launch.collectives import gather_leaf
    from repro_torch.launch.mesh import coordinate
    from repro_torch.launch.shardings import local_slice
    full = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    part = local_slice(full, (AXES, None), mesh, coordinate(mesh))
    part = part.clone().requires_grad_(True)
    whole = gather_leaf(part, mesh, 0, AXES)
    rank = torch.distributed.get_rank()
    whole.backward(full * (rank + 1))
    res[f"{key}/order/whole"] = whole.detach().numpy()
    res[f"{key}/order/grad"] = part.grad.numpy()


def _small_batch(mesh, data, res: dict, key: str) -> None:
    """A batch of ``small_rows`` in "fsdp" mode: the axes that
    ``split_batch`` puts its rows and its sequence over, and where the
    rules replicate it ((2, 1)), whether it stays whole."""
    import torch

    from repro_torch.launch.shardings import split_batch
    b = tt.batch(data, "deepseek-7b")
    rows = small_rows(tuple(mesh.shape))
    small = {k: v[:rows] for k, v in b.items()}
    part, row_ax, seq, _ = split_batch(small, mesh, "fsdp")
    res[f"{key}/small_rows"] = np.array(row_ax)
    res[f"{key}/small_seq"] = np.array(seq)
    res[f"{key}/small_whole"] = np.array(
        all(torch.equal(part[k], small[k]) for k in small))


def _fsdp_cases(world: int, data, res: dict) -> None:
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.models.common import set_sharding_mode
    if world == 1:
        one = make_mesh((1, 1), AXES, device="cpu")
        for arch in ARCHS["fsdp"]:
            model = Model(train_cfg(arch), device="cpu").load_state(
                tt.state(data, arch))
            for k, v in train_run(model, data, arch).items():
                res[f"one/{arch}/train/{k}"] = v
            set_sharding_mode("fsdp")
            try:
                model = Model(train_cfg(arch), device="cpu",
                              mesh=one).load_state(tt.state(data, arch))
            finally:
                set_sharding_mode("tp")
            for k, v in train_run(model, data, arch).items():
                res[f"1x1/{arch}/train/{k}"] = v
            if arch in SERVED:
                res[f"one/{arch}/serve"] = tt.serve_run(
                    Model(train_cfg(arch), device="cpu").load_state(
                        tt.state(data, arch)), data, arch)
        return
    for shape in MESHES[world]:
        mesh = make_mesh(shape, AXES, device="cpu")
        t = tag(shape)
        _order(mesh, res, t)
        _small_batch(mesh, data, res, t)
        for arch in ARCHS["fsdp"]:
            set_sharding_mode("fsdp")
            try:
                model = Model(train_cfg(arch), device="cpu",
                              mesh=mesh).load_state(tt.state(data, arch))
                served = Model(train_cfg(arch), device="cpu", mesh=mesh) \
                    if arch in SERVED and shape in SERVE_MESHES else None
            finally:
                set_sharding_mode("tp")
            for name, p in model.named_parameters():
                res[f"{t}/{arch}/slice/{name}"] = p.detach().numpy().copy()
            res[f"{t}/{arch}/sharded"] = np.array(sorted(model.sharded))
            for k, v in train_run(model, data, arch).items():
                res[f"{t}/{arch}/train/{k}"] = v
            if served is not None:
                res[f"{t}/{arch}/serve"] = tt.serve_run(
                    served.load_state(tt.state(data, arch)), data, arch)


def _zero1_cases(world: int, data, res: dict) -> None:
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    for shape in MESHES.get(world, ()):
        mesh = make_mesh(shape, AXES, device="cpu")
        t = tag(shape)
        for arch in ARCHS["zero1"]:
            for key, zero1 in (("plain", False), ("zero1", True)):
                model = Model(train_cfg(arch), device="cpu",
                              mesh=mesh).load_state(tt.state(data, arch))
                for k, v in train_run(model, data, arch, zero1).items():
                    res[f"{t}/{arch}/{key}/{k}"] = v


def worker(rank: int, world: int, store: str, inputs: str, out_dir: str,
           kind: str) -> None:
    """One rank of a gloo group of ``world``: every ``kind`` case of that
    world size, written to ``out_dir/<kind>_w<world>rank<rank>.npz``."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    data = np.load(inputs)
    res: dict = {}
    try:
        (_fsdp_cases if kind == "fsdp" else _zero1_cases)(world, data, res)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"{kind}_w{world}rank{rank}.npz"), **res)


def _index(sharding, shape, mesh, res: dict, key: str) -> None:
    """Each device's index of a leaf of ``shape`` under ``sharding``, as
    [[start, stop] per dim], keyed by its mesh position's flat rank."""
    idx = sharding.devices_indices_map(shape)
    for pos in np.ndindex(*mesh.devices.shape):
        flat = int(np.ravel_multi_index(pos, mesh.devices.shape))
        res[f"{key}/{flat}"] = np.array(
            [[s.start or 0, n if s.stop is None else s.stop]
             for s, n in zip(idx[mesh.devices[pos]], shape)], np.int64)


def jax_reference(inputs: str, out: str, kind: str) -> None:
    """The JAX package on the same inputs (see the module's docstring)."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    from jax.sharding import AxisType

    from repro.configs import get_smoke
    from repro.launch.shardings import (batch_shardings, opt_shardings,
                                        param_shardings)
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
    for arch in ARCHS[kind]:
        tree = tt._tree(data, arch)
        cfg = cfg_of(arch, get_smoke).replace(kernel_mode="ref",
                                              remat="full")
        shapes = sds(tree)
        for shape, mesh in meshes.items():
            t = f"{tag(shape)}/{arch}"
            if kind == "fsdp":
                specs = {"idx": param_shardings(shapes, mesh, "fsdp")}
            else:
                specs = {"idx": param_shardings(shapes, mesh, "tp"),
                         "zidx": opt_shardings(
                             {"m": shapes, "v": shapes,
                              "count": jax.ShapeDtypeStruct((), np.int32)},
                             shapes, mesh, zero1=True)["m"]}
            for key, tree_specs in specs.items():
                for path, sh in jax.tree_util.tree_leaves_with_path(
                        tree_specs):
                    name = name_of(path)
                    _index(sh, data[f"{arch}/state/{name}"].shape, mesh,
                           res, f"{t}/{key}/{name}")
        if kind != "fsdp":
            continue
        toks = data[f"{arch}/tokens"]
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        for key in ("frames", "patches"):
            if f"{arch}/{key}" in data.files:
                b[key] = data[f"{arch}/{key}"]
        jm = Model(cfg)
        vg = jax.value_and_grad(lambda p, bb, jm=jm: jm.train_loss(p, bb)[0])
        jobs.append((f"{arch}/jax", jax.jit(vg).lower(tree, b), (tree, b)))
        if arch not in GSPMD:
            continue
        for shape, mesh in meshes.items():
            shard = jax.jit(vg, in_shardings=(
                param_shardings(shapes, mesh, "fsdp"),
                batch_shardings(sds(b), mesh, "fsdp")))
            with jax.set_mesh(mesh):
                jobs.append((f"{tag(shape)}/{arch}/gspmd",
                             shard.lower(tree, b), (tree, b)))
    # XLA compiles outside the interpreter lock: compile side by side
    with ThreadPoolExecutor(4) as pool:
        compiled = list(pool.map(lambda j: j[1].compile(), jobs))
    for (key, _, args), fn in zip(jobs, compiled):
        loss, grads = fn(*args)
        res[f"{key}/loss"] = loss
        for path, g in jax.tree_util.tree_leaves_with_path(grads):
            res[f"{key}/grad/{name_of(path)}"] = g
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
