"""Helpers of tests/test_torch_expert_parallel.py, importable by the processes
it starts.

``make_inputs`` draws the weights (the port's init, seed 0), the MoE blocks'
inputs and the batches once, into an npz that both sides read.  ``worker``
is one rank of a gloo process group on the CPU: it runs every case of its
world size (1, 2 or 4 ranks) through the port and writes what it got to
``rank<r>.npz``.  ``jax_reference`` runs the JAX package's expert-parallel
paths, its dense dispatch and ``jax.grad`` of its ``train_loss`` on 4
forced host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``
set by the caller), into ``jax.npz``.
"""
from __future__ import annotations

import os

import numpy as np

MOE = ("llama4-scout-17b-a16e", "arctic-480b")
AXES = ("data", "model")
MESHES = {1: [(1, 1)], 2: [(1, 2)], 4: [(1, 4), (2, 2), (4, 1)]}
MODES = ("tp", "fsdp")
EXPERTS = ("w_in", "w_gate", "w_out")
# the MoE block's input (B, S): on (4, 1) the 2 rows do not divide the data
# axis, so every rank takes the whole batch, as the reference does; 64
# tokens, so that a slice of 16 can overflow arctic's top-2 capacity of 12
BLOCK = (2, 64)
# no (token, choice) pair is dropped at this capacity factor: the
# all-to-all's per-slice capacity then drops what the dense dispatch drops
NO_DROP_CF = 8.0
# the data x expert parallel training step: mesh, batch (B, S), steps; the
# all-to-all mode at NO_DROP_CF, so that its loss is the dense dispatch's
TRAIN_MESH = (2, 2)
TRAIN_BATCH = (4, 16)
TRAIN_STEPS = 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
# served on (1, nm): prompts of these lengths, 6 new tokens each
PROMPTS = (5, 9, 12)
SERVE = dict(slots=2, max_len=32)
MAX_NEW = 6
# specs that put both axes on one dim of an (8, 8) array, in either order,
# and one on each dim; a DTensor takes no dim over axes against the mesh's
# order (MODEL_MAJOR)
TWO_AXIS_SPECS = ((("data", "model"), None), (("model", "data"), None),
                  ("data", "model"))
MODEL_MAJOR = 1


def tag(shape) -> str:
    return "x".join(map(str, shape))


def train_cf(cfg, mode: str) -> float:
    return cfg.capacity_factor if mode == "tp" else NO_DROP_CF


def make_inputs(path) -> None:
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.models import Model
    out = {}
    for i, arch in enumerate(MOE):
        cfg = get_smoke(arch)
        model = Model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        for name, p in model.named_parameters():
            out[f"{arch}/state/{name}"] = p.detach().numpy()
        rng = np.random.default_rng(10 + i)
        x = rng.standard_normal((*BLOCK, cfg.d_model)).astype(np.float32)
        # a shared direction skews the routing, so that experts overflow
        x += 1.5 * rng.standard_normal(cfg.d_model).astype(np.float32)
        out[f"{arch}/x"] = x
        out[f"{arch}/tokens"] = rng.integers(
            0, cfg.vocab, size=(TRAIN_BATCH[0], TRAIN_BATCH[1] + 1))
        for j, n in enumerate(PROMPTS):
            out[f"{arch}/prompt{j}"] = rng.integers(0, cfg.vocab, size=n)
    np.savez(path, **out)


def _state(data, arch: str) -> dict:
    """Fresh tensors of the arch's weights (a training step updates the
    ones a model holds in place)."""
    import torch
    pre = f"{arch}/state/"
    return {k[len(pre):]: torch.tensor(data[k]) for k in data.files
            if k.startswith(pre)}


def train_run(model, data, arch: str) -> dict:
    """TRAIN_STEPS steps of ``make_train_step`` on the one batch (the rank's
    rows of it on a mesh): the losses, grad norms and step 1's gradients
    as AdamW receives them."""
    import torch

    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamW, AdamWConfig
    toks = torch.tensor(data[f"{arch}/tokens"])
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    opt = AdamW(AdamWConfig(**OPT))
    grads = []
    update = opt.update

    def keep(g, *args, **kw):
        grads.append({n: t.detach().clone() for n, t in g.items()})
        return update(g, *args, **kw)

    opt.update = keep
    params = dict(model.named_parameters())
    state = {"params": params, "opt": opt.init(params)}
    step = make_train_step(model, opt)
    out = {"loss": [], "grad_norm": [], "aux": []}
    for _ in range(TRAIN_STEPS):
        state, met = step(state, batch)
        for k in out:
            out[k].append(float(met[k]))
    out = {k: np.array(v) for k, v in out.items()}
    out.update({f"grad/{n}": g.numpy() for n, g in grads[0].items()})
    return out


def serve_run(model, data, arch: str) -> np.ndarray:
    """The greedy tokens of the PROMPTS through ``ServingEngine``, in
    request order."""
    from repro_torch.runtime import ServingEngine
    eng = ServingEngine(model, device="cpu", **SERVE)
    for j in range(len(PROMPTS)):
        eng.submit(data[f"{arch}/prompt{j}"], max_new=MAX_NEW)
    done = sorted(eng.run_until_drained(), key=lambda c: c.id)
    return np.array([c.tokens for c in done])


def _block(moe: dict, x, cfg, mesh, mode: str) -> dict:
    """The MoE block under ``mesh`` in ``mode``: y, aux and the gradients
    of sum(y^2) in x and every weight."""
    import torch

    from repro_torch.models.common import set_sharding_mode, use_mesh
    from repro_torch.models.mlp import moe_forward
    leaves = {k: v.clone().requires_grad_(True) for k, v in moe.items()}
    x = x.clone().requires_grad_(True)
    set_sharding_mode(mode)
    try:
        with use_mesh(mesh):
            y, aux = moe_forward(leaves, x, cfg)
            torch.sum(y * y).backward()
    finally:
        set_sharding_mode("tp")
    out = {"y": y.detach().numpy(), "aux": aux.detach().numpy(),
           "grad/x": x.grad.numpy()}
    out.update({f"grad/{k}": v.grad.numpy() for k, v in leaves.items()})
    return out


def _world_one(data, arch: str, mesh, res: dict) -> None:
    """The (1, 1) mesh against no mesh, in both modes: the block's outputs
    and gradients, and the training step's losses and step-1 gradients
    (in "fsdp" mode the whole ZeRO-3 layout: every leaf gathered at its
    use, its gradient reduce-scattered), for comparison bit for bit."""
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.models import Model
    from repro_torch.models.common import set_sharding_mode
    cfg = get_smoke(arch)
    state = _state(data, arch)
    moe = {k: v[0] for k, v in state.items() if k.startswith("layers.moe.")}
    moe = {k.rsplit(".", 1)[-1]: v for k, v in moe.items()}
    x = torch.tensor(data[f"{arch}/x"])
    for name, m in (("dense", None), ("tp", mesh), ("fsdp", mesh)):
        mode = "tp" if m is None else name
        for k, v in _block(moe, x, cfg, m, mode).items():
            res[f"1x1/{arch}/{name}/block/{k}"] = v
        set_sharding_mode(mode)
        try:
            run = train_run(Model(cfg.replace(remat="full"), device="cpu",
                                  mesh=m).load_state(_state(data, arch)),
                            data, arch)
        finally:
            set_sharding_mode("tp")
        for k, v in run.items():
            res[f"1x1/{arch}/{name}/train/{k}"] = v


def worker(rank: int, world: int, store: str, inputs: str,
           out_dir: str) -> None:
    """One rank of a gloo group of ``world``: every case of that world size,
    written to ``out_dir/rank<rank>.npz``."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import coordinate, make_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.shardings import (placements, shard_batch,
                                              shard_params)
    from repro_torch.models import Model
    from repro_torch.models.common import set_sharding_mode
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    data = np.load(inputs)
    res: dict = {}
    try:
        if world == 1:
            mesh = make_mesh((1, 1), AXES, device="cpu")
            for arch in MOE:
                _world_one(data, arch, mesh, res)
        for shape in MESHES[world] if world > 1 else ():
            mesh = make_mesh(shape, AXES, device="cpu")
            t = tag(shape)
            res[f"{t}/order"] = mesh.mesh.numpy()
            res[f"{t}/coord"] = np.array(
                [coordinate(mesh)[a] for a in AXES])
            full = torch.arange(8 * 8).reshape(8, 8)
            for i, spec in enumerate(TWO_AXIS_SPECS):
                if i != MODEL_MAJOR:
                    res[f"{t}/dtensor{i}"] = distribute_tensor(
                        full, mesh, placements(spec, mesh)).to_local().numpy()
            for arch in MOE:
                cfg = get_smoke(arch)
                state = _state(data, arch)
                local = shard_params(state, mesh)
                for k in EXPERTS:
                    res[f"{t}/{arch}/shard/{k}"] = \
                        local[f"layers.moe.{k}"].numpy()
                moe = {k.rsplit(".", 1)[-1]: v[0] for k, v in local.items()
                       if k.startswith("layers.moe.")}
                x = shard_batch({"x": torch.tensor(data[f"{arch}/x"])},
                                mesh)["x"]
                for mode in MODES:
                    for cf in (cfg.capacity_factor, NO_DROP_CF):
                        key = f"{t}/{arch}/{mode}/cf{cf:g}"
                        for k, v in _block(moe, x, cfg.replace(
                                capacity_factor=cf), mesh, mode).items():
                            res[f"{key}/{k}"] = v
                if shape == TRAIN_MESH:
                    for mode in MODES:
                        tcfg = cfg.replace(remat="full",
                                           capacity_factor=train_cf(cfg,
                                                                    mode))
                        set_sharding_mode(mode)
                        try:
                            run = train_run(Model(tcfg, device="cpu",
                                                  mesh=mesh).load_state(
                                _state(data, arch)), data, arch)
                        finally:
                            set_sharding_mode("tp")
                        for k, v in run.items():
                            res[f"{t}/{arch}/train/{mode}/{k}"] = v
                if shape[0] == 1:
                    model = Model(cfg, device="cpu", mesh=mesh).load_state(
                        state)
                    res[f"{t}/{arch}/serve"] = serve_run(model, data, arch)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"w{world}rank{rank}.npz"), **res)


def jax_reference(inputs: str, out: str) -> None:
    """The JAX package on the same inputs: for each MoE arch its dense
    dispatch (y, aux); on each mesh of MESHES with more than one rank, both
    expert-parallel paths (y, aux and the gradients of sum(y^2)), the
    device order of ``jax.make_mesh`` and the slice of each expert leaf
    that ``param_shardings`` gives each device; and ``jax.grad`` of
    ``train_loss`` (dense dispatch, ``kernel_mode="ref"``, the whole batch)
    at the training step's two capacity factors."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke
    from repro.launch.shardings import param_shardings
    from repro.models import Model
    from repro.models.mlp import (_moe_dense_dispatch, _moe_expert_parallel,
                                  _moe_expert_parallel_a2a)
    paths = {"tp": _moe_expert_parallel, "fsdp": _moe_expert_parallel_a2a}
    data = np.load(inputs)
    res: dict = {}
    jobs: list = []         # (key, lowered function, its arguments)

    def job(key, fn, *args, mesh=None):
        if mesh is None:
            jobs.append((key, jax.jit(fn).lower(*args), args))
            return
        with jax.set_mesh(mesh):
            jobs.append((key, jax.jit(fn).lower(*args), args))

    meshes = {s: jax.make_mesh(s, AXES, devices=jax.devices()[:int(
        np.prod(s))]) for w in (2, 4) for s in MESHES[w]}
    for shape, mesh in meshes.items():
        res[f"{tag(shape)}/order"] = np.array(
            [[d.id for d in row] for row in mesh.devices])
        for i, spec in enumerate(TWO_AXIS_SPECS):
            full = np.arange(8 * 8).reshape(8, 8)
            idx = jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec(*spec)).devices_indices_map(
                full.shape)
            for dev, sl in idx.items():
                res[f"{tag(shape)}/two_axis{i}/{dev.id}"] = full[sl]
    for arch in MOE:
        pre = f"{arch}/state/"
        tree: dict = {}       # numpy leaves: slicing them compiles nothing
        for k in data.files:
            if k.startswith(pre):
                *path, last = k[len(pre):].split(".")
                node = tree
                for p in path:
                    node = node.setdefault(p, {})
                node[last] = data[k]
        cfg = get_smoke(arch).replace(kernel_mode="ref")
        moe = {k: v[0] for k, v in tree["layers"]["moe"].items()}
        x = data[f"{arch}/x"]
        job(f"{arch}/dense", lambda p, xx: _moe_dense_dispatch(p, xx, cfg),
            moe, x)
        shapes = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape,
                                                             a.dtype), tree)
        for shape, mesh in meshes.items():
            specs = param_shardings(shapes, mesh)["layers"]["moe"]
            for k in EXPERTS:
                full = tree["layers"]["moe"][k]
                idx = specs[k].devices_indices_map(full.shape)
                for dev, sl in idx.items():
                    res[f"{tag(shape)}/{arch}/shard/{k}/{dev.id}"] = full[sl]
            for mode, fn in paths.items():
                def loss(p, xx, fn=fn, mesh=mesh):
                    yy, a = fn(p, xx, cfg, mesh)
                    return jnp.sum(yy * yy), (yy, a)
                job(f"{tag(shape)}/{arch}/{mode}", jax.value_and_grad(
                    loss, argnums=(0, 1), has_aux=True), moe, x, mesh=mesh)
        toks = data[f"{arch}/tokens"]
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        for cf in sorted({cfg.capacity_factor, NO_DROP_CF}):
            jm = Model(cfg.replace(capacity_factor=cf))
            job(f"{arch}/train/cf{cf:g}", jax.grad(
                lambda p, b, jm=jm: jm.train_loss(p, b)[0]), tree, batch)
    # XLA compiles outside the interpreter lock: compile side by side
    with ThreadPoolExecutor(4) as pool:
        compiled = list(pool.map(lambda j: j[1].compile(), jobs))
    for (key, _, args), fn in zip(jobs, compiled):
        got = fn(*args)
        if key.endswith("/dense"):
            res[f"{key}/y"], res[f"{key}/aux"] = got
        elif "/train/" in key:
            for path, g in jax.tree_util.tree_leaves_with_path(got):
                name = ".".join(str(p.key) for p in path)
                res[f"{key}/grad/{name}"] = g
        else:
            (_, (y, aux)), (gp, gx) = got
            res[f"{key}/y"], res[f"{key}/aux"] = y, aux
            res[f"{key}/grad/x"] = gx
            for k, g in gp.items():
                res[f"{key}/grad/{k}"] = g
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
