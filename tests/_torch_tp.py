"""Helpers of tests/test_torch_tensor_parallel*.py, importable by the
processes they start.

``make_inputs`` draws the weights (the port's init, seed 0), a training
batch, the served prompts and a cross-entropy case once, into an npz that
both sides read.  ``worker`` is one rank of a gloo process group on the CPU:
at world 1 it runs one process's reference (no mesh) and the vocabulary-
parallel cross-entropy on a (1, 1) mesh; at world 2 and 4 every mesh of
that world in "tp" mode; it writes what it got to ``w<world>rank<r>.npz``.
``jax_reference`` runs the JAX package on 4 forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4`` set by the caller,
``kernel_mode="ref"``): each leaf's slice by ``devices_indices_map`` of
``param_shardings(..., "tp")`` at every mesh position, ``value_and_grad`` of
``train_loss`` without shardings, and, for GSPMD, the same under
``in_shardings`` on an ``AxisType.Auto`` (2, 2) mesh (``jax.make_mesh``
makes Explicit axes by default, under which ``train_loss`` fails at the
embedding gather).
"""
from __future__ import annotations

import os

import numpy as np

# the archs of the two test files, each file's cases in one set of spawns;
# a variant is an arch's smoke config with fields replaced (VARIANTS)
ARCHS = {"a": ("deepseek-7b", "phi4-mini-3.8b", "granite-34b",
               "llama4-scout-17b-a16e", "llama4-scout-2-experts"),
         "b": ("mamba2-780m", "zamba2-2.7b", "whisper-medium",
               "llava-next-mistral-7b")}
# llama4-scout with 2 experts: on (1, 4) the rules split the experts'
# hidden dim, not the expert dim, and the dense dispatch runs on the slices
VARIANTS = {"llama4-scout-2-experts": ("llama4-scout-17b-a16e",
                                       dict(n_experts=2))}
AXES = ("data", "model")
MESHES = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}
ALL_MESHES = [s for w in (2, 4) for s in MESHES[w]]
# the training batch (B, S) and steps; remat "full", so that each layer's
# collectives run again in the backward's recompute
BATCH = (4, 16)
TRAIN_STEPS = 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
# served on (1, nm): ServingEngine's prompts, 6 new tokens each; whisper
# (whose prefill takes frames) through launch/serve.generate on the first
# PROMPT_LEN tokens of the training batch with its frames
SERVED = ("deepseek-7b", "phi4-mini-3.8b", "mamba2-780m", "whisper-medium")
SERVE_MESHES = ((1, 2), (1, 4))
PROMPTS = (5, 9, 12)
SERVE = dict(slots=2, max_len=32)
MAX_NEW = 6
PROMPT_LEN = 8
# archs whose GSPMD "tp" step JAX also runs, on this mesh
GSPMD = ("deepseek-7b", "phi4-mini-3.8b")
GSPMD_MESH = (2, 2)
# the vocabulary-parallel cross-entropy's case: logits (B, S, V), f32
CE_SHAPE = (2, 8, 512)
# the archs whose mamba block each rank of "model" runs on its own heads:
# on every mesh, the collectives of one training step counted, and the
# decode states of a prefill of the training batch's first PROMPT_LEN
# tokens and STATE_STEPS decode steps, whole in one process and each
# rank's part on the mesh
MAMBA = ("mamba2-780m", "zamba2-2.7b")
STATE_STEPS = 3


def tag(shape) -> str:
    return "x".join(map(str, shape))


def smoke(arch: str, get_smoke):
    """The smoke config of ``arch`` (a VARIANTS key too) from either
    package's ``get_smoke``."""
    base, over = VARIANTS.get(arch, (arch, {}))
    return get_smoke(base).replace(**over)


def train_cfg(arch: str):
    from repro_torch.configs import get_smoke
    return smoke(arch, get_smoke).replace(remat="full")


def make_inputs(path, archs) -> None:
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.models import Model
    from repro_torch.models.lm import PATCH_DIM
    out = {}
    for i, arch in enumerate(archs):
        cfg = smoke(arch, get_smoke)
        model = Model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        for name, p in model.named_parameters():
            out[f"{arch}/state/{name}"] = p.detach().numpy()
        rng = np.random.default_rng(30 + i)
        b, s = BATCH
        out[f"{arch}/tokens"] = rng.integers(0, cfg.vocab, size=(b, s + 1))
        if cfg.family == "encdec":
            out[f"{arch}/frames"] = rng.standard_normal(
                (b, cfg.enc_len, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            out[f"{arch}/patches"] = rng.standard_normal(
                (b, cfg.n_patches, PATCH_DIM)).astype(np.float32)
        for j, n in enumerate(PROMPTS):
            out[f"{arch}/prompt{j}"] = rng.integers(0, cfg.vocab, size=n)
    rng = np.random.default_rng(40)
    out["ce/logits"] = (3 * rng.standard_normal(CE_SHAPE)).astype(np.float32)
    out["ce/labels"] = rng.integers(0, CE_SHAPE[-1], size=CE_SHAPE[:2])
    np.savez(path, **out)


def state(data, arch: str) -> dict:
    """Fresh tensors of the arch's whole weights."""
    import torch
    pre = f"{arch}/state/"
    return {k[len(pre):]: torch.tensor(data[k]) for k in data.files
            if k.startswith(pre)}


def batch(data, arch: str) -> dict:
    """The whole training batch: tokens and labels, and frames or
    patches."""
    import torch
    toks = torch.tensor(data[f"{arch}/tokens"])
    out = {"tokens": toks[:, :-1].contiguous(),
           "labels": toks[:, 1:].contiguous()}
    for key in ("frames", "patches"):
        if f"{arch}/{key}" in data.files:
            out[key] = torch.tensor(data[f"{arch}/{key}"])
    return out


def train_run(model, data, arch: str) -> dict:
    """TRAIN_STEPS ``make_train_step`` steps on the whole batch (of which
    the step keeps the rank's rows on a mesh): the losses and grad norms,
    and the step-1 loss's
    gradients as AdamW receives them (on a mesh: averaged over the data
    axes, nothing summed over "model")."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamW, AdamWConfig
    b = batch(data, arch)
    opt = AdamW(AdamWConfig(**OPT))
    grads = []
    update = opt.update

    def keep(g, *args, **kw):
        if not grads:
            grads.append({n: t.detach().clone() for n, t in g.items()})
        return update(g, *args, **kw)

    opt.update = keep
    params = dict(model.named_parameters())
    st = {"params": params, "opt": opt.init(params)}
    step = make_train_step(model, opt)
    out: dict = {"loss": [], "grad_norm": []}
    for _ in range(TRAIN_STEPS):
        st, met = step(st, b)
        for k in out:
            out[k].append(float(met[k]))
    out = {k: np.array(v) for k, v in out.items()}
    out.update({f"grad/{n}": g.numpy() for n, g in grads[0].items()})
    return out


def serve_run(model, data, arch: str) -> np.ndarray:
    """The greedy tokens of the PROMPTS through ``ServingEngine``, in
    request order; whisper's through ``launch/serve.generate``."""
    import torch

    from repro_torch.launch.serve import generate
    from repro_torch.runtime import ServingEngine
    if model.cfg.family == "encdec":
        b = batch(data, arch)
        return generate(model, {"tokens": b["tokens"][:, :PROMPT_LEN],
                                "frames": b["frames"]}, MAX_NEW).numpy()
    eng = ServingEngine(model, device="cpu", **SERVE)
    for j in range(len(PROMPTS)):
        eng.submit(data[f"{arch}/prompt{j}"], max_new=MAX_NEW)
    with torch.no_grad():
        done = sorted(eng.run_until_drained(), key=lambda c: c.id)
    return np.array([c.tokens for c in done])


def step_collectives(model, data, arch: str) -> np.ndarray:
    """Every collective of one ``make_train_step`` step on the whole batch,
    in order, as "kind/axis/result shape" (``roofline/counting``'s
    ``collective_shapes``)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.roofline import Counter
    opt = AdamW(AdamWConfig(**OPT))
    params = dict(model.named_parameters())
    st = {"params": params, "opt": opt.init(params)}
    step = make_train_step(model, opt)
    with Counter("cpu", model.mesh) as c:
        step(st, batch(data, arch))
    return np.array([f"{k}/{a}/{tag(s)}" for k, a, s in c.collective_shapes])


def state_run(data, arch: str, mesh, res: dict, key: str) -> None:
    """One process's prefill of the first PROMPT_LEN tokens of the training
    batch and STATE_STEPS greedy decode steps: its conv and ssm states
    after the prefill and after the steps (``key/whole/...``); then the
    same on ``mesh`` in "tp" mode through ``make_prefill_step`` and
    ``make_serve_step``, fed one process's tokens (the whole batch's):
    the rank's states (``key/part/...``) and greedy tokens."""
    import torch

    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import Model
    import torch.nn.functional as F
    cfg = train_cfg(arch)
    prompt = {"tokens": batch(data, arch)["tokens"][:, :PROMPT_LEN]}
    whole = Model(cfg, device="cpu").load_state(state(data, arch))
    model = Model(cfg, device="cpu", mesh=mesh).load_state(state(data, arch))
    pad = (0, 0, 0, 0, 0, STATE_STEPS)          # the hybrid's k/v slots
    with torch.no_grad():
        logits, cache = whole.prefill(prompt, pad_to=PROMPT_LEN + STATE_STEPS)
        toks = [whole.greedy(logits)[:, None]]
        got, part = make_prefill_step(model)(prompt)
        part = {k: F.pad(v, pad) if k in ("k", "v") else v
                for k, v in part.items()}
        res[f"{key}/part/tok0"] = got.numpy()
        step = make_serve_step(model)
        for name, c in (("whole", cache), ("part", part)):
            for leaf in ("conv", "ssm"):
                res[f"{key}/{name}/prefill/{leaf}"] = c[leaf].numpy().copy()
        for i in range(STATE_STEPS):
            logits, cache = whole.decode_step(toks[-1], cache)
            got, part = step(toks[-1], part)
            res[f"{key}/part/tok{i + 1}"] = got.numpy()
            toks.append(whole.greedy(logits)[:, None])
    for name, c in (("whole", cache), ("part", part)):
        for leaf in ("conv", "ssm"):
            res[f"{key}/{name}/decode/{leaf}"] = c[leaf].numpy()
    res[f"{key}/whole/tok"] = torch.cat(toks, dim=1).numpy()


def _switched_losses(model, data, arch: str) -> np.ndarray:
    """The loss of the rank's rows in the mode the model was built in, and
    again after ``set_sharding_mode`` names the other mode ("fsdp": every
    leaf sliced over the whole mesh and gathered at its use): the model's
    methods install its own mode, so the two are the same."""
    import torch

    from repro_torch.launch.shardings import shard_batch
    from repro_torch.models.common import set_sharding_mode
    b = shard_batch(batch(data, arch), model.mesh, model.mode)
    out = []
    with torch.no_grad():
        for mode in (model.mode, {"tp": "fsdp", "fsdp": "tp"}[model.mode]):
            set_sharding_mode(mode)
            try:
                out.append(float(model.train_loss(b)[0]))
            finally:
                set_sharding_mode(model.mode)
    return np.array(out)


def _ce(data, mesh, res: dict, key: str) -> None:
    """The vocabulary-parallel CE of this rank's slice of the CE case's
    logits: the loss and the gradient of the slice."""
    import torch

    from repro_torch.launch.collectives import vocab_cross_entropy
    from repro_torch.launch.mesh import MeshSpec, coordinate
    nm = MeshSpec.of(mesh).shape["model"]
    full = torch.tensor(data["ce/logits"])
    part = full.shape[-1] // nm
    x = full.narrow(-1, coordinate(mesh)["model"] * part, part).clone()
    x.requires_grad_(True)
    loss = vocab_cross_entropy(x, torch.tensor(data["ce/labels"]), mesh)
    loss.backward()
    res[f"{key}/ce/loss"] = loss.detach().numpy()
    res[f"{key}/ce/grad"] = x.grad.numpy()


def worker(rank: int, world: int, store: str, inputs: str, out_dir: str,
           archs: tuple) -> None:
    """One rank of a gloo group of ``world``: every case of that world size,
    written to ``out_dir/w<world>rank<rank>.npz``."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    data = np.load(inputs)
    res: dict = {}
    try:
        if world == 1:
            _ce(data, make_mesh((1, 1), AXES, device="cpu"), res, "1x1")
            for arch in archs:
                model = Model(train_cfg(arch), device="cpu").load_state(
                    state(data, arch))
                for k, v in train_run(model, data, arch).items():
                    res[f"one/{arch}/train/{k}"] = v
                if arch in SERVED:
                    res[f"one/{arch}/serve"] = serve_run(
                        Model(train_cfg(arch), device="cpu").load_state(
                            state(data, arch)), data, arch)
        for shape in MESHES.get(world, ()):
            mesh = make_mesh(shape, AXES, device="cpu")
            t = tag(shape)
            _ce(data, mesh, res, t)
            for arch in archs:
                model = Model(train_cfg(arch), device="cpu",
                              mesh=mesh).load_state(state(data, arch))
                for name, p in model.named_parameters():
                    res[f"{t}/{arch}/slice/{name}"] = p.detach().numpy().copy()
                res[f"{t}/{arch}/switched"] = _switched_losses(model, data,
                                                               arch)
                res[f"{t}/{arch}/sharded"] = np.array(sorted(model.sharded))
                for k, v in train_run(model, data, arch).items():
                    res[f"{t}/{arch}/train/{k}"] = v
                if arch in MAMBA:
                    res[f"{t}/{arch}/collectives"] = step_collectives(
                        Model(train_cfg(arch), device="cpu",
                              mesh=mesh).load_state(state(data, arch)),
                        data, arch)
                    state_run(data, arch, mesh, res, f"{t}/{arch}/states")
                if arch in SERVED and shape in SERVE_MESHES:
                    res[f"{t}/{arch}/serve"] = serve_run(
                        Model(train_cfg(arch), device="cpu",
                              mesh=mesh).load_state(state(data, arch)),
                        data, arch)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"w{world}rank{rank}.npz"), **res)


def _tree(data, arch: str) -> dict:
    pre = f"{arch}/state/"
    tree: dict = {}       # numpy leaves: slicing them compiles nothing
    for k in data.files:
        if k.startswith(pre):
            *path, last = k[len(pre):].split(".")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[last] = data[k]
    return tree


def jax_reference(inputs: str, out: str, archs: tuple) -> None:
    """The JAX package on the same inputs (see the module's docstring)."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    from jax.sharding import AxisType

    from repro.configs import get_smoke
    from repro.launch.shardings import batch_shardings, param_shardings
    from repro.models import Model
    data = np.load(inputs)
    res: dict = {}
    jobs: list = []         # (key, lowered function, its arguments)
    meshes = {s: jax.make_mesh(s, AXES, axis_types=(AxisType.Auto,) * 2,
                               devices=jax.devices()[:int(np.prod(s))])
              for s in ALL_MESHES}

    def name_of(path) -> str:
        return ".".join(str(p.key) for p in path)

    for arch in archs:
        tree = _tree(data, arch)
        cfg = smoke(arch, get_smoke).replace(kernel_mode="ref")
        shapes = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape,
                                                             a.dtype), tree)
        for shape, mesh in meshes.items():
            specs = param_shardings(shapes, mesh, "tp")
            for path, sh in jax.tree_util.tree_leaves_with_path(specs):
                name = name_of(path)
                full = data[f"{arch}/state/{name}"]
                idx = sh.devices_indices_map(full.shape)
                for pos in np.ndindex(*mesh.devices.shape):
                    flat = int(np.ravel_multi_index(pos, shape))
                    res[f"{tag(shape)}/{arch}/slice/{name}/{flat}"] = \
                        full[idx[mesh.devices[pos]]]
        toks = data[f"{arch}/tokens"]
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        for key in ("frames", "patches"):
            if f"{arch}/{key}" in data.files:
                b[key] = data[f"{arch}/{key}"]
        jm = Model(cfg)
        vg = jax.value_and_grad(lambda p, bb, jm=jm: jm.train_loss(p, bb)[0])
        jobs.append((f"{arch}/jax", jax.jit(vg).lower(tree, b), (tree, b)))
        if arch in GSPMD:
            mesh = meshes[GSPMD_MESH]
            bshapes = jax.tree.map(lambda a: jax.ShapeDtypeStruct(
                a.shape, a.dtype), b)
            shard = jax.jit(vg, in_shardings=(
                param_shardings(shapes, mesh, "tp"),
                batch_shardings(bshapes, mesh, "tp")))
            with jax.set_mesh(mesh):
                jobs.append((f"{arch}/gspmd", shard.lower(tree, b),
                             (tree, b)))
    # XLA compiles outside the interpreter lock: compile side by side
    with ThreadPoolExecutor(4) as pool:
        compiled = list(pool.map(lambda j: j[1].compile(), jobs))
    for (key, _, args), fn in zip(jobs, compiled):
        loss, grads = fn(*args)
        res[f"{key}/loss"] = loss
        for path, g in jax.tree_util.tree_leaves_with_path(grads):
            res[f"{key}/grad/{name_of(path)}"] = g
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})


# ------------------------------------------------------------ checkpoints
# tests/test_torch_checkpoint_sharded.py: llama4-scout smoke (experts,
# attention, the shared expert and the vocabulary all sliced in "tp"; every
# leaf over the whole mesh in "fsdp", the experts over "model" and "data"),
# saved on SAVE_MESH, restored on RESTORE_MESHES and at world 1
CKPT_ARCH = "llama4-scout-17b-a16e"
SAVE_MESH = (1, 2)
RESTORE_MESHES = {4: [(1, 4), (2, 2)]}
MODES = ("tp", "fsdp")
# and a state of each LAYOUT ({layout: (mode, ZeRO-1 moments)}) saved on
# its LAYOUT_SAVE mesh, restored in every layout on LAYOUT_RESTORE and at
# world 1, and the JAX package's save of it restored on LAYOUT_SAVE
LAYOUTS = {"fsdp": ("fsdp", False), "zero1": ("tp", True)}
LAYOUT_SAVE = {"fsdp": (2, 2), "zero1": (2, 1)}
LAYOUT_RESTORE = (1, 4)


def _zeroed(model) -> dict:
    """Zeros of the rank's leaves (a model not drawn yet holds meta ones)."""
    import torch
    return {n: torch.zeros(p.shape, dtype=p.dtype)
            for n, p in model.named_parameters()}


def _one_step_state(model, data, zero1: bool = False) -> dict:
    """{"params", "opt"} after one ``make_train_step`` step on the rank's
    rows (f32 AdamW moments, nonzero; ZeRO-1's with ``zero1``), as a
    checkpoint takes it."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamW, AdamWConfig
    opt = AdamW(AdamWConfig(**OPT))
    params = dict(model.named_parameters())
    st = {"params": params, "opt": opt.init(params, model, zero1)}
    st, _ = make_train_step(model, opt)(st, batch(data, CKPT_ARCH))
    return st


def _dump(res: dict, key: str, st: dict) -> None:
    from repro_torch.runtime.checkpoint import flatten_state
    for name, leaf in flatten_state(st).items():
        res[f"{key}/{name}"] = leaf.detach().numpy().copy()


def ckpt_worker(rank: int, world: int, store: str, inputs: str,
                out_dir: str, phase: str) -> None:
    """One rank of a gloo group for the checkpoint cases.  Phase "save"
    (world 2, SAVE_MESH), in each mode: a save without the model (which
    must raise and write nothing), the ROADMAP's reproduction (every
    rank saves its model's parameters into one directory and restores them
    into zeroed copies), a JAX-saved checkpoint restored, and one training
    step's state saved and dumped as the rank holds it.  Phase "restore"
    (world 1 or 4): that state restored on each mesh of the world (at
    world 1 without a mesh, whole), dumped.  Then the LAYOUTS' cases of
    the phase (``_layout_cases``; phase "jax" has only those)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.models.common import set_sharding_mode
    from repro_torch.runtime import CheckpointManager
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    data = np.load(inputs)
    cfg = train_cfg(CKPT_ARCH)
    res: dict = {}
    try:
        for mode in MODES if phase != "jax" else ():
            set_sharding_mode(mode)
            if phase == "save" and world == 2:
                mesh = make_mesh(SAVE_MESH, AXES, device="cpu")
                model = Model(cfg, device="cpu", mesh=mesh).load_state(
                    state(data, CKPT_ARCH))
                d = os.path.join(out_dir, f"repro_{mode}")
                try:
                    CheckpointManager(d).save(1, {"params": dict(
                        model.named_parameters())})
                except ValueError as e:
                    res[f"{mode}/bare_save"] = np.array(str(e))
                res[f"{mode}/bare_save_wrote"] = np.array(os.listdir(d))
                dist.barrier()
                CheckpointManager(d).save(1, {"params": dict(
                    model.named_parameters())}, model=model)
                back = {"params": _zeroed(model)}
                CheckpointManager(d).restore(back, model=model)
                _dump(res, f"{mode}/repro/own", {"params": dict(
                    model.named_parameters())})
                _dump(res, f"{mode}/repro/back", back)
                back = {"params": _zeroed(model)}
                CheckpointManager(os.path.join(out_dir, "jax")).restore(
                    back, model=model)
                _dump(res, f"{mode}/from_jax", back)
                st = _one_step_state(model, data)
                CheckpointManager(os.path.join(out_dir, f"step_{mode}")).save(
                    2, st, model=model)
                _dump(res, f"{mode}/saved", st)
                continue
            if phase == "save":
                continue
            for shape in RESTORE_MESHES.get(world, [None]):
                mesh = None if shape is None else make_mesh(shape, AXES,
                                                            device="cpu")
                model = Model(cfg, device="cpu", mesh=mesh)
                back = {"params": _zeroed(model),
                        "opt": {"m": _zeroed(model), "v": _zeroed(model),
                                "count": torch.zeros((), dtype=torch.int32)}}
                CheckpointManager(os.path.join(out_dir, f"step_{mode}")
                                  ).restore(back, model=model)
                _dump(res, f"{mode}/{'1x1' if mesh is None else tag(shape)}",
                      back)
        _layout_cases(world, phase, data, cfg, out_dir, res)
    finally:
        set_sharding_mode("tp")
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"{phase}_w{world}rank{rank}.npz"), **res)


def _layout_model(cfg, mesh, layout: str):
    from repro_torch.models import Model
    from repro_torch.models.common import set_sharding_mode
    set_sharding_mode(LAYOUTS[layout][0])
    try:
        return Model(cfg, device="cpu", mesh=mesh)
    finally:
        set_sharding_mode("tp")


def _zeroed_state(model, layout: str) -> dict:
    """Zeros of the rank's parameters and of its moments in ``layout``."""
    from repro_torch.optim import AdamW
    params = _zeroed(model)
    return {"params": params, "opt": AdamW().init(
        params, model, zero1=model.mesh is not None and LAYOUTS[layout][1])}


def _layout_cases(world: int, phase: str, data, cfg, out_dir: str,
                  res: dict) -> None:
    """The LAYOUTS' cases of ``ckpt_worker``.  "save": one training step's
    state of each layout whose LAYOUT_SAVE mesh has ``world`` ranks, saved
    into ``layout_<layout>`` and dumped.  "restore": at world 1 each saved
    state restored whole without a mesh, at the world of LAYOUT_RESTORE
    each restored in every layout there.  "jax": the JAX package's save of
    each state (``jax_<layout>``) restored on its LAYOUT_SAVE mesh."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import CheckpointManager
    for layout, shape in LAYOUT_SAVE.items():
        if phase == "save" and int(np.prod(shape)) == world:
            model = _layout_model(cfg, make_mesh(shape, AXES, device="cpu"),
                                  layout).load_state(state(data, CKPT_ARCH))
            st = _one_step_state(model, data, LAYOUTS[layout][1])
            CheckpointManager(os.path.join(out_dir, f"layout_{layout}")).save(
                2, st, model=model)
            _dump(res, f"layout/{layout}/saved", st)
        elif phase == "jax" and int(np.prod(shape)) == world:
            model = _layout_model(cfg, make_mesh(shape, AXES, device="cpu"),
                                  layout)
            back = _zeroed_state(model, layout)
            CheckpointManager(os.path.join(out_dir, f"jax_{layout}")).restore(
                back, model=model)
            _dump(res, f"layout/{layout}/from_jax", back)
        elif phase == "restore" and world == 1:
            model = _layout_model(cfg, None, layout)
            back = _zeroed_state(model, layout)
            CheckpointManager(os.path.join(out_dir, f"layout_{layout}")
                              ).restore(back, model=model)
            _dump(res, f"layout/{layout}/whole", back)
        elif phase == "restore" and world == int(np.prod(LAYOUT_RESTORE)):
            mesh = make_mesh(LAYOUT_RESTORE, AXES, device="cpu")
            for target in LAYOUTS:
                model = _layout_model(cfg, mesh, target)
                back = _zeroed_state(model, target)
                CheckpointManager(os.path.join(out_dir, f"layout_{layout}")
                                  ).restore(back, model=model)
                _dump(res, f"layout/{layout}/{target}", back)
