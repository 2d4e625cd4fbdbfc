"""Expert-parallel MoE on torch.distributed (gloo, the CPU) against the JAX
package's expert-parallel paths, its dense dispatch and ``jax.grad`` of its
``train_loss``.

One module fixture runs everything once: the port at world 1, 2 and 4
(``tests/_torch_dist.py::worker``, one spawned process a rank, each world's
cases in one spawn) beside the JAX reference in a subprocess with 4 forced
host devices (``shard_map`` needs them).  The tests read what they wrote.
Smoke llama4-scout (top-1) and arctic-480b (top-2, 4 experts), f32, meshes
(1, 2), (1, 4), (2, 2) and (4, 1) of (data, model), both sharding modes:
"tp" is the all-reduce path, "fsdp" the all-to-all one.  The MoE block's
cases take the rows alike on every rank of "model" (as serving does); the
training steps run each mode's whole layout: in "fsdp" every leaf sliced
over the whole mesh and the rows over every axis (ZeRO-3; the other
families' fsdp cases are tests/test_torch_fsdp.py's).
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_dist as td  # noqa: E402

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch.mesh import MeshSpec, make_mesh  # noqa: E402
from repro_torch.launch.shardings import (carried, leaf_spec,  # noqa
                                          local_slice, placements)
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.mlp import moe_capacity, moe_forward  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# f32 on both sides: the ranks' sums run in another order than one
# process's (observed <= 5.4e-7 for y, 3e-6 for a gradient)
REL = 1e-5
AUX_REL = 1e-6
GRAD_REL = 1e-4                  # tests/test_torch_train.py
LOSS_REL = 1e-5
NORM_REL = 1e-6
MESHES = [s for w in (2, 4) for s in td.MESHES[w]]
CASES = [(a, s, m) for a in td.MOE for s in MESHES for m in td.MODES]
IDS = [f"{a}-{td.tag(s)}-{m}" for a, s, m in CASES]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def _leaf_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def _wait(procs, jax_proc, timeout: float) -> None:
    for ctx in procs:
        while not ctx.join(timeout=timeout):
            pass
    _, err = jax_proc.communicate(timeout=timeout)
    assert jax_proc.returncode == 0, err[-3000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": its npz, (world, rank): the rank's npz, "inputs": ...}."""
    d = tmp_path_factory.mktemp("expert_parallel")
    inputs = str(d / "inputs.npz")
    td.make_inputs(inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", "import _torch_dist; _torch_dist."
         f"jax_reference({inputs!r}, {str(d / 'jax.npz')!r})"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs = [torch.multiprocessing.start_processes(
        td.worker, args=(w, str(d / f"store{w}"), inputs, str(d)),
        nprocs=w, join=False, start_method="spawn") for w in (1, 2, 4)]
    try:
        _wait(procs, jax_proc, timeout=300)
    finally:
        jax_proc.kill()
    out = {"jax": np.load(d / "jax.npz"), "inputs": np.load(inputs)}
    for w in (1, 2, 4):
        for r in range(w):
            out[w, r] = np.load(d / f"w{w}rank{r}.npz")
    return out


def _dropped(arch, inputs, parts: int) -> int:
    """The block's (token, choice) pairs over capacity when each row is
    routed in ``parts`` slices, counted in numpy."""
    cfg = get_smoke(arch)
    x = inputs[f"{arch}/x"].astype(np.float64)
    router = inputs[f"{arch}/state/layers.moe.router"][0]
    top = np.argsort(-(x @ router), axis=-1)[..., :cfg.top_k]
    b, s = td.BLOCK
    cap = moe_capacity(cfg, s // parts)
    return int(sum(np.maximum(np.bincount(
        top[r, p * s // parts:(p + 1) * s // parts].reshape(-1),
        minlength=cfg.n_experts) - cap, 0).sum()
        for r in range(b) for p in range(parts)))


def _ranks(runs, shape):
    w = int(np.prod(shape))
    return [runs[w, r] for r in range(w)]


def _block_rows(shape, rank_res, t):
    """The rows of the block's batch that this rank took."""
    nb = shape[0]
    b = td.BLOCK[0]
    if b % nb or b < nb:
        return slice(None)
    d = int(rank_res[f"{t}/coord"][0])
    return slice(d * b // nb, (d + 1) * b // nb)


@pytest.mark.parametrize("shape", MESHES, ids=map(td.tag, MESHES))
def test_rank_order_is_row_major_as_jax_make_mesh(runs, shape):
    want = np.arange(int(np.prod(shape))).reshape(shape)
    np.testing.assert_array_equal(runs["jax"][f"{td.tag(shape)}/order"],
                                  want)
    for r, res in enumerate(_ranks(runs, shape)):
        np.testing.assert_array_equal(res[f"{td.tag(shape)}/order"], want)
        np.testing.assert_array_equal(res[f"{td.tag(shape)}/coord"],
                                      np.unravel_index(r, shape))


@pytest.mark.parametrize("shape", MESHES, ids=map(td.tag, MESHES))
@pytest.mark.parametrize("arch", td.MOE)
def test_shard_params_gives_each_rank_jax_slice(runs, arch, shape):
    """(vi) Each rank's expert slice is the numpy slice that JAX's
    ``NamedSharding(mesh, spec).devices_indices_map`` gives the device at
    the same mesh position (param_shardings' spec, "tp")."""
    t = td.tag(shape)
    for r, res in enumerate(_ranks(runs, shape)):
        for k in td.EXPERTS:
            got = res[f"{t}/{arch}/shard/{k}"]
            want = runs["jax"][f"{t}/{arch}/shard/{k}/{r}"]
            assert got.shape == want.shape and got.flags["C_CONTIGUOUS"]
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", MESHES, ids=map(td.tag, MESHES))
def test_local_slice_matches_devices_indices_map(runs, shape):
    """``local_slice`` at each mesh position, and the local part of the
    DTensor that ``placements`` describes on each rank, against JAX's index
    map of the device there, for a dim over both axes (in both orders; the
    DTensor takes only the mesh's) and a spec over two dims."""
    full = torch.arange(8 * 8).reshape(8, 8)
    mesh = MeshSpec(td.AXES, shape)
    t = td.tag(shape)
    for i, spec in enumerate(td.TWO_AXIS_SPECS):
        for r, res in enumerate(_ranks(runs, shape)):
            want = runs["jax"][f"{t}/two_axis{i}/{r}"]
            coord = dict(zip(td.AXES, map(int, np.unravel_index(r, shape))))
            np.testing.assert_array_equal(
                local_slice(full, spec, mesh, coord).numpy(), want)
            if i == td.MODEL_MAJOR:
                with pytest.raises(ValueError, match="order"):
                    placements(spec, mesh)
            else:
                np.testing.assert_array_equal(res[f"{t}/dtensor{i}"], want)


@pytest.mark.parametrize("arch,shape,mode", CASES, ids=IDS)
def test_expert_parallel_matches_jax(runs, arch, shape, mode):
    """(i) Every rank's y, and the gradients of sum(y^2) in the expert
    weights (summed over the data ranks: each rank holds its rows' share)
    and in x (the rank's rows), against the JAX path of the same mode at
    the default capacity, drops included.  arctic's router gradient too;
    llama4's top-1 combine weight is p / p = 1, so its router gradient
    through y is rounding noise on both sides."""
    t, jx = td.tag(shape), runs["jax"]
    key = f"{t}/{arch}/{mode}"
    cf = f"cf{get_smoke(arch).capacity_factor:g}"
    ranks = _ranks(runs, shape)
    nb, nm = shape
    assert _dropped(arch, runs["inputs"], nm if mode == "fsdp" else 1) > 0
    for res in ranks:
        rows = _block_rows(shape, res, t)
        assert _rel(res[f"{key}/{cf}/y"], jx[f"{key}/y"][rows]) < REL
        assert _rel(res[f"{key}/{cf}/grad/x"],
                    jx[f"{key}/grad/x"][rows]) < REL
    replicated = td.BLOCK[0] % nb or td.BLOCK[0] < nb
    names = list(td.EXPERTS) + (["router"] if arch == "arctic-480b" else [])
    for k in names:
        by_model = [sum(ranks[d * nm + m][f"{key}/{cf}/grad/{k}"]
                        for d in range(nb)) / (nb if replicated else 1)
                    for m in range(nm)]
        got = by_model[0] if k == "router" else np.concatenate(by_model)
        assert _rel(got, jx[f"{key}/grad/{k}"]) < REL, k


@pytest.mark.parametrize("arch,shape,mode", CASES, ids=IDS)
def test_aux_is_the_whole_batch(runs, arch, shape, mode):
    """(ii) aux on every rank equals the dense dispatch's, JAX's and the
    port's, at every mesh.  The reference's expert-parallel aux is one
    token shard's wherever an axis splits the tokens (ROADMAP.md, faults
    of the reference): it is held to differ there, and to agree elsewhere."""
    t, jx = td.tag(shape), runs["jax"]
    key = f"{t}/{arch}/{mode}"
    dense = float(jx[f"{arch}/dense/aux"])
    cfg = get_smoke(arch)
    x = torch.tensor(runs["inputs"][f"{arch}/x"])
    params = {k.rsplit(".", 1)[-1]: torch.tensor(runs["inputs"][k][0])
              for k in runs["inputs"].files
              if k.startswith(f"{arch}/state/layers.moe.")}
    _, port_aux = moe_forward(params, x, cfg)
    assert abs(float(port_aux) - dense) <= AUX_REL * dense
    for res in _ranks(runs, shape):
        for cf in (cfg.capacity_factor, td.NO_DROP_CF):
            got = float(res[f"{key}/cf{cf:g}/aux"])
            assert abs(got - dense) <= AUX_REL * dense, (cf, got, dense)
    splits = shape[0] > 1 and td.BLOCK[0] % shape[0] == 0 or (
        mode == "fsdp" and shape[1] > 1)
    jax_aux = float(jx[f"{key}/aux"])
    assert (abs(jax_aux - dense) > 1e-3) == splits, (jax_aux, dense)


@pytest.mark.parametrize("arch,shape,mode", CASES, ids=IDS)
def test_expert_parallel_is_the_dense_dispatch_without_drops(runs, arch,
                                                             shape, mode):
    """(iii) y against the port's own dense dispatch: the all-reduce path
    at the default capacity (its capacity and slots are the dense
    dispatch's, drops included), both paths where nothing is dropped."""
    cfg = get_smoke(arch)
    inp = runs["inputs"]
    x = torch.tensor(inp[f"{arch}/x"])
    params = {k.rsplit(".", 1)[-1]: torch.tensor(inp[k][0])
              for k in inp.files if k.startswith(f"{arch}/state/layers.moe.")}
    cfs = [td.NO_DROP_CF] + ([cfg.capacity_factor] if mode == "tp" else [])
    t = td.tag(shape)
    for cf in cfs:
        with torch.no_grad():
            want, _ = moe_forward(params, x, cfg.replace(capacity_factor=cf))
        for res in _ranks(runs, shape):
            got = res[f"{t}/{arch}/{mode}/cf{cf:g}/y"]
            assert _rel(got, want.numpy()[_block_rows(shape, res, t)]) < REL


def _single_process_run(arch, mode, data):
    cfg = get_smoke(arch).replace(remat="full",
                                  capacity_factor=td.train_cf(
                                      get_smoke(arch), mode))
    return td.train_run(Model(cfg, device="cpu").load_state(
        td._state(data, arch)), data, arch)


def _assemble(leaves: list, name: str, shape, mesh, mode: str):
    """The whole leaf from each rank's part (``leaf_spec``'s slice at the
    rank's coordinate, the leaf itself where ``carried`` says it is
    whole); the ranks that hold one part must hold it alike, bit for bit
    (a replicated leaf's gradient with no reduction over "model")."""
    spec = leaf_spec(name, shape, mesh, mode) if carried(
        name, shape, mesh, mode) else ()
    ids = torch.arange(int(np.prod(shape))).reshape(shape)
    out = np.full(shape, np.nan)
    flat = out.reshape(-1)
    for r, leaf in enumerate(leaves):
        coord = dict(zip(td.AXES, map(int, np.unravel_index(
            r, mesh.sizes))))
        idx = local_slice(ids, spec, mesh, coord).numpy()
        have = flat[idx]
        seen = ~np.isnan(have)
        np.testing.assert_array_equal(have[seen], leaf[seen], err_msg=name)
        flat[idx] = leaf
    assert not np.isnan(out).any(), name
    return out


@pytest.mark.parametrize("mode", td.MODES)
@pytest.mark.parametrize("arch", td.MOE)
def test_data_expert_parallel_train_step(runs, arch, mode):
    """(iv) ``make_train_step`` on the (2, 2) mesh, remat "full", each rank
    on its rows (in "tp" mode 2 of the 4 rows a data rank, in "fsdp" mode
    1 a rank): every leaf's step-1 gradient, assembled from the ranks'
    parts (in "tp" mode the experts and every leaf the rules split over
    "model"; in "fsdp" mode every leaf, over the whole mesh, the experts
    over "model" and "data"), within GRAD_REL of ``jax.grad`` of the JAX
    ``train_loss`` on the whole batch (dense dispatch; the all-to-all mode
    at a capacity that drops nothing), the ranks that hold one part alike
    bit for bit, and the 3 losses and grad norms those of one process."""
    t = td.tag(td.TRAIN_MESH)
    cf = td.train_cf(get_smoke(arch), mode)
    jgrads = {k.split("/grad/", 1)[1]: runs["jax"][k]
              for k in runs["jax"].files
              if k.startswith(f"{arch}/train/cf{cf:g}/grad/")}
    ranks = _ranks(runs, td.TRAIN_MESH)
    pre = f"{t}/{arch}/train/{mode}"
    spec = MeshSpec(td.AXES, td.TRAIN_MESH)
    assert {k.split("/grad/", 1)[1] for k in ranks[0].files
            if k.startswith(f"{pre}/grad/")} == set(jgrads)
    for name, want in jgrads.items():
        got = _assemble([res[f"{pre}/grad/{name}"] for res in ranks], name,
                        want.shape, spec, mode)
        assert _leaf_rel(got, want) <= GRAD_REL, name
    one = _single_process_run(arch, mode, runs["inputs"])
    for res in ranks:
        np.testing.assert_allclose(res[f"{pre}/loss"], one["loss"],
                                   rtol=LOSS_REL)
        np.testing.assert_allclose(res[f"{pre}/grad_norm"],
                                   one["grad_norm"], rtol=NORM_REL)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)], ids=["1x2", "1x4"])
@pytest.mark.parametrize("arch", td.MOE)
def test_serving_on_a_mesh_matches_one_process(runs, arch, shape):
    """(v) ``ServingEngine`` with each rank's experts: prefill takes the
    all-reduce path, as decode's one token does; every rank's greedy tokens
    equal one process's."""
    data = runs["inputs"]
    model = Model(get_smoke(arch), device="cpu").load_state(
        td._state(data, arch))
    want = td.serve_run(model, data, arch)
    assert want.shape == (len(td.PROMPTS), td.MAX_NEW)
    for res in _ranks(runs, shape):
        np.testing.assert_array_equal(res[f"{td.tag(shape)}/{arch}/serve"],
                                      want)


@pytest.mark.parametrize("mode", td.MODES)
@pytest.mark.parametrize("arch", td.MOE)
def test_world_one_is_the_dense_dispatch_bit_for_bit(runs, arch, mode):
    """At world 1 a sum or an all-to-all over one rank changes no value and
    the buffers are the dense dispatch's: the block's y, aux and
    gradients, and the training step's 3 losses and step-1 gradients,
    remat "full", are the dense dispatch's to the bit (the card's phase 8
    holds the same)."""
    res = runs[1, 0]
    pre = f"1x1/{arch}/dense/"
    keys = [k for k in res.files if k.startswith(pre)]
    assert any("/train/grad/" in k for k in keys)
    for k in keys:
        np.testing.assert_array_equal(res[k.replace("/dense/", f"/{mode}/")],
                                      res[k], err_msg=k)


def test_model_refuses_a_mesh_of_another_device():
    with pytest.raises(ValueError, match="mesh"):
        Model(get_smoke("arctic-480b"), device="cpu",
              mesh=type("M", (), {"device_type": "cuda"})())


def test_make_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh((1, 1), ("data", "model"), device="cpu")
