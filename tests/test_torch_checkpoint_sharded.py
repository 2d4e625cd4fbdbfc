"""Checkpoints of a model on a mesh (gloo, the CPU): whole leaves in the
reference's format, saved on one mesh and restored on another, and across
the port and the JAX package.

One module fixture runs the ranks (``tests/_torch_tp.py::ckpt_worker``, one
spawned process a rank): world 2 on a (1, 2) mesh saves, in "tp" mode (every
leaf the rules split over "model" is sliced) and in "fsdp" mode (every leaf
sliced over the whole mesh); then world 4 restores on (1, 4) and (2, 2), and
world 1 without a mesh.  Besides, a state of the fsdp layout saved on
(2, 2) and one with ZeRO-1 moments ("tp" mode) saved on (2, 1) are restored
in both layouts on (1, 4) and whole without a mesh, and cross with the JAX
package both ways.  llama4-scout smoke, f32.  The JAX package's
``CheckpointManager`` writes a checkpoint the ranks restore and reads back
what they saved.
"""
import json
import os
from pathlib import Path

import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_tp as tt  # noqa: E402

from repro.runtime.checkpoint import CheckpointManager as JaxCheckpoint  # noqa
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch.mesh import MeshSpec  # noqa: E402
from repro_torch.launch.shardings import leaf_spec, local_slice  # noqa
from repro_torch.launch.shardings import zero1_spec  # noqa: E402
from repro_torch.models.api import Model, flatten  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = tt.CKPT_ARCH
RESTORED = [(1, 4), (2, 2)]
EXPERTS = [f"layers.moe.{k}" for k in ("w_in", "w_gate", "w_out")]


def _spawn(phase: str, worlds, d, inputs) -> None:
    procs = [torch.multiprocessing.start_processes(
        tt.ckpt_worker, args=(w, str(d / f"store_{phase}{w}"), inputs,
                              str(d), phase),
        nprocs=w, join=False, start_method="spawn") for w in worlds]
    for ctx in procs:
        while not ctx.join(timeout=300):
            pass


def _jax_tree(flat: dict, sep: str = ".") -> dict:
    tree: dict = {}
    for name, leaf in flat.items():
        *path, last = name.split(sep)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("checkpoint_sharded")
    inputs = str(d / "inputs.npz")
    tt.make_inputs(inputs, (ARCH,))
    data = np.load(inputs)
    whole = {k: v for k, v in tt.state(data, ARCH).items()}
    # the JAX package writes the initial parameters, as its trainer would
    JaxCheckpoint(str(d / "jax")).save(0, {"params": _jax_tree(
        {k: jax.numpy.asarray(v.numpy()) for k, v in whole.items()})})
    _spawn("save", (2, 4), d, inputs)
    _spawn("restore", (1, 4), d, inputs)
    one = np.load(d / "restore_w1rank0.npz")
    # the JAX package saves each layout's whole state, which the ranks
    # restore in the layout
    for layout in tt.LAYOUTS:
        JaxCheckpoint(str(d / f"jax_{layout}")).save(
            5, _jax_tree(_layout_flat(one, layout), "/"))
    _spawn("jax", (2, 4), d, inputs)
    out = {"dir": d, "whole": {k: v.numpy() for k, v in whole.items()}}
    for phase, w in (("save", 2), ("save", 4), ("restore", 1),
                     ("restore", 4), ("jax", 2), ("jax", 4)):
        for r in range(w):
            out[phase, w, r] = np.load(d / f"{phase}_w{w}rank{r}.npz")
    return out


def _layout_flat(res, layout: str) -> dict:
    """{"params/...": array} of the layout's state restored whole."""
    pre = f"layout/{layout}/whole/"
    return {k[len(pre):]: res[k] for k in res.files if k.startswith(pre)}


def _coord(shape, r) -> dict:
    return dict(zip(tt.AXES, map(int, np.unravel_index(r, shape))))


def _own(whole: np.ndarray, name: str, shape, r: int, mode: str):
    """The slice of ``whole`` (a parameter, or a moment beside one) that
    the rank at ``r`` of a mesh of ``shape`` holds in ``mode``."""
    spec = MeshSpec(tt.AXES, shape)
    return local_slice(torch.tensor(whole), leaf_spec(name, whole.shape,
                                                      spec, mode),
                       spec, _coord(shape, r)).numpy()


def _layout_own(whole: np.ndarray, path: str, shape, r: int,
                layout: str) -> np.ndarray:
    """The part of the state's leaf ``path`` ("params/...", "opt/m/...",
    "opt/count") that the rank at ``r`` of ``shape`` holds in ``layout``:
    the parameter's spec in the layout's mode, for a ZeRO-1 moment the
    reference's ``zero1_spec`` of its "tp" spec."""
    if path == "opt/count":
        return whole
    mesh = MeshSpec(tt.AXES, shape)
    moment = path.startswith("opt/")
    name = path.split("/", 2)[-1] if moment else path.split("/", 1)[1]
    name = name.replace("/", ".")
    mode, zero1 = tt.LAYOUTS[layout]
    spec = leaf_spec(name, whole.shape, mesh, mode)
    if moment and zero1:
        spec = zero1_spec(spec, whole.shape, mesh)
    return local_slice(torch.tensor(whole), spec, mesh,
                       _coord(shape, r)).numpy()


@pytest.mark.parametrize("mode", tt.MODES)
def test_every_rank_restores_its_own_slices(runs, mode):
    """The ROADMAP's reproduction: llama4-scout smoke on (1, 2), both ranks
    saving into one directory, each restoring into zeroed copies.  Before
    the checkpoint saved whole leaves, rank 1 came back with rank 0's
    experts (max abs diff 0.77).  Every rank now gets its own slices back
    exactly, the experts among them, and they differ between the ranks."""
    ranks = [runs["save", 2, r] for r in range(2)]
    pre = f"{mode}/repro"
    for res in ranks:
        names = [k[len(f"{pre}/own/"):] for k in res.files
                 if k.startswith(f"{pre}/own/")]
        assert {f"params/{e.replace('.', '/')}" for e in EXPERTS} <= \
            set(names)
        for n in names:
            np.testing.assert_array_equal(res[f"{pre}/back/{n}"],
                                          res[f"{pre}/own/{n}"], err_msg=n)
    for e in EXPERTS:
        key = f"{pre}/own/params/{e.replace('.', '/')}"
        assert not np.array_equal(ranks[0][key], ranks[1][key])


@pytest.mark.parametrize("mode", tt.MODES)
def test_manifest_lists_whole_leaves(runs, mode):
    """Rank 0 alone writes, and the manifest's shapes are the whole
    leaves' (the moments' those of their parameters)."""
    whole = {k.replace(".", "/"): v.shape for k, v in runs["whole"].items()}
    for d, step, prefixes in ((f"repro_{mode}", 1, ("params/",)),
                              (f"step_{mode}", 2, ("params/", "opt/m/",
                                                   "opt/v/"))):
        path = runs["dir"] / d / f"step_{step:08d}"
        with open(path / "manifest.json") as f:
            entries = json.load(f)["leaves"]
        files = sorted(os.listdir(path))
        assert files == sorted(["manifest.json"] + [e["file"]
                                                    for e in entries])
        got = {e["name"]: tuple(e["shape"]) for e in entries}
        for pre in prefixes:
            for name, shape in whole.items():
                assert got[pre + name] == shape, (pre, name)


@pytest.mark.parametrize("mode", tt.MODES)
def test_save_gathers_what_the_ranks_held(runs, mode):
    """The whole leaves restored at world 1, without a mesh, sliced as each
    rank of (1, 2) holds them, are what that rank saved: the parameters
    after one step and both AdamW moments, bit for bit."""
    one = runs["restore", 1, 0]
    pre = f"{mode}/1x1/"
    names = [k[len(pre):] for k in one.files if k.startswith(pre)]
    assert any(n.startswith("opt/m/") for n in names)
    for r in range(2):
        saved = runs["save", 2, r]
        for n in names:
            param = n.split("/", 2)[-1] if n.startswith("opt/") else \
                n.split("/", 1)[1]
            want = _own(one[pre + n], param.replace("/", "."), tt.SAVE_MESH,
                        r, mode) if n != "opt/count" else one[pre + n]
            np.testing.assert_array_equal(saved[f"{mode}/saved/{n}"], want,
                                          err_msg=n)


@pytest.mark.parametrize("shape", RESTORED, ids=map(tt.tag, RESTORED))
@pytest.mark.parametrize("mode", tt.MODES)
def test_restore_onto_another_mesh(runs, mode, shape):
    """A checkpoint saved on (1, 2) restores on (1, 4) and (2, 2): every
    rank's leaves are its slices of the whole leaves, exactly."""
    one = runs["restore", 1, 0]
    pre = f"{mode}/1x1/"
    t = tt.tag(shape)
    for r in range(int(np.prod(shape))):
        res = runs["restore", 4, r]
        for k in one.files:
            if not k.startswith(pre):
                continue
            n = k[len(pre):]
            param = n.split("/", 2)[-1] if n.startswith("opt/") else \
                n.split("/", 1)[1]
            want = one[k] if n == "opt/count" else _own(
                one[k], param.replace("/", "."), shape, r, mode)
            np.testing.assert_array_equal(res[f"{mode}/{t}/{n}"], want,
                                          err_msg=n)


@pytest.mark.parametrize("mode", tt.MODES)
def test_jax_restores_what_the_port_saved_on_a_mesh(runs, mode):
    """The JAX package's ``CheckpointManager.restore`` of the (1, 2) mesh's
    checkpoint gives the whole parameters the ranks were loaded with."""
    whole = runs["whole"]
    like = {"params": _jax_tree({k: jax.numpy.zeros(v.shape, v.dtype)
                                 for k, v in whole.items()})}
    got, step = JaxCheckpoint(str(runs["dir"] / f"repro_{mode}")).restore(
        like)
    assert step == 1
    flat = flatten(jax.tree.map(np.asarray, got["params"]))
    assert set(flat) == set(whole)
    for k, v in whole.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)


@pytest.mark.parametrize("mode", tt.MODES)
def test_port_restores_on_a_mesh_what_jax_saved(runs, mode):
    """Each rank of (1, 2) restores the JAX package's checkpoint of the
    whole parameters as its own slices."""
    whole = runs["whole"]
    for r in range(2):
        res = runs["save", 2, r]
        for k, v in whole.items():
            np.testing.assert_array_equal(
                res[f"{mode}/from_jax/params/{k.replace('.', '/')}"],
                _own(v, k, tt.SAVE_MESH, r, mode), err_msg=k)


@pytest.mark.parametrize("mode", tt.MODES)
def test_save_on_a_mesh_without_the_model_raises(runs, mode):
    """On (1, 2), ``save`` without the model (each rank would write the
    slices it holds under the whole leaves' names, the last writer
    winning) raises on every rank and writes nothing."""
    for r in range(2):
        res = runs["save", 2, r]
        assert f"{mode}/bare_save" in res.files
        assert "pass the model on a mesh" in str(res[f"{mode}/bare_save"])
        assert len(res[f"{mode}/bare_save_wrote"]) == 0


def test_save_without_a_mesh_is_unchanged(tmp_path):
    """Off a mesh, ``save`` and ``restore`` take no model and write the
    leaves as they are."""
    from repro_torch.runtime import CheckpointManager
    model = Model(get_smoke(ARCH), device="cpu").init(
        torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    CheckpointManager(str(tmp_path)).save(3, {"params": params},
                                          model=model)
    back = {"params": {k: torch.zeros_like(v) for k, v in params.items()}}
    _, step = CheckpointManager(str(tmp_path)).restore(back)
    assert step == 3
    for k, v in params.items():
        assert torch.equal(back["params"][k], v.detach()), k


@pytest.mark.parametrize("layout", tt.LAYOUTS)
def test_layout_state_restores_whole_as_the_ranks_held_it(runs, layout):
    """A state of the fsdp layout saved on (2, 2), and one with ZeRO-1
    moments saved on (2, 1), restored without a mesh: each saving rank's
    parameters and both moments are its parts of the whole leaves (the
    fsdp spec; ZeRO-1's moments their ``zero1_spec``), bit for bit."""
    whole = _layout_flat(runs["restore", 1, 0], layout)
    assert any(n.startswith("opt/m/") for n in whole)
    shape = tt.LAYOUT_SAVE[layout]
    pre = f"layout/{layout}/saved/"
    for r in range(int(np.prod(shape))):
        saved = runs["save", int(np.prod(shape)), r]
        names = [k[len(pre):] for k in saved.files if k.startswith(pre)]
        assert set(names) == set(whole)
        for n in names:
            np.testing.assert_array_equal(
                saved[pre + n], _layout_own(whole[n], n, shape, r, layout),
                err_msg=n)


@pytest.mark.parametrize("target", tt.LAYOUTS)
@pytest.mark.parametrize("layout", tt.LAYOUTS)
def test_layout_state_restores_in_another_layout(runs, layout, target):
    """Each saved state restored on (1, 4) in each layout, fsdp or ZeRO-1
    in "tp": every rank's leaves are its parts of the whole leaves in the
    target layout, exactly."""
    whole = _layout_flat(runs["restore", 1, 0], layout)
    shape = tt.LAYOUT_RESTORE
    pre = f"layout/{layout}/{target}/"
    for r in range(int(np.prod(shape))):
        res = runs["restore", int(np.prod(shape)), r]
        for n, w in whole.items():
            np.testing.assert_array_equal(
                res[pre + n], _layout_own(w, n, shape, r, target),
                err_msg=n)


@pytest.mark.parametrize("layout", tt.LAYOUTS)
def test_jax_restores_the_layout_state(runs, layout):
    """The JAX package's ``CheckpointManager.restore`` of each layout's
    checkpoint gives the whole state: parameters, both moments and the
    count."""
    whole = _layout_flat(runs["restore", 1, 0], layout)
    like = _jax_tree({k: jax.numpy.zeros(v.shape, v.dtype)
                      for k, v in whole.items()}, "/")
    got, step = JaxCheckpoint(str(runs["dir"] / f"layout_{layout}")
                              ).restore(like)
    assert step == 2
    flat = {"/".join(str(p.key) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(got)}
    assert set(flat) == set(whole)
    for k, v in whole.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)


@pytest.mark.parametrize("layout", tt.LAYOUTS)
def test_port_restores_the_jax_saved_state_in_the_layout(runs, layout):
    """The JAX package's save of a whole state restored on the layout's
    mesh (fsdp on (2, 2), ZeRO-1 on (2, 1)): every rank holds its parts."""
    whole = _layout_flat(runs["restore", 1, 0], layout)
    shape = tt.LAYOUT_SAVE[layout]
    pre = f"layout/{layout}/from_jax/"
    for r in range(int(np.prod(shape))):
        res = runs["jax", int(np.prod(shape)), r]
        for n, w in whole.items():
            np.testing.assert_array_equal(
                res[pre + n], _layout_own(w, n, shape, r, layout),
                err_msg=n)
