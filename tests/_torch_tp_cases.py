"""The tensor-parallel cases that tests/test_torch_tensor_parallel.py and
tests/test_torch_tensor_parallel_families.py share: each imports them
(``from _torch_tp_cases import *``) beside its own ``ARCHS``, and
``pytest_generate_tests`` takes the archs from the importing module, so that
each file's cases run in one set of spawns of their own and the two files
run side by side.

The ``runs`` fixture runs everything once a file: the port at world 1 (one
process, no mesh), 2 and 4 (``_torch_tp.worker``, one spawned process a
rank, each world's cases in one spawn) beside the JAX reference in a
subprocess with 4 forced host devices.  The tests read what they wrote.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_tp as tt

from repro_torch.launch.mesh import MeshSpec
from repro_torch.launch.shardings import carried, local_slice, param_spec

ROOT = Path(__file__).resolve().parents[1]
# f32 on both sides.  Tensor parallelism adds sums over "model" in another
# order than one process's: the losses and every gradient slice are held to
# one process's at 1e-5 (observed <= 3.7e-6 for a leaf), and to JAX's at the
# repo's port-vs-JAX gradient tolerance (tests/test_torch_train.py): the
# port already differs from JAX by 1.1e-5 in one process on mamba2's A_log
LOSS_REL = 1e-5
TP_REL = 1e-5
JAX_GRAD_REL = 1e-4


def pytest_generate_tests(metafunc):
    archs = metafunc.module.ARCHS
    for name, values in (("arch", archs),
                         ("served_arch", [a for a in archs
                                          if a in tt.SERVED])):
        if name in metafunc.fixturenames:
            metafunc.parametrize(name, values)
    for name, values in (("shape", tt.ALL_MESHES),
                         ("serve_shape", tt.SERVE_MESHES)):
        if name in metafunc.fixturenames:
            metafunc.parametrize(name, values, ids=map(tt.tag, values))


def leaf_rel(got, want, whole) -> float:
    """||got - want|| over the norm of the whole leaf ``want`` is part of."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / (np.linalg.norm(np.asarray(whole, np.float64)) + 1e-30))


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    """{"jax": its npz, "inputs": ..., (world, rank): the rank's npz}."""
    archs = tuple(request.module.ARCHS)
    d = tmp_path_factory.mktemp("tensor_parallel")
    inputs = str(d / "inputs.npz")
    tt.make_inputs(inputs, archs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", "import _torch_tp; _torch_tp.jax_reference("
         f"{inputs!r}, {str(d / 'jax.npz')!r}, {archs!r})"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs = [torch.multiprocessing.start_processes(
        tt.worker, args=(w, str(d / f"store{w}"), inputs, str(d), archs),
        nprocs=w, join=False, start_method="spawn") for w in (1, 2, 4)]
    try:
        for ctx in procs:
            while not ctx.join(timeout=300):
                pass
        _, err = jax_proc.communicate(timeout=300)
        assert jax_proc.returncode == 0, err[-3000:]
    finally:
        jax_proc.kill()
    out = {"jax": np.load(d / "jax.npz"), "inputs": np.load(inputs)}
    for w in (1, 2, 4):
        for r in range(w):
            out[w, r] = np.load(d / f"w{w}rank{r}.npz")
    return out


def ranks(runs, shape) -> list:
    w = int(np.prod(shape))
    return [runs[w, r] for r in range(w)]


def own(whole: np.ndarray, name: str, shape, r: int) -> np.ndarray:
    """The slice of ``whole`` that the port's rules give the rank at ``r``
    of a mesh of ``shape`` in "tp" mode."""
    spec = MeshSpec(tt.AXES, shape)
    coord = dict(zip(tt.AXES, map(int, np.unravel_index(r, shape))))
    return local_slice(torch.tensor(whole), param_spec(name, whole.shape,
                                                       spec),
                       spec, coord).numpy()


def grad_names(res, key: str) -> list:
    pre = f"{key}/train/grad/"
    return [k[len(pre):] for k in res.files if k.startswith(pre)]


def test_each_rank_holds_the_jax_slice_of_every_leaf(runs, arch, shape):
    """(i) In "tp" mode each rank's leaf is, for every leaf, the numpy
    slice that JAX's ``NamedSharding(mesh, param_shardings(..., "tp")
    spec).devices_indices_map`` gives the device at the same mesh position
    (a contiguous copy); ``Model.sharded`` names the leaves whose spec
    splits over "model", and no other leaf is a slice."""
    t = f"{tt.tag(shape)}/{arch}"
    state = {k.split("/state/", 1)[1]: runs["inputs"][k]
             for k in runs["inputs"].files
             if k.startswith(f"{arch}/state/")}
    spec = MeshSpec(tt.AXES, shape)
    split = {n for n, v in state.items() if carried(n, v.shape, spec)}
    assert split and split != set(state)
    for r, res in enumerate(ranks(runs, shape)):
        assert set(res[f"{t}/sharded"]) == split
        for name, whole in state.items():
            got = res[f"{t}/slice/{name}"]
            want = runs["jax"][f"{t}/slice/{name}/{r}"]
            assert got.shape == want.shape, name
            assert got.flags["C_CONTIGUOUS"]
            np.testing.assert_array_equal(got, want, err_msg=name)
            assert (got.shape != whole.shape) == (name in split
                                                  and shape[1] > 1)


def test_loss_and_gradient_slices_match_jax(runs, arch, shape):
    """(ii) ``make_train_step``'s step-1 loss against JAX's
    ``value_and_grad`` of ``train_loss`` on the whole batch (rel LOSS_REL),
    and each rank's slice of every gradient, as AdamW receives it (averaged
    over the data axes only), against the same slice of JAX's (JAX_GRAD_REL)
    and of one process's (TP_REL), each over its whole leaf's norm."""
    t = f"{tt.tag(shape)}/{arch}"
    jx, one = runs["jax"], runs[1, 0]
    want_loss = float(jx[f"{arch}/jax/loss"])
    for r, res in enumerate(ranks(runs, shape)):
        got = float(res[f"{t}/train/loss"][0])
        assert abs(got - want_loss) <= LOSS_REL * abs(want_loss)
        names = grad_names(res, t)
        assert set(names) == set(grad_names(one, f"one/{arch}"))
        for n in names:
            g = res[f"{t}/train/grad/{n}"]
            jg = jx[f"{arch}/jax/grad/{n}"]
            og = one[f"one/{arch}/train/grad/{n}"]
            assert leaf_rel(g, own(jg, n, shape, r), jg) < JAX_GRAD_REL, n
            assert leaf_rel(g, own(og, n, shape, r), og) < TP_REL, n


def test_replicated_gradients_are_alike_on_every_rank(runs, arch, shape):
    """(iii) The gradient of every leaf that stays whole (the norms, the
    router, mamba's A_log, D and dt_bias, whisper's enc_pos) is the same on
    every rank of "model", bit for bit, with no reduction over "model"
    after the backward: a missing "f" would leave each rank its own share.
    The slices of a split leaf are alike over the data axes."""
    t = f"{tt.tag(shape)}/{arch}"
    res = ranks(runs, shape)
    spec = MeshSpec(tt.AXES, shape)
    nb, nm = shape
    names = grad_names(res[0], t)
    whole = [n for n in names if not carried(
        n, runs["jax"][f"{arch}/jax/grad/{n}"].shape, spec)]
    assert whole
    for n in names:
        for r in range(nb * nm):
            base = 0 if n in whole else r % nm
            np.testing.assert_array_equal(res[r][f"{t}/train/grad/{n}"],
                                          res[base][f"{t}/train/grad/{n}"],
                                          err_msg=n)


def test_three_steps_match_one_process(runs, arch, shape):
    """(iv) 3 ``make_train_step`` steps, remat "full" (each layer's
    collectives run again in the recompute): every rank's losses and grad
    norms (the clip's, summed over the slices) those of one process."""
    t = f"{tt.tag(shape)}/{arch}"
    one = runs[1, 0]
    for res in ranks(runs, shape):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(res[f"{t}/train/{k}"],
                                       one[f"one/{arch}/train/{k}"],
                                       rtol=TP_REL, err_msg=k)


def test_served_tokens_match_one_process(runs, served_arch, serve_shape):
    """(v) Prefill and decode on the rank's heads and vocabulary slice
    (``ServingEngine``; whisper through ``launch/serve.generate``): every
    rank's greedy tokens, from ``Model.greedy`` over the gathered slices,
    equal one process's."""
    want = runs[1, 0][f"one/{served_arch}/serve"]
    assert want.shape[1] == tt.MAX_NEW
    for res in ranks(runs, serve_shape):
        np.testing.assert_array_equal(
            res[f"{tt.tag(serve_shape)}/{served_arch}/serve"], want)


def test_a_built_model_keeps_its_mode(runs, arch, shape):
    """A model built in "tp" runs in "tp" after ``set_sharding_mode`` names
    "fsdp": its methods install the mode it was built in, which the layers
    read, so every rank's loss is the same, bit for bit, before and after
    the switch.  Layers reading the switched mode would take the rank's
    "tp" slices for "fsdp" ones, gathering them over the whole mesh along
    other dims (ZeRO-3), and skip their "g" on the rank's heads and hidden
    slice."""
    t = f"{tt.tag(shape)}/{arch}"
    for res in ranks(runs, shape):
        built, switched = res[f"{t}/switched"]
        assert switched == built
