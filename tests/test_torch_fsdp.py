"""The fsdp (ZeRO-3) layout on torch.distributed (gloo, the CPU) against the
JAX package: every leaf sliced over the whole mesh (``fsdp_spec``), each
layer's leaves gathered whole inside its remat unit and their gradients
reduce-scattered, the batch's rows over every axis, the AdamW moments the
parameters' slices.  f32 smoke configs of deepseek-7b, llama4-scout (at a
capacity factor that drops nothing; with 16 tokens the all-to-all path,
with 15 the all-reduce path with the rows gathered over "model", with 2
experts on (1, 4) the dense dispatch on each rank's rows),
mamba2-780m (with 8 layers, whose A_log, D and dt_bias the rule splits on
the layer dim; with 3 layers of 2 heads, whose A_log, D and dt_bias stay
whole on 4 ranks) and whisper-medium, on meshes (1, 2), (2, 1), (1, 4) and
(2, 2) of (data, model).

The ``runs`` fixture runs everything once: the port at world 1 (one process
without a mesh, and a (1, 1) mesh), 2 and 4 (``_torch_fsdp.worker``, one
spawned process a rank, each world's cases in one spawn) beside the JAX
reference in a subprocess with 4 forced host devices.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_fsdp as tf  # noqa: E402

from repro_torch.launch.mesh import MeshSpec  # noqa: E402
from repro_torch.launch.shardings import carried  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# f32 on both sides.  The ranks' gradients are summed by the gathers'
# reduce-scatters in another order than one process's sums over the rows:
# the losses and every gradient leaf are held to one process's at 1e-5
# (tests/_torch_tp_cases.py's TP_REL), to JAX's GSPMD fsdp step at the
# repo's port-vs-JAX gradient tolerance; v, quadratic in the gradient, at
# twice the gradient's
LOSS_REL = 1e-5
FSDP_REL = 1e-5
JAX_GRAD_REL = 1e-4
KIND = "fsdp"
ARCHS = tf.ARCHS[KIND]


def pytest_generate_tests(metafunc):
    for name, values in (("arch", ARCHS), ("gspmd_arch", tf.GSPMD),
                         ("served_arch", tf.SERVED)):
        if name in metafunc.fixturenames:
            metafunc.parametrize(name, values)
    for name, values in (("shape", tf.ALL_MESHES),
                         ("serve_shape", tf.SERVE_MESHES)):
        if name in metafunc.fixturenames:
            metafunc.parametrize(name, values, ids=map(tf.tag, values))


def spawn_runs(kind: str, worlds, d) -> dict:
    """The kind's worlds and the JAX reference, run side by side; {"jax",
    "inputs", (world, rank): the npz each wrote}."""
    inputs = str(d / "inputs.npz")
    tf.make_inputs(inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", "import _torch_fsdp; _torch_fsdp."
         f"jax_reference({inputs!r}, {str(d / 'jax.npz')!r}, {kind!r})"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs = [torch.multiprocessing.start_processes(
        tf.worker, args=(w, str(d / f"store{w}"), inputs, str(d), kind),
        nprocs=w, join=False, start_method="spawn") for w in worlds]
    try:
        for ctx in procs:
            while not ctx.join(timeout=300):
                pass
        _, err = jax_proc.communicate(timeout=300)
        assert jax_proc.returncode == 0, err[-3000:]
    finally:
        jax_proc.kill()
    out = {"jax": np.load(d / "jax.npz"), "inputs": np.load(inputs)}
    for w in worlds:
        for r in range(w):
            out[w, r] = np.load(d / f"{kind}_w{w}rank{r}.npz")
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return spawn_runs(KIND, (1, 2, 4), tmp_path_factory.mktemp(KIND))


def ranks(runs, shape) -> list:
    w = int(np.prod(shape))
    return [runs[w, r] for r in range(w)]


def whole_of(runs, arch: str) -> dict:
    pre = f"{arch}/state/"
    inp = runs["inputs"]
    return {k[len(pre):]: inp[k] for k in inp.files if k.startswith(pre)}


def region(index: np.ndarray) -> tuple:
    return tuple(slice(int(a), int(b)) for a, b in index)


def assemble(runs, shape, key: str, index_key: str, name: str,
             whole_shape) -> np.ndarray:
    """The whole leaf from every rank's part ``key/name``, each put where
    JAX's index ``index_key/name/<rank>`` says; the ranks that hold the
    same part must hold it alike, bit for bit."""
    out = np.full(whole_shape, np.nan, np.float64)
    for r, res in enumerate(ranks(runs, shape)):
        part = res[f"{key}/{name}"]
        reg = region(runs["jax"][f"{index_key}/{name}/{r}"])
        have = out[reg]
        assert part.shape == have.shape, (name, part.shape, have.shape)
        seen = ~np.isnan(have)
        np.testing.assert_array_equal(have[seen], part[seen], err_msg=name)
        out[reg] = part
    assert not np.isnan(out).any(), name
    return out


def leaf_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / (np.linalg.norm(want) + 1e-30))


def test_each_rank_holds_the_jax_fsdp_shard(runs, arch, shape):
    """Each rank's leaf is, for every leaf, the slice that JAX's
    ``param_shardings(..., "fsdp")`` puts on the device at the same mesh
    position (``devices_indices_map``), bit for bit and contiguous;
    ``Model.sharded`` names the leaves the rule splits, with their spec."""
    t = f"{tf.tag(shape)}/{arch}"
    spec = MeshSpec(tf.AXES, shape)
    whole = whole_of(runs, arch)
    split = {n for n, v in whole.items() if carried(n, v.shape, spec, "fsdp")}
    for r, res in enumerate(ranks(runs, shape)):
        assert set(res[f"{t}/sharded"]) == split
        for name, full in whole.items():
            got = res[f"{t}/slice/{name}"]
            want = full[region(runs["jax"][f"{t}/idx/{name}/{r}"])]
            assert got.flags["C_CONTIGUOUS"]
            np.testing.assert_array_equal(got, want, err_msg=name)
    if arch == "mamba2-780m-3x2-heads":
        # (3, 2): split over 2 ranks on dim 1, whole on 4
        assert ("layers.A_log" in split) == (spec.size == 2)
    if arch == "mamba2-780m-8-layers":
        # (8, 8): the layers split, ties going to the first dim
        assert runs["jax"][f"{t}/idx/layers.A_log/1"][0, 0] == 8 // spec.size


def test_moments_are_the_parameters_slices(runs, arch, shape):
    """Both AdamW moments after step 1 are held as their parameter is:
    each rank's part is where JAX's fsdp index puts the parameter's, the
    ranks that share a part hold it alike, and the whole moments are one
    process's (m within FSDP_REL, v within twice that)."""
    t = f"{tf.tag(shape)}/{arch}"
    one = runs[1, 0]
    for name, full in whole_of(runs, arch).items():
        for k, rel in (("m1", FSDP_REL), ("v1", 2 * FSDP_REL)):
            got = assemble(runs, shape, f"{t}/train/{k}", f"{t}/idx", name,
                           full.shape)
            assert leaf_rel(got, one[f"one/{arch}/train/{k}/{name}"]) \
                < rel, (k, name)


def test_loss_and_gradients_match_one_process(runs, arch, shape):
    """``make_train_step``'s step-1 loss against one process's (LOSS_REL),
    and every gradient leaf as AdamW receives it, each rank's part put
    where JAX's index says, against one process's within FSDP_REL: the
    reduce-scatters' sums divided by the mesh's size give one process's
    gradient, not a multiple of it (a router or tied embedding counted
    twice, or an aux gradient scaled twice, would miss by 2x or more)."""
    t = f"{tf.tag(shape)}/{arch}"
    one = runs[1, 0]
    want = float(one[f"one/{arch}/train/loss"][0])
    for res in ranks(runs, shape):
        assert abs(float(res[f"{t}/train/loss"][0]) - want) <= \
            LOSS_REL * abs(want)
    for name, full in whole_of(runs, arch).items():
        got = assemble(runs, shape, f"{t}/train/grad", f"{t}/idx", name,
                       full.shape)
        assert leaf_rel(got, one[f"one/{arch}/train/grad/{name}"]) < \
            FSDP_REL, name


def test_gradients_match_jax_gspmd_fsdp(runs, gspmd_arch, shape):
    """JAX's own fsdp step (GSPMD, ``set_sharding_mode("fsdp")``,
    ``in_shardings`` from ``param_shardings`` and ``batch_shardings`` in
    "fsdp" mode) gives the unsharded loss and gradients; the port's ranks'
    loss and assembled gradients hold to it within LOSS_REL and
    JAX_GRAD_REL."""
    arch, jx = gspmd_arch, runs["jax"]
    t = f"{tf.tag(shape)}/{arch}"
    want = float(jx[f"{t}/gspmd/loss"])
    assert abs(want - float(jx[f"{arch}/jax/loss"])) <= 1e-6 * abs(want)
    for res in ranks(runs, shape):
        assert abs(float(res[f"{t}/train/loss"][0]) - want) <= \
            LOSS_REL * abs(want)
    for name, full in whole_of(runs, arch).items():
        got = assemble(runs, shape, f"{t}/train/grad", f"{t}/idx", name,
                       full.shape)
        assert leaf_rel(got, jx[f"{t}/gspmd/grad/{name}"]) < \
            JAX_GRAD_REL, name


def test_three_steps_match_one_process(runs, arch, shape):
    """3 steps, remat "full" (each layer gathers again in the recompute):
    every rank's losses and grad norms (the clip's, summed over every axis
    of each leaf's spec) those of one process, and its parameters after
    them the slices of one process's."""
    t = f"{tf.tag(shape)}/{arch}"
    one = runs[1, 0]
    for res in ranks(runs, shape):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(res[f"{t}/train/{k}"],
                                       one[f"one/{arch}/train/{k}"],
                                       rtol=FSDP_REL, err_msg=k)
    for name, full in whole_of(runs, arch).items():
        got = assemble(runs, shape, f"{t}/train/param", f"{t}/idx", name,
                       full.shape)
        want = one[f"one/{arch}/train/param/{name}"]
        assert leaf_rel(got, want) < FSDP_REL, name


def test_world_one_is_one_process_bit_for_bit(runs, arch):
    """On a (1, 1) mesh every gather and reduce-scatter is a copy and the
    division by the mesh's size changes no bit: the 3 losses and grad
    norms, every step-1 gradient, both moments and the parameters are one
    process's to the bit (the card's phase 10 holds the same)."""
    res = runs[1, 0]
    keys = [k for k in res.files if k.startswith(f"one/{arch}/train/")]
    assert any("/grad/" in k for k in keys)
    for k in keys:
        np.testing.assert_array_equal(res[k.replace("one/", "1x1/", 1)],
                                      res[k], err_msg=k)


def test_served_tokens_match_one_process(runs, served_arch, serve_shape):
    """Prefill and decode in "fsdp" mode, every layer gathered at its use,
    the engine's rows alike on every rank (``ServingEngine``; whisper
    through ``launch/serve.generate``): every rank's greedy tokens equal
    one process's."""
    want = runs[1, 0][f"one/{served_arch}/serve"]
    assert want.shape[1] == tf.tt.MAX_NEW
    for res in ranks(runs, serve_shape):
        np.testing.assert_array_equal(
            res[f"{tf.tag(serve_shape)}/{served_arch}/serve"], want)


def test_a_batch_smaller_than_the_mesh_raises(runs, shape):
    """A batch of half as many rows as the mesh has ranks: the fsdp
    ``batch_shardings`` puts its rows over "data" and its sequence over
    "model", as every rank's ``split_batch`` read it (every mesh here but
    (2, 1), where no prefix of the axes divides one row and the rules
    replicate it: the batch stays whole on every rank).  Every family
    carries the split out there (tests/test_torch_seq_split.py,
    tests/test_torch_seq_split_families.py)."""
    from repro_torch.launch.shardings import batch_shardings
    t = tf.tag(shape)
    spec = batch_shardings({"t": (tf.small_rows(shape), 16)},
                           MeshSpec(tf.AXES, shape), "fsdp")["t"]
    assert (spec == ()) == (shape == (2, 1)), spec
    for res in ranks(runs, shape):
        rows = tuple(res[f"{t}/small_rows"])
        seq = tuple(res[f"{t}/small_seq"])
        if not spec:
            assert bool(res[f"{t}/small_whole"]) and rows == seq == ()
            continue
        assert spec[1] is not None and not bool(res[f"{t}/small_whole"])
        assert rows == ("data",) and seq == ("model",), (rows, seq)


def test_gather_part_order(runs, shape):
    """``gather_leaf`` over ("data", "model") of an (8, 3) leaf whose rows
    all differ: the parts come in ``local_slice``'s order (the first axis
    the major one), so every rank gets the whole leaf; backward, with rank
    r's cotangent (r + 1) times the leaf, each rank keeps its part of the
    sum over the ranks, (1 + ... + n) times its part of the leaf."""
    full = np.arange(24, dtype=np.float32).reshape(8, 3)
    n = int(np.prod(shape))
    part = 8 // n
    for r, res in enumerate(ranks(runs, shape)):
        np.testing.assert_array_equal(res[f"{tf.tag(shape)}/order/whole"],
                                      full)
        np.testing.assert_array_equal(
            res[f"{tf.tag(shape)}/order/grad"],
            full[r * part:(r + 1) * part] * (n * (n + 1) // 2))


def test_a_one_row_cotangent_passes_the_kernels_checks():
    """With the rows over every axis a rank may hold one row: the
    cotangent flash's backward gets from the output projection's einsum
    then carries the stride 1 on its batch dim of extent 1, which PyTorch
    calls contiguous; ``dense_strides`` gives it a contiguous tensor's
    strides, the same elements, so the bf16 kernels' checks take it."""
    from repro_torch.kernels._layout import dense_strides
    from repro_torch.kernels.flash_attention.ops import _check_cuda_inputs
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 16, 4, 64), generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    out = q.clone().requires_grad_(True)
    wo = torch.randn((4, 64, 32), generator=gen).to(torch.bfloat16)
    torch.einsum("bshk,hkd->bsd", out, wo).sum().backward()
    do = out.grad.contiguous()
    assert do.is_contiguous() and do.stride(0) % 8
    with pytest.raises(ValueError, match="16-byte"):
        _check_cuda_inputs(q, k, v, do)
    fixed = dense_strides(do)
    assert fixed.stride() == (16 * 4 * 64, 4 * 64, 64, 1)
    assert fixed.data_ptr() == do.data_ptr() and torch.equal(fixed, do)
    _check_cuda_inputs(q, k, v, fixed)
