"""The sequence split of an "fsdp" batch smaller than the mesh on
torch.distributed (gloo, the CPU) against one process and the JAX
package's GSPMD fsdp steps: ``small_rows(shape)`` rows of 16 tokens on
(1, 2), (1, 4) and (2, 2) of (data, model), the rows over "data" and the
sequence over "model", so each rank holds one contiguous slice of its
rows.  f32 smoke configs of deepseek-7b, gemma3-27b (a window of 8 that
reaches across the ranks' boundaries), mamba2-780m and zamba2-2.7b: their
attention gathers the keys and values over the sequence's axes and their
mamba layers take the conv's halo and the state the earlier slices leave.
The MoE's prefill on a batch that divides the mesh, its rows over every
axis, holds to one process.  The MoE, whisper and llava under the split,
and deepseek-7b on three axes: tests/test_torch_seq_split_families.py.

The ``runs`` fixture runs everything once: one process on 1 and 2 rows at
world 1, every mesh of world 2 and 4 (``_torch_seq.worker``, one spawned
process a rank), beside the JAX reference in a subprocess with 4 forced
host devices.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_seq as ts  # noqa: E402

from repro_torch.launch.mesh import MeshSpec  # noqa: E402
from repro_torch.launch.shardings import (batch_shardings,  # noqa: E402
                                          fsdp_spec, local_slice,
                                          split_axes)
from repro_torch.models.common import seq_rank  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# f32 on both sides: the ranks' shares of each gradient are summed by the
# gathers' reduce-scatters in another order than one process's sums over
# the sequence, and the state pass adds the earlier slices' state by a
# fold instead of chunk by chunk: held to one process at 1e-5
# (tests/test_torch_fsdp.py's FSDP_REL), to JAX's GSPMD steps at the repo's
# port-vs-JAX gradient tolerance
ONE_REL = 1e-5
JAX_REL = 1e-4


def pytest_generate_tests(metafunc):
    for name, values in (("arch", ts.ARCHS),):
        if name in metafunc.fixturenames:
            metafunc.parametrize(name, values)
    for name, shapes in (("shape", ts.ALL_MESHES),
                         ("moe_shape", ts.MOE_MESHES)):
        if name in metafunc.fixturenames:
            metafunc.parametrize(name, shapes, ids=map(ts.tag, shapes))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("seq")
    inputs = str(d / "inputs.npz")
    ts.make_inputs(inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", "import _torch_seq; _torch_seq."
         f"jax_reference({inputs!r}, {str(d / 'jax.npz')!r})"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    worlds = (1, 2, 4)
    procs = [torch.multiprocessing.start_processes(
        ts.worker, args=(w, str(d / f"store{w}"), inputs, str(d)),
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
            out[w, r] = np.load(d / f"seq_w{w}rank{r}.npz")
    return out


def ranks(runs, shape) -> list:
    w = int(np.prod(shape))
    return [runs[w, r] for r in range(w)]


def coord_of(shape, rank: int) -> dict:
    return dict(zip(ts.AXES, map(int, np.unravel_index(rank, shape))))


def whole_of(runs, arch: str) -> dict:
    pre = f"{arch}/state/"
    inp = runs["inputs"]
    return {k[len(pre):]: inp[k] for k in inp.files if k.startswith(pre)}


def leaf_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / (np.linalg.norm(want) + 1e-30))


def assemble(runs, shape, key: str, name: str, whole_shape) -> np.ndarray:
    """The whole leaf from every rank's part ``key/name``, each put where
    ``fsdp_spec`` and ``local_slice`` cut it; the ranks that hold the same
    part must hold it alike, bit for bit."""
    spec = MeshSpec(ts.AXES, shape)
    cut = fsdp_spec(name, whole_shape, spec)
    ids = torch.arange(int(np.prod(whole_shape))).reshape(whole_shape)
    out = np.full(int(np.prod(whole_shape)), np.nan)
    for r, res in enumerate(ranks(runs, shape)):
        sel = local_slice(ids, cut, spec, coord_of(shape, r)).numpy().ravel()
        part = res[f"{key}/{name}"].ravel()
        seen = ~np.isnan(out[sel])
        np.testing.assert_array_equal(out[sel][seen], part[seen],
                                      err_msg=name)
        out[sel] = part
    assert not np.isnan(out).any(), name
    return out.reshape(whole_shape)


def rows_of(shape, rank: int, whole: np.ndarray, dim: int,
            rows: int | None = None) -> np.ndarray:
    """The rank's rows of ``whole`` along ``dim`` (its batch dim), as
    ``batch_shardings`` puts a batch of ``rows`` rows (the small batch's
    by default)."""
    spec = MeshSpec(ts.AXES, shape)
    rows = ts.small_rows(shape) if rows is None else rows
    entry = batch_shardings({"t": (rows, ts.SEQ)}, spec, "fsdp")["t"][0]
    cut = tuple(entry if d == dim else None for d in range(whole.ndim))
    return local_slice(torch.tensor(whole), cut, spec,
                       coord_of(shape, rank)).numpy()


def batch_dim(arch: str, key: str) -> int:
    """The batch dim of a prefill output (``lm.py``'s cache layouts)."""
    if key in ("tokens", "pos"):
        return 0
    return 2 if arch.startswith("zamba2") and key in ("conv", "ssm") else 1


@pytest.mark.parametrize("sizes,rows", [((2, 2, 2), 2), ((1, 2, 2), 1),
                                        ((1, 2, 4), 1), ((2, 4, 2), 2)])
def test_rank_order_on_three_axes(sizes, rows):
    """Without processes, on a (pod, data, model) ``MeshSpec``: the axes
    that split a small batch's sequence (``split_axes`` of
    ``batch_shardings`` of the whole batch) and, at every coordinate,
    ``seq_rank``'s index of the rank's slice, the first axis the major one:
    the slice ``local_slice`` (``shard_batch``'s cut) gives that rank is
    the index-th of ``count``, so ``gather_leaf`` joins the slices in
    sequence order."""
    spec = MeshSpec(("pod", "data", "model"), sizes)
    seq = 16
    whole = {"tokens": torch.arange(rows * seq).reshape(rows, seq)}
    cut = batch_shardings(whole, spec, "fsdp")["tokens"]
    rows_ax, axes, whole_leaves = split_axes({"tokens": cut}, spec)
    assert axes and set(axes) == set(
        cut[1] if isinstance(cut[1], tuple) else (cut[1],))
    assert rows_ax + axes == spec.axis_names and whole_leaves == ()
    assert split_axes(batch_shardings(whole, spec, "tp"), spec)[1:] == \
        ((), ())
    seen = set()
    for pos in np.ndindex(*sizes):
        coord = dict(zip(spec.axis_names, map(int, pos)))
        index, count = seq_rank(spec, axes, coord)
        assert count == int(np.prod([spec.shape[a] for a in axes]))
        part = local_slice(whole["tokens"], cut, spec, coord)
        size = seq // count
        assert torch.equal(part[0], torch.arange(
            index * size, (index + 1) * size) + part[0, 0] // seq * seq)
        seen.add((part[0, 0].item() // seq, index))
    assert len(seen) == rows * count


def test_the_sequence_goes_over_model(runs, arch, shape):
    """Every small batch here keeps its rows over "data" and puts its
    sequence over "model" (``split_batch``, as each rank read it)."""
    for res in ranks(runs, shape):
        assert tuple(res[f"{ts.tag(shape)}/{arch}/rows"]) == ("data",)
        assert tuple(res[f"{ts.tag(shape)}/{arch}/seq"]) == ("model",)


def test_loss_and_gradients_match_one_process(runs, arch, shape):
    """``make_train_step``'s step-1 loss on every rank (the mean of the
    ranks' means over their equal shares of the tokens, summed and divided
    by the mesh's size) against one process's on the same rows (ONE_REL),
    and every gradient leaf as AdamW receives it, assembled from the
    ranks' parts, against one process's within ONE_REL: the keys' and the
    states' gradients reach the ranks whose tokens they come from."""
    t, rows = f"{ts.tag(shape)}/{arch}", ts.small_rows(shape)
    one = runs[1, 0]
    want = float(one[f"one{rows}/{arch}/loss"][0])
    for res in ranks(runs, shape):
        assert abs(float(res[f"{t}/loss"][0]) - want) <= ONE_REL * abs(want)
    for name, full in whole_of(runs, arch).items():
        got = assemble(runs, shape, f"{t}/grad", name, full.shape)
        assert leaf_rel(got, one[f"one{rows}/{arch}/grad/{name}"]) < \
            ONE_REL, name


def test_gradients_match_jax_gspmd_fsdp(runs, arch, shape):
    """JAX's own fsdp step on the same small batch (GSPMD,
    ``set_sharding_mode("fsdp")``, ``in_shardings`` from
    ``param_shardings`` and ``batch_shardings`` in "fsdp" mode, which put
    the sequence over "model"): the ranks' loss and assembled gradients
    hold to it within ONE_REL and JAX_REL."""
    t, jx = f"{ts.tag(shape)}/{arch}", runs["jax"]
    want = float(jx[f"{t}/gspmd/loss"])
    for res in ranks(runs, shape):
        assert abs(float(res[f"{t}/loss"][0]) - want) <= ONE_REL * abs(want)
    for name, full in whole_of(runs, arch).items():
        got = assemble(runs, shape, f"{t}/grad", name, full.shape)
        assert leaf_rel(got, jx[f"{t}/gspmd/grad/{name}"]) < JAX_REL, name


def test_three_steps_match_one_process(runs, arch, shape):
    """3 steps, remat "full" (each layer gathers its leaves, the keys and
    values and the states again in the recompute): every rank's losses and
    grad norms those of one process, and its parameters after them the
    parts of one process's."""
    t, rows = f"{ts.tag(shape)}/{arch}", ts.small_rows(shape)
    one = runs[1, 0]
    for res in ranks(runs, shape):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(res[f"{t}/{k}"],
                                       one[f"one{rows}/{arch}/{k}"],
                                       rtol=ONE_REL, err_msg=k)
    for name, full in whole_of(runs, arch).items():
        got = assemble(runs, shape, f"{t}/param", name, full.shape)
        assert leaf_rel(got, one[f"one{rows}/{arch}/param/{name}"]) < \
            ONE_REL, name


def test_prefill_matches_one_process(runs, arch, shape):
    """``make_prefill_step`` on the small batch: every rank returns its
    rows' greedy tokens and a cache of the whole prompt (k/v of every
    position, the mamba states at its end, pos its length), those of one
    process on the same rows: tokens and pos equal, every other leaf
    within ONE_REL."""
    t, rows = f"{ts.tag(shape)}/{arch}", ts.small_rows(shape)
    one = runs[1, 0]
    pre = f"one{rows}/{arch}/prefill/"
    keys = [k[len(pre):] for k in one.files if k.startswith(pre)]
    assert "cache/pos" in keys and "tokens" in keys
    for r, res in enumerate(ranks(runs, shape)):
        for k in keys:
            want = rows_of(shape, r, one[pre + k],
                           batch_dim(arch, k.rsplit("/", 1)[-1]))
            got = res[f"{t}/prefill/{k}"]
            assert got.shape == want.shape, (k, got.shape, want.shape)
            if k in ("tokens", "cache/pos"):
                np.testing.assert_array_equal(got, want, err_msg=k)
            else:
                assert leaf_rel(got, want) < ONE_REL, (k, r)


def test_prefill_matches_jax_gspmd(runs, arch, shape):
    """JAX's ``make_prefill_step`` under GSPMD in "fsdp" mode on the same
    small batch: each rank's greedy tokens and pos equal its rows of JAX's,
    every other cache leaf within JAX_REL."""
    t, jx = f"{ts.tag(shape)}/{arch}", runs["jax"]
    pre = f"{t}/gspmd_prefill/"
    keys = [k[len(pre):] for k in jx.files if k.startswith(pre)]
    assert "cache/pos" in keys and "tokens" in keys
    for r, res in enumerate(ranks(runs, shape)):
        for k in keys:
            want = rows_of(shape, r, jx[pre + k],
                           batch_dim(arch, k.rsplit("/", 1)[-1]))
            got = res[f"{t}/prefill/{k}"]
            assert got.shape == want.shape, (k, got.shape, want.shape)
            if k in ("tokens", "cache/pos"):
                np.testing.assert_array_equal(got, want, err_msg=k)
            else:
                assert leaf_rel(got, want) < JAX_REL, (k, r)


def test_moe_prefill_with_rows_over_every_axis(runs, moe_shape):
    """llama4-scout's ``make_prefill_step`` in "fsdp" mode on a batch of
    as many rows as the mesh has ranks, whose rows ``batch_shardings``
    puts over every axis, "model" included: the step installs those rows,
    so the MoE exchanges the rows over "model" (its all-to-all's row path)
    rather than slicing the sequence of rows it takes for alike.  Each
    rank's greedy tokens and pos equal its rows of one process's, every
    other cache leaf within ONE_REL."""
    t, rows = ts.tag(moe_shape), int(np.prod(moe_shape))
    arch = ts.MOE_ARCH
    assert batch_shardings({"t": (rows, ts.SEQ)}, MeshSpec(ts.AXES, moe_shape),
                           "fsdp")["t"][0] == ts.AXES
    one = runs[1, 0]
    pre = f"one{rows}/{arch}/prefill/"
    keys = [k[len(pre):] for k in one.files if k.startswith(pre)]
    assert "cache/pos" in keys and "tokens" in keys
    for r, res in enumerate(ranks(runs, moe_shape)):
        for k in keys:
            want = rows_of(moe_shape, r, one[pre + k],
                           batch_dim(arch, k.rsplit("/", 1)[-1]), rows)
            got = res[f"{t}/{arch}/prefill/{k}"]
            assert got.shape == want.shape, (k, got.shape, want.shape)
            if k in ("tokens", "cache/pos"):
                np.testing.assert_array_equal(got, want, err_msg=k)
            else:
                assert leaf_rel(got, want) < ONE_REL, (k, r)
