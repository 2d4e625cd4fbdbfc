"""The sequence split of an "fsdp" batch smaller than the mesh for the MoE,
whisper and llava (and deepseek-7b on three axes) on torch.distributed
(gloo, the CPU) against one process and the JAX package's GSPMD fsdp
steps (``tests/_torch_seq_families.py``: its CASES, their meshes and why).

- The MoE routes the reference's blocks on the all-to-all path, its
  capacity and slots a model slice's, so where those drop pairs it is held
  to JAX alone; at a capacity factor that drops nothing, to one process
  too.  JAX's expert-parallel aux is one shard's (ROADMAP.md, faults of
  the reference), so the MoE's gradients are held to JAX's with CE alone
  as the loss, and its aux to one process's.
- Six experts on (1, 4): the dense dispatch, whose capacity and slots
  over each row's whole sequence are one process's and JAX's.
- whisper's frames split as its tokens (32 frames) or whole beside them
  (31 frames).
- llava's 8 patches and 16 tokens in contiguous slices of 24 positions (on
  4 ranks rank 0 holds patches only); 6 patches on (1, 4) and 7 on (2, 2)
  lie whole beside the split tokens, rows and all, and the joined sequence
  (22 and 23 positions) is cut into equal slices with its tail padded.

The ``runs`` fixture runs everything once: one process at world 1, every
mesh of world 2 and 4 (``_torch_seq_families.worker``, one spawned process
a rank), beside the JAX reference in a subprocess with 4 forced host
devices.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_seq_families as tf  # noqa: E402

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch.mesh import MeshSpec  # noqa: E402
from repro_torch.launch.shardings import (batch_shardings,  # noqa: E402
                                          fsdp_spec, local_slice)
from repro_torch.models.mlp import moe_capacity  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# tests/test_torch_seq_split.py's: one process at 1e-5, JAX at the repo's
# port-vs-JAX gradient tolerance; aux, a mean of the same values summed in
# another order, as tests/test_torch_expert_parallel.py holds it
ONE_REL = 1e-5
JAX_REL = 1e-4
AUX_REL = 1e-6
RUN = [(n, s) for n, c in tf.CASES.items() for s in c[3]]
ONE = [(n, s) for n, s in RUN if n not in tf.DROPS]
MOE = [(n, s) for n, s in ONE if n in tf.MOE]
# the cases whose frames or patches divide no split and lie whole
WHOLE = {"whisper-31-frames": ("frames",), "llava-6-patches": ("patches",),
         "llava-7-patches": ("patches",)}


def _ids(cases):
    return [f"{n}-{tf.tag(s)}" for n, s in cases]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("seq_families")
    inputs = str(d / "inputs.npz")
    tf.make_inputs(inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", "import _torch_seq_families; "
         f"_torch_seq_families.jax_reference({inputs!r}, "
         f"{str(d / 'jax.npz')!r})"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    worlds = (1, 2, 4)
    procs = [torch.multiprocessing.start_processes(
        tf.worker, args=(w, str(d / f"store{w}"), inputs, str(d)),
        nprocs=w, join=False, start_method="spawn") for w in worlds]
    try:
        for ctx in procs:
            while not ctx.join(timeout=300):
                pass
        _, err = jax_proc.communicate(timeout=600)
        assert jax_proc.returncode == 0, err[-3000:]
    finally:
        jax_proc.kill()
    out = {"jax": np.load(d / "jax.npz"), "inputs": np.load(inputs)}
    for w in worlds:
        for r in range(w):
            out[w, r] = np.load(d / f"fam_w{w}rank{r}.npz")
    return out


def ranks(runs, shape) -> list:
    w = int(np.prod(shape))
    return [runs[w, r] for r in range(w)]


def coord_of(shape, rank: int) -> dict:
    return dict(zip(tf.axes_of(shape), map(int, np.unravel_index(rank,
                                                                 shape))))


def whole_of(runs, name: str) -> dict:
    pre = f"{name}/state/"
    inp = runs["inputs"]
    return {k[len(pre):]: inp[k] for k in inp.files if k.startswith(pre)}


def leaf_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / (np.linalg.norm(want) + 1e-30))


def assemble(runs, shape, key: str, leaf: str, whole_shape) -> np.ndarray:
    """The whole leaf from every rank's part ``key/leaf``, each put where
    ``fsdp_spec`` and ``local_slice`` cut it; the ranks that hold the same
    part must hold it alike, bit for bit."""
    spec = MeshSpec(tf.axes_of(shape), shape)
    cut = fsdp_spec(leaf, whole_shape, spec)
    ids = torch.arange(int(np.prod(whole_shape))).reshape(whole_shape)
    out = np.full(int(np.prod(whole_shape)), np.nan)
    for r, res in enumerate(ranks(runs, shape)):
        sel = local_slice(ids, cut, spec, coord_of(shape, r)).numpy().ravel()
        part = res[f"{key}/{leaf}"].ravel()
        seen = ~np.isnan(out[sel])
        np.testing.assert_array_equal(out[sel][seen], part[seen],
                                      err_msg=leaf)
        out[sel] = part
    assert not np.isnan(out).any(), leaf
    return out.reshape(whole_shape)


def rows_of(shape, rank: int, whole: np.ndarray, dim: int) -> np.ndarray:
    """The rank's rows of ``whole`` along ``dim``, as ``batch_shardings``
    puts the mesh's small batch."""
    spec = MeshSpec(tf.axes_of(shape), shape)
    entry = batch_shardings({"t": (tf.rows_of(shape), tf.SEQ)}, spec,
                            "fsdp")["t"][0]
    cut = tuple(entry if d == dim else None for d in range(whole.ndim))
    return local_slice(torch.tensor(whole), cut, spec,
                       coord_of(shape, rank)).numpy()


def held(name: str, leaf: str) -> bool:
    """Whether a leaf's CE gradient is held: llama4's top-1 combine weight
    is p / p = 1, so its router's gradient through y is rounding noise on
    both sides (tests/test_torch_expert_parallel.py)."""
    return not (leaf.endswith("moe.router")
                and tf.CASES[name][0] == tf.LLAMA4)


def _hold_grads(runs, name, shape, key: str, want_of, rel: float) -> None:
    for leaf, full in whole_of(runs, name).items():
        if key.endswith("ce/grad") and not held(name, leaf):
            continue
        got = assemble(runs, shape, key, leaf, full.shape)
        assert leaf_rel(got, want_of(leaf)) < rel, leaf


def _hold_prefill(runs, shape, key: str, pre: str, want_run,
                  rel: float) -> None:
    keys = [k[len(pre):] for k in want_run.files if k.startswith(pre)]
    assert "cache/pos" in keys and "tokens" in keys
    for r, res in enumerate(ranks(runs, shape)):
        for k in keys:
            want = rows_of(shape, r, want_run[pre + k],
                           0 if k in ("tokens", "cache/pos") else 1)
            got = res[f"{key}/prefill/{k}"]
            assert got.shape == want.shape, (k, got.shape, want.shape)
            if k in ("tokens", "cache/pos"):
                np.testing.assert_array_equal(got, want, err_msg=k)
            else:
                assert leaf_rel(got, want) < rel, (k, r)


@pytest.mark.parametrize("name,shape", RUN, ids=_ids(RUN))
def test_the_rules_split_the_sequence(runs, name, shape):
    """``split_batch`` as every rank read it: the rows over a prefix of
    the axes, the sequence over the rest, "model" among them; whisper's
    31 frames and llava's 6 and 7 patches lie whole, and nothing else."""
    t = tf.tag(shape)
    axes = tf.axes_of(shape)
    want_seq = ("data", "model") if len(shape) == 3 else ("model",)
    for res in ranks(runs, shape):
        rows = tuple(res[f"{t}/{name}/rows"])
        seq = tuple(res[f"{t}/{name}/seq"])
        assert seq == want_seq and rows + seq == axes, (rows, seq)
        whole = tuple(res[f"{t}/{name}/whole"])
        assert whole == WHOLE.get(name, ()), whole


@pytest.mark.parametrize("name,shape", ONE, ids=_ids(ONE))
def test_step_matches_one_process(runs, name, shape):
    """``make_train_step``'s loss on every rank (ce + 0.01 aux, aux the
    whole batch's) and every gradient leaf as AdamW receives it, assembled
    from the ranks' parts, against one process's on the same rows within
    ONE_REL: where nothing is dropped, the ranks' slices give one
    process's loss and gradients, the router's through aux included."""
    t, rows = f"{tf.tag(shape)}/{name}", tf.rows_of(shape)
    one = runs[1, 0]
    want = float(one[f"one{rows}/{name}/full/loss"])
    for res in ranks(runs, shape):
        assert abs(float(res[f"{t}/full/loss"]) - want) <= \
            ONE_REL * abs(want)
    _hold_grads(runs, name, shape, f"{t}/full/grad",
                lambda leaf: one[f"one{rows}/{name}/full/grad/{leaf}"],
                ONE_REL)


@pytest.mark.parametrize("name,shape", RUN, ids=_ids(RUN))
def test_step_matches_jax_gspmd_fsdp(runs, name, shape):
    """JAX's fsdp step on the same small batch (GSPMD, ``in_shardings``
    from ``param_shardings`` and ``batch_shardings`` in "fsdp" mode, under
    ``with mesh:``, so that its MoE takes its all-to-all or its dense
    dispatch): the loss on every rank and every assembled gradient leaf
    within JAX_REL.  The MoE's with CE alone as the loss on both sides, its
    pairs dropped by the slices' capacity as JAX drops them."""
    t, jx = f"{tf.tag(shape)}/{name}", runs["jax"]
    run = "ce" if name in tf.MOE else "full"
    want = float(jx[f"{t}/gspmd/loss"])
    for res in ranks(runs, shape):
        assert abs(float(res[f"{t}/{run}/loss"]) - want) <= \
            JAX_REL * abs(want)
    _hold_grads(runs, name, shape, f"{t}/{run}/grad",
                lambda leaf: jx[f"{t}/gspmd/grad/{leaf}"], JAX_REL)


@pytest.mark.parametrize("name,shape", MOE, ids=_ids(MOE))
def test_moe_aux_is_the_whole_batch(runs, name, shape):
    """The MoE's aux on every rank (the step's metric, the CE step's, so
    that the router's gradient through aux is held by
    ``test_step_matches_one_process``) is one process's on the same rows
    where nothing is dropped (a later layer's routing reads what the
    earlier layers kept); JAX's expert-parallel aux is one shard's
    (``pmean`` over "model" of each block's, ROADMAP.md, faults of the
    reference), and is held to differ on the all-to-all path, where every
    split puts a row's tokens on other ranks.  The dense dispatch's (six
    experts) is the whole batch's in JAX too."""
    t, rows = f"{tf.tag(shape)}/{name}", tf.rows_of(shape)
    one = runs[1, 0]
    want = float(one[f"one{rows}/{name}/ce/aux"])
    for res in ranks(runs, shape):
        got = float(res[f"{t}/ce/aux"])
        assert abs(got - want) <= AUX_REL * want, (got, want)
    jax_aux = float(runs["jax"][f"{t}/gspmd/aux"])
    dense = tf.CASES[name][1].get("n_experts", 4) % shape[-1] != 0
    assert (abs(jax_aux - want) <= AUX_REL * want) == dense, (jax_aux, want)


@pytest.mark.parametrize("name,shape", ONE, ids=_ids(ONE))
def test_prefill_matches_one_process(runs, name, shape):
    """``make_prefill_step`` on the small batch: every rank returns its
    rows' greedy tokens and a cache of the whole prompt (k/v of every
    position, whisper's xk/xv of every frame, pos its length), those of
    one process on the same rows: tokens and pos equal, every other leaf
    within ONE_REL."""
    t, rows = f"{tf.tag(shape)}/{name}", tf.rows_of(shape)
    _hold_prefill(runs, shape, t, f"one{rows}/{name}/prefill/", runs[1, 0],
                  ONE_REL)


@pytest.mark.parametrize("name,shape", RUN, ids=_ids(RUN))
def test_prefill_matches_jax_gspmd(runs, name, shape):
    """JAX's ``make_prefill_step`` under GSPMD in "fsdp" mode on the same
    small batch, the MoE's drops included: each rank's greedy tokens and
    pos equal its rows of JAX's, every other cache leaf within JAX_REL."""
    t = f"{tf.tag(shape)}/{name}"
    _hold_prefill(runs, shape, t, f"{t}/gspmd_prefill/", runs["jax"],
                  JAX_REL)


@pytest.mark.parametrize("name", tf.DROPS)
def test_the_slices_drop_pairs(runs, name):
    """Where a model slice holds 8 tokens ((1, 2) and (2, 2)), its capacity
    drops pairs: the CE step's loss differs from its "-no-drop" twin's,
    which runs the same weights on the same tokens at E / k.  Otherwise
    the drop cases would hold nothing that the twin does not."""
    cfg = tf.cfg_of(name, get_smoke)
    assert moe_capacity(cfg, tf.SEQ // 2) < tf.SEQ // 2 * cfg.top_k
    for shape in ((1, 2), (2, 2)):
        t = tf.tag(shape)
        res = ranks(runs, shape)[0]
        got = float(res[f"{t}/{name}/ce/loss"])
        twin = float(res[f"{t}/{name}-no-drop/ce/loss"])
        assert abs(got - twin) > JAX_REL * abs(twin), (shape, got, twin)
