"""The mesh dry run (``repro_torch/launch/dryrun.py`` with ``--multi-pod``):
one rank of the reference's production meshes counted on meta over a world
of the "fake" backend, its collectives at the reference's ring costs, and
the decode step's rows over the batch axes.

- the ring costs against ``repro.roofline.analyze`` of a synthetic HLO;
- rank r's count on meta over a fake world equal to rank r's count of the
  same step on gloo with real tensors (``tests/_torch_dryrun_mesh.worker``,
  worlds 2 and 4), five families, both modes, train, prefill and decode, a
  split sequence included;
- each rank's parameter and optimizer-state bytes against JAX's
  ``shard_shape`` on (16, 16) and (2, 16, 16) (``jax_state_bytes``);
- per-device FLOPs against the reference's HLO on a forced-host (2, 2);
- ``make_serve_step`` on a mesh against JAX's serve step jitted with the
  reference's decode cell's shardings, and the chain from the prefill;
- context-parallel decode of a batch of one, its positions over "data",
  chained steps against JAX's serve step jitted with ``cache_shardings``;
- each rank's decode-cache bytes against JAX's ``shard_shape``, and the
  serve step's refusal of a cache of other kv heads;
- the CLI, the sanity figure of "tp"'s all-reduces, the fake backend's
  refusal of a model off meta, and the grouped FFN booked over the experts
  the tokens can reach.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_dryrun_mesh as dm  # noqa: E402
import _torch_tp as tt  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.roofline import analyze  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.collectives import (_ALL_GATHER,  # noqa: E402
                                            _REDUCE_SCATTER)
from repro_torch.launch.mesh import (MeshSpec, fake_world,  # noqa: E402
                                     make_mesh, production_spec)
from repro_torch.launch.shardings import (batch_shardings,  # noqa: E402
                                          decode_cache_specs, local_slice)
from repro_torch.models import Model  # noqa: E402
from repro_torch.roofline import Counter, counting  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# f32 on both sides; the port's decode against JAX's (tests/
# test_torch_model.py's port-vs-JAX tolerance is 1e-5 for the caches)
CACHE_REL = 1e-5
FLOPS_REL = 0.01


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": npz, "state": {...}, "inputs": npz, (world, rank): (counts,
    npz)}: the gloo worlds 2 and 4 beside two JAX subprocesses."""
    d = tmp_path_factory.mktemp("dryrun_mesh")
    inputs = str(d / "inputs.npz")
    tt.make_inputs(inputs, dm.INPUT_ARCHS)
    path = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")])
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=path)
    jobs = [subprocess.Popen(
        [sys.executable, "-c", f"import _torch_dryrun_mesh as dm; {call}"],
        env=dict(env, XLA_FLAGS=f"--xla_force_host_platform_device_count="
                 f"{n}"), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for n, call in (
            (4, f"dm.jax_reference({inputs!r}, {str(d / 'jax.npz')!r})"),
            (512, f"dm.jax_state_bytes({str(d / 'state.json')!r})"))]
    procs = [torch.multiprocessing.start_processes(
        dm.worker, args=(w, str(d / f"store{w}"), inputs, str(d)),
        nprocs=w, join=False, start_method="spawn") for w in (2, 4)]
    try:
        for ctx in procs:
            while not ctx.join(timeout=300):
                pass
        for job in jobs:
            _, err = job.communicate(timeout=300)
            assert job.returncode == 0, err[-4000:]
    finally:
        for job in jobs:
            job.kill()
    out = {"jax": np.load(d / "jax.npz"), "inputs": np.load(inputs)}
    with open(d / "state.json") as f:
        out["state"] = json.load(f)
    for w in (2, 4):
        for r in range(w):
            with open(d / f"dm_w{w}rank{r}.json") as f:
                out[w, r] = (json.load(f), np.load(d / f"dm_w{w}rank{r}.npz"))
    return out


# -------------------------------------------------------------- ring costs
def _hlo(kind: str, n: int, dtype: str, size: int) -> str:
    """One collective of ``kind`` over groups of ``n`` on a ``size``-element
    operand: its result as the port's op returns it."""
    result = size * n if kind in ("all-gather", "all-to-all") else size
    extra = {"all-reduce": ", to_apply=%add",
             "all-gather": ", dimensions={0}",
             "reduce-scatter": ", dimensions={0}, to_apply=%add",
             "all-to-all": ", dimensions={0}"}[kind]
    operand = size * n if kind == "reduce-scatter" else size
    return textwrap.dedent(f"""\
    HloModule test, entry_computation_layout={{()->f32[]}}

    ENTRY %main (p: {dtype}[{operand}]) -> f32[] {{
      %p = {dtype}[{operand}]{{0}} parameter(0)
      %c = {dtype}[{result}]{{0}} {kind}(%p), replica_groups=[1,{n}]<=[{n}]{extra}
      ROOT %r = f32[] constant(0)
    }}
    """)


def _book(kind: str, mesh, dtype, size: int) -> None:
    """One collective of ``kind`` on the mesh's one axis, as the port's
    ``launch/collectives.py`` calls it, on meta."""
    group = mesh.get_group("ring")
    n = group.size()
    x = torch.empty(size, dtype=dtype, device="meta")
    if kind == "all-reduce":
        dist.all_reduce(x, group=group)
    elif kind == "all-gather":
        _ALL_GATHER(x.new_empty(n * size), x, group=group)
    elif kind == "reduce-scatter":
        _REDUCE_SCATTER(x, x.new_empty(n * size), group=group)
    else:
        from torch.distributed._functional_collectives import (
            all_to_all_single_autograd, wait_tensor)
        wait_tensor(all_to_all_single_autograd(x.new_empty(n * size), None,
                                               None, group))


@pytest.mark.parametrize("n", [2, 16, 512])
def test_ring_costs_equal_the_references(n):
    """Each kind booked on a fake group of n, at a few sizes and dtypes:
    the link bytes equal exactly ``repro.roofline.analyze`` of a synthetic
    HLO with the same groups; one call each, by kind and by axis."""
    dtypes = {torch.float32: "f32", torch.bfloat16: "bf16"}
    kinds = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")
    with fake_world(MeshSpec(("ring",), (n,))) as mesh:
        for dtype, name in dtypes.items():
            for size in (1, 1000, 4096 * 64):
                for kind in kinds:
                    with Counter("meta", mesh) as c:
                        _book(kind, mesh, dtype, size)
                    want = analyze(_hlo(kind, n, name, size), n)
                    s = c.summary()
                    assert s["collective_by_kind"] == {
                        kind: want.collective_by_kind[kind]}, (kind, size)
                    assert s["collective_counts"] == {kind: 1}
                    assert s["collective_calls"] == {f"{kind}/ring": 1}
                    assert s["collective_by_axis"] == {
                        "ring": want.collective_bytes}
    assert not dist.is_initialized()


def test_a_group_of_one_rank_books_its_call_and_no_bytes():
    with fake_world(MeshSpec(("data", "model"), (1, 1))) as mesh:
        x = torch.empty(8, device="meta")
        with Counter("meta", mesh) as c:
            dist.all_reduce(x, group=mesh.get_group("model"))
    s = c.summary()
    assert s["collective_counts"] == {"all-reduce": 1}
    assert s["collective_by_axis"] == {"model": 0.0}
    assert s["kinds"][counting.COLLECTIVES]["bytes"] == 8 * 4


# ------------------------------------------------------- meta against gloo
@pytest.mark.parametrize("arch", dm.COUNT_ARCHS)
@pytest.mark.parametrize("shape", dm.COUNT_MESHES, ids=map(dm.tag,
                                                          dm.COUNT_MESHES))
def test_meta_count_equals_gloo_count(runs, shape, arch):
    """Rank r's count on meta over a fake world equals rank r's count of
    the same step on gloo with real tensors, exactly: the kinds but the
    kernels' (FLOPs and bytes), the kernel calls, and the collectives'
    kinds, counts, calls by axis and link bytes by kind and by axis; in
    both modes, train, prefill and decode, and fsdp's train and prefill on
    a batch smaller than the mesh (the sequence split)."""
    w = int(np.prod(shape))
    cases = [c for c in dm.count_cases(shape) if c[0] == arch]
    for r in range(w):
        counts, _ = runs[w, r]
        for case in cases:
            key = dm.case_key(shape, *case)
            meta, cpu = counts[f"meta/{key}"], counts[f"cpu/{key}"]
            assert meta == {**cpu, "flops": meta["flops"]}, (r, key)
            assert meta["flops"] > 0, key
            if w > 1 and case[2] != "decode":
                assert sum(meta["collective_by_axis"].values()) > 0, key


# ---------------------------------------------------- per-device state bytes
@pytest.mark.parametrize("arch", ARCHS)
def test_per_device_state_equals_jax_shard_shapes(runs, arch):
    """On (16, 16) and (2, 16, 16), each mode, with and without ZeRO-1:
    the dry-run row's parameter and optimizer-state bytes of a rank equal
    the sum of ``NamedSharding.shard_shape`` over the reference's
    ``param_shardings`` and ``opt_shardings``."""
    for multi_pod in (False, True):
        with fake_world(production_spec(multi_pod=multi_pod)) as mesh:
            for mode in dm.MODES:
                for zero1 in (True, False):
                    _, meta = dryrun.lower_cell(arch, "train_4k", mesh=mesh,
                                                mode=mode, zero1=zero1)
                    mem = meta["memory"]
                    want = runs["state"][
                        f"{int(multi_pod)}/{arch}/{mode}/{int(zero1)}"]
                    assert [mem["params_bytes"], mem["opt_bytes"]] == want, \
                        (multi_pod, mode, zero1)


# --------------------------------------------------- FLOPs against JAX's HLO
def test_per_device_flops_match_jax_hlo(runs):
    """deepseek-7b smoke on a (2, 2) mesh in "tp": the reference's train
    (ZeRO-1), prefill and decode steps jitted with its shardings and read
    by ``analyze``; the port's meta count of the last rank within 1 %.  The
    difference, named: the flash kernel's booked work is the causal half
    of S x T (``kernel_model.attention_pairs``) in two products forward and
    five backward (the scores recomputed), where the reference's plain
    attention computes every score in two products and differentiates
    them in four; with that term swapped the counts agree exactly.  The
    collectives differ (GSPMD picks its own) and are printed beside."""
    from repro_torch.roofline import kernel_model
    jx = runs["jax"]
    counts, _ = runs[4, 3]
    cfg = dm.count_cfg(dm.FLOPS_ARCH)
    b, s = dm.ROWS // dm.FLOPS_MESH[0], dm.SEQ
    h, hd = cfg.n_heads // dm.FLOPS_MESH[1], cfg.head_dim
    full = 2 * b * h * s * s * hd              # one S x T product, all pairs
    for kind in dm.KINDS:
        key = dm.case_key(dm.FLOPS_MESH, dm.FLOPS_ARCH, "tp", kind, dm.ROWS)
        c = counts[f"meta/{key}"]
        want = float(jx[f"flops/{kind}"])
        got = c["flops"]
        calls = c["calls"]
        pairs = kernel_model.attention_pairs(s, s, True, 0)
        booked = (calls.get("flash_attn_fwd", 0) * 2 * 2 * b * h * pairs * hd
                  + calls.get("flash_attn_bwd", 0) * 5 * 2 * b * h * pairs
                  * hd)
        plain = (calls.get("flash_attn_fwd", 0) * 2 * full
                 + calls.get("flash_attn_bwd", 0) * 4 * full)
        named = got - booked + plain
        print(f"{kind}: port meta {got:.0f}, JAX HLO {want:.0f}, port with "
              f"the plain attention's products {named:.0f}; collectives "
              f"port {c['collective_by_kind']}, JAX " + str({
                  k.rsplit('/', 1)[1]: float(jx[k]) for k in jx.files
                  if k.startswith(f"flops/{kind}/collective/")}))
        assert named == pytest.approx(want, rel=FLOPS_REL), kind


# ------------------------------------------------ the decode step's rows
def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _rank_part(whole: dict, cfg, shape, mode: str, r: int) -> dict:
    spec = MeshSpec(dm.AXES, shape)
    coord = dict(zip(dm.AXES, np.unravel_index(r, shape)))
    specs = decode_cache_specs(whole, cfg, spec, mode)
    return {k: local_slice(torch.as_tensor(v), specs[k], spec, coord).numpy()
            for k, v in whole.items()}


def _rows(x, shape, r: int):
    spec = MeshSpec(dm.AXES, shape)
    coord = dict(zip(dm.AXES, np.unravel_index(r, shape)))
    sh = batch_shardings({"tokens": x}, spec, "tp")["tokens"]
    return local_slice(torch.as_tensor(x), sh, spec, coord).numpy()


@pytest.mark.parametrize("arch", dm.SERVE_ARCHS)
@pytest.mark.parametrize("shape", dm.SERVE_MESHES, ids=map(dm.tag,
                                                          dm.SERVE_MESHES))
def test_decode_rows_match_jax(runs, shape, arch):
    """``make_serve_step`` on a mesh, in both modes, with the whole tokens
    and each rank's part of the cache: the rank's greedy tokens equal the
    rank's rows of JAX's serve step (jitted with ``tok_shard`` and
    ``cache_shardings``), its cache within 1e-5 of JAX's part (the mamba
    archs' conv channels and ssm heads over "model" as JAX's are); in
    "tp" the chain from ``make_prefill_step`` on the mesh too."""
    from repro_torch.configs import get_smoke
    jx = runs["jax"]
    cfg = tt.smoke(arch, get_smoke)
    w, t = int(np.prod(shape)), dm.tag(shape)
    tok0 = jx[f"{arch}/tok0"]
    want_tok = jx[f"{arch}/{t}/tok1"]
    keys = [k.rsplit("/", 1)[1] for k in jx.files
            if k.startswith(f"{arch}/{t}/cache1/")]
    whole1 = {k: jx[f"{arch}/{t}/cache1/{k}"] for k in keys}
    whole0 = {k: jx[f"{arch}/cache0/{k}"] for k in keys}
    for r in range(w):
        _, res = runs[w, r]
        pre = f"serve/{t}/{arch}"
        np.testing.assert_array_equal(res[f"{pre}/tok0"], tok0)
        for mode in (*dm.MODES, "chain"):
            layout = "tp" if mode == "chain" else mode
            np.testing.assert_array_equal(res[f"{pre}/{mode}/tok1"],
                                          _rows(want_tok, shape, r))
            part = _rank_part(whole1, cfg, shape, layout, r)
            for k in keys:
                got = res[f"{pre}/{mode}/cache/{k}"]
                assert got.shape == part[k].shape, (mode, k)
                if k in ("conv", "ssm"):      # channels, heads over "model"
                    dim = -1 if k == "conv" else -3
                    assert got.shape[dim] * shape[1] == \
                        whole1[k].shape[dim], (mode, k)
                if k == "pos":
                    np.testing.assert_array_equal(got, part[k])
                else:
                    assert _rel(got, part[k]) < CACHE_REL, (r, mode, k)
        np.testing.assert_array_equal(res[f"{pre}/chain/tok0"][:, None],
                                      _rows(tok0, shape, r))
        assert set(_rank_part(whole0, cfg, shape, "tp", r)) == set(keys)


def test_serve_step_refuses_a_cache_of_other_rows(tmp_path):
    """A cache that does not hold the rank's rows raises (a cache of every
    row passes ``make_serve_step(model, whole=True)``)."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.steps import make_serve_step
    with fake_world(MeshSpec(dm.AXES, (2, 1))) as mesh:
        model = Model(get_smoke("deepseek-7b"), device="meta", mesh=mesh)
        cache = Model(get_smoke("deepseek-7b"), device="meta"
                      ).init_decode_cache(3, 8)
        with pytest.raises(ValueError, match="Model.cache_part"):
            make_serve_step(model)(torch.zeros(4, 1, dtype=torch.int64,
                                               device="meta"), cache)


def test_serve_step_refuses_a_cache_of_other_kv_heads():
    """A cache of every kv head where the rules lay them over "model"
    raises naming ``Model.cache_part``, in both modes."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.common import set_sharding_mode
    cfg = get_smoke("deepseek-7b")
    for mode in dm.MODES:
        with fake_world(MeshSpec(dm.AXES, (1, 2))) as mesh:
            set_sharding_mode(mode)
            try:
                model = Model(cfg, device="meta", mesh=mesh)
            finally:
                set_sharding_mode("tp")
            cache = Model(cfg, device="meta").init_decode_cache(4, 8)
            assert cache["k"].shape[3] == cfg.n_kv_heads
            with pytest.raises(ValueError, match="Model.cache_part"):
                make_serve_step(model)(torch.zeros(
                    4, 1, dtype=torch.int64, device="meta"), cache)
            assert model.cache_part(cache)["k"].shape[3] == \
                cfg.n_kv_heads // 2, mode


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b"])
def test_serve_step_refuses_decode_states_of_every_rank(arch):
    """A cache whose conv state holds every channel and whose ssm state
    holds every head, where the rules lay them over "model", raises naming
    ``Model.cache_part`` in both modes; ``Model.cache_part`` and
    ``Model.own_heads`` cut it to the rank's half on (1, 2)."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.common import set_sharding_mode
    cfg = get_smoke(arch)
    c = cfg.d_inner + 2 * cfg.ssm_state
    for mode in dm.MODES:
        with fake_world(MeshSpec(dm.AXES, (1, 2))) as mesh:
            set_sharding_mode(mode)
            try:
                model = Model(cfg, device="meta", mesh=mesh)
            finally:
                set_sharding_mode("tp")
            cache = Model(cfg, device="meta").init_decode_cache(4, 8)
            assert cache["conv"].shape[-1] == c
            with pytest.raises(ValueError, match="Model.cache_part"):
                make_serve_step(model)(torch.zeros(
                    4, 1, dtype=torch.int64, device="meta"), cache)
            for part in (model.cache_part(cache), model.own_heads(cache)):
                assert part["conv"].shape[-1] == c // 2, mode
                assert part["ssm"].shape[-3] == cfg.ssm_heads // 2, mode


# -------------------------------------------- context-parallel decode
def _vocab_part(logits, cfg, shape, mode: str, r: int):
    """The rank's slice of whole logits (..., V): its vocabulary slice over
    "model" in "tp" mode, all of it in "fsdp" mode."""
    if mode == "fsdp":
        return logits
    nm = shape[1]
    part = cfg.vocab // nm
    m = int(np.unravel_index(r, shape)[1])
    return logits[..., m * part:(m + 1) * part]


@pytest.mark.parametrize("arch", dm.CP_ARCHS)
@pytest.mark.parametrize("shape", dm.CP_MESHES, ids=map(dm.tag,
                                                       dm.CP_MESHES))
def test_context_parallel_decode_matches_jax(runs, shape, arch):
    """A batch of one on a mesh whose "data" axis does not divide it, in
    both modes: each rank holds its CP_LEN / 2 positions of the cache
    (``decode_cache_specs`` = ``cache_shardings``; on (2, 2) its kv heads
    over "model"), CP_STEPS chained ``make_serve_step`` steps whose ``pos``
    crosses from rank 0's positions to rank 1's and, at the last step,
    leaves gemma3's windowed layers no position on rank 0.  Every step's
    greedy tokens equal JAX's serve step jitted with ``cache_shardings``
    and one process's; each rank's cache within CACHE_REL of JAX's part;
    the logits within 1e-5 of one process's and 1e-4 of JAX's."""
    from repro_torch.configs import get_smoke
    jx = runs["jax"]
    cfg = tt.smoke(arch, get_smoke)
    w, t = int(np.prod(shape)), dm.tag(shape)
    last = dm.CP_PROMPT + dm.CP_STEPS - 1
    assert dm.CP_PROMPT - 1 < dm.CP_LEN // shape[0] <= last
    if cfg.sliding_window:
        assert last - cfg.sliding_window >= dm.CP_LEN // shape[0] - 1
    want_tok = jx[f"cp/{arch}/{t}/tok"]
    assert want_tok.shape == (dm.CP_STEPS, 1, 1)
    keys = [k.rsplit("/", 1)[1] for k in jx.files
            if k.startswith(f"cp/{arch}/{t}/cache/")]
    whole = {k: jx[f"cp/{arch}/{t}/cache/{k}"] for k in keys}
    one_logits = jx[f"cp/{arch}/one/logits"]
    for r in range(w):
        _, res = runs[w, r]
        pre = f"cp/{t}/{arch}"
        np.testing.assert_array_equal(res[f"{pre}/one/tok"], want_tok)
        for mode in dm.MODES:
            np.testing.assert_array_equal(res[f"{pre}/{mode}/tok"],
                                          want_tok, err_msg=mode)
            got = res[f"{pre}/{mode}/logits"]
            assert _rel(got, _vocab_part(res[f"{pre}/one/logits"], cfg,
                                         shape, mode, r)) < 1e-5, (r, mode)
            assert _rel(got, _vocab_part(one_logits, cfg, shape, mode,
                                         r)) < 1e-4, (r, mode)
            part = _rank_part(whole, cfg, shape, mode, r)
            for k in keys:
                got = res[f"{pre}/{mode}/cache/{k}"]
                assert got.shape == part[k].shape, (mode, k)
                if k in ("k", "v"):
                    assert got.shape[2] == dm.CP_LEN // shape[0], k
                if k == "pos":
                    np.testing.assert_array_equal(got, part[k])
                else:
                    assert _rel(got, part[k]) < CACHE_REL, (r, mode, k)


@pytest.mark.parametrize("cell", dm.CACHE_CELLS, ids="/".join)
def test_decode_cache_bytes_equal_jax_shard_shapes(runs, cell):
    """The rank's decode cache of the mesh dry run (``input_specs.
    cache_specs``, ``decode_cache_specs``) on (16, 16) and (2, 16, 16),
    both modes: each leaf's bytes, conv and ssm included, equal
    ``NamedSharding.shard_shape`` of the reference's ``cache_shardings``.
    ``pos`` is not held: the port's is int64 and lies with the rows."""
    from repro_torch.launch.input_specs import cache_specs
    arch, shape_name = cell
    cfg = get_config(arch)
    for multi_pod in (False, True):
        spec = production_spec(multi_pod=multi_pod)
        want = runs["state"][f"cache/{int(multi_pod)}/{arch}/{shape_name}"]
        for mode in dm.MODES:
            got = {k: v.numel() * v.element_size() for k, v in cache_specs(
                cfg, SHAPES[shape_name], spec, mode).items()}
            assert set(got) == set(want), mode
            got.pop("pos")
            for k, v in got.items():
                assert v == want[k], (multi_pod, mode, k)


# ------------------------------------------------------------------- the CLI
def test_cli_counts_both_production_meshes():
    """``--multi-pod both --sharding-mode fsdp``: rows tagged "16x16" and
    "2x16x16", 256 and 512 chips, the last rank, positive link bytes by
    kind and axis; the (2, 16, 16) training batch (256 rows on 512 ranks)
    splits its sequence over "model", and its row says so."""
    rows = dryrun.main(["--arch", "deepseek-7b", "--shape", "train_4k",
                        "--layers", "2", "--multi-pod", "both",
                        "--sharding-mode", "fsdp"])
    assert [(r["mesh"], r["chips"], r["rank"]) for r in rows] == [
        ("16x16", 256, 255), ("2x16x16", 512, 511)]
    for r in rows:
        assert r["status"] == "ok" and r["sharding_mode"] == "fsdp"
        counts = r["counts"]
        assert set(counts["collective_by_kind"]) == {
            "all-gather", "all-reduce", "reduce-scatter"}
        assert all(v > 0 for k, v in counts["collective_by_kind"].items()
                   if k != "all-reduce")
        assert r["roofline"]["collective_bytes_per_device"] == \
            counts["collective_bytes"] > 0
        assert r["memory"]["fits"]
    assert rows[0]["layout"]["seq"] == ()
    assert rows[1]["layout"] == {"rows": ("pod", "data"), "seq": ("model",),
                                 "whole": ()}
    assert rows[1]["coordinate"] == {"pod": 1, "data": 15, "model": 15}
    assert rows[1]["collective_s_by_axis"]["pod"] > 0
    assert not dist.is_initialized()


def test_sanity_figure_of_tp_all_reduces():
    """deepseek-7b ``train_4k`` on (16, 16) in "tp" at full width, 2
    layers: the "model" all-reduces in closed form.  A layer's attention
    and MLP each end in "g" forward and start with "f" backward; remat's
    recompute stops once the layer's saved tensors are back, so it redoes
    the attention's "g" and not the MLP's: 5 a layer.  The embedding adds
    its "g" and the head its "f": 5 L + 2 of (16, 4096, 4096) bf16, each
    2 (15/16) of 0.537 GB.  Besides them the vocabulary-parallel CE's three
    f32 (16, 4096) all-reduces (max, sum, gold) and the clip's one of the
    sliced leaves' squared norms."""
    layers, nm = 2, 16
    cfg = get_config("deepseek-7b").replace(n_layers=layers)
    b = SHAPES["train_4k"].global_batch // 16
    s, d = SHAPES["train_4k"].seq_len, cfg.d_model
    row = dryrun.run_cell("deepseek-7b", "train_4k", verbose=False,
                          cfg_overrides={"n_layers": layers},
                          multi_pod=False, mode="tp")
    c = row["counts"]
    ring = 2 * (nm - 1) / nm
    big = 5 * layers + 2
    sliced = 9           # embed, lm_head and the layers' 7 split leaves
    assert c["collective_calls"]["all-reduce/model"] == big + 3 + 1
    assert c["collective_by_axis"]["model"] == pytest.approx(
        ring * (big * b * s * d * 2 + 3 * b * s * 4 + sliced * 4), rel=1e-12)
    assert big * ring * b * s * d * 2 / 1e9 == pytest.approx(12.08, abs=0.01)
    assert row["roofline"]["bottleneck"] in ("memory", "collective")


# ------------------------------------------------------ the fake backend
def test_fake_mesh_serves_meta_models_only(tmp_path):
    """A CPU model on a fake mesh raises; a meta model on a gloo mesh
    raises; a fake world is refused inside a process with a group."""
    from repro_torch.configs import get_smoke
    cfg = get_smoke("deepseek-7b")
    with fake_world(MeshSpec(dm.AXES, (1, 2))) as mesh:
        with pytest.raises(ValueError, match="meta mesh cannot run"):
            Model(cfg, device="cpu", mesh=mesh)
        Model(cfg, device="meta", mesh=mesh)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), dm.AXES, device="cpu")
        with pytest.raises(ValueError, match="cpu mesh cannot run"):
            Model(cfg, device="meta", mesh=mesh)
        with pytest.raises(RuntimeError, match="without a default"):
            with fake_world(MeshSpec(dm.AXES, (1, 1))):
                pass
        with pytest.raises(RuntimeError, match="fake backend"):
            make_mesh((1, 1), dm.AXES, device="meta")
    finally:
        dist.destroy_process_group()


# --------------------------------------------- the grouped FFN's booking
def test_grouped_ffn_books_the_experts_the_tokens_reach():
    """A decode step of 4 tokens at top-1 books 4 experts' weights and 4
    rows, not every one of llama4-scout's 16 experts and every slot; a
    prefill of more tokens than experts books every expert."""
    from repro_torch.models.mlp import moe_capacity
    from repro_torch.roofline import kernel_model
    cfg = get_config("llama4-scout-17b-a16e").replace(n_layers=1)
    model = Model(cfg, device="meta")
    cache = model.init_decode_cache(4, 64)
    with Counter("meta") as c:
        model.decode_step(torch.zeros(4, 1, dtype=torch.int64,
                                      device="meta"), cache)
    cap = moe_capacity(cfg, 1)
    want = kernel_model.moe_gmm(4, cfg.n_experts, cap, cfg.d_model, cfg.d_ff,
                                cfg.mlp_act, live_rows=4, live_experts=4)
    assert c.kinds["moe_gmm"] == {"flops": want[0], "bytes": want[1]}
    assert c.kinds["moe_gmm"]["bytes"] < kernel_model.moe_gmm(
        4, cfg.n_experts, cap, cfg.d_model, cfg.d_ff)[1] / 3
    with Counter("meta") as c:
        model.prefill({"tokens": torch.zeros(1, 64, dtype=torch.int64,
                                             device="meta")})
    cap = moe_capacity(cfg, 64)
    want = kernel_model.moe_gmm(1, cfg.n_experts, cap, cfg.d_model,
                                cfg.d_ff, cfg.mlp_act, live_rows=64,
                                live_experts=cfg.n_experts)
    assert c.kinds["moe_gmm"] == {"flops": want[0], "bytes": want[1]}
