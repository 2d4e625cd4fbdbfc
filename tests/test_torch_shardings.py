"""The port's sharding rules against the reference's, leaf by leaf, on the
full-size parameter trees of all ten archs, without processes: JAX on
``AbstractMesh``es, the port on ``MeshSpec``s of the same axes and sizes
((1,1), (2,2), (1,4), the production (16,16) and (2,16,16)), in both
sharding modes; the optimizer's moments with and without ZeRO-1; batches
of every shape of the shape table; each family's decode caches.  Also the
DTensor placements a spec gives and the slice a rank takes."""
import functools

import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import input_specs as jax_inputs  # noqa: E402
from repro.launch import shardings as jax_sh  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, applicable, get_config  # noqa
from repro_torch.launch import input_specs, shardings  # noqa: E402
from repro_torch.launch.mesh import (MeshSpec, batch_axes,  # noqa: E402
                                     model_axis, production_spec)
from repro_torch.models import Model  # noqa: E402

MESHES = {"1x1": MeshSpec(("data", "model"), (1, 1)),
          "2x2": MeshSpec(("data", "model"), (2, 2)),
          "1x4": MeshSpec(("data", "model"), (1, 4)),
          "16x16": production_spec(),
          "2x16x16": production_spec(multi_pod=True)}
MODES = ("tp", "fsdp")


def _abstract(spec: MeshSpec) -> AbstractMesh:
    return AbstractMesh(spec.sizes, spec.axis_names)


def _dotted(tree) -> dict:
    """A JAX tree of NamedShardings as {dotted name: spec tuple}."""
    return {".".join(str(p.key) for p in path): tuple(s.spec)
            for path, s in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: hasattr(x, "spec"))}


@functools.lru_cache(maxsize=None)
def _jax_params(arch: str):
    return jax.eval_shape(lambda k: JaxModel(jax_config(arch)).init(k),
                          jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_params(arch: str) -> dict:
    return {n: tuple(p.shape) for n, p in
            Model(get_config(arch), device="meta").named_parameters()}


def test_mesh_specs_and_axes():
    assert production_spec() == MeshSpec(("data", "model"), (16, 16))
    assert production_spec(multi_pod=True).shape == {"pod": 2, "data": 16,
                                                     "model": 16}
    assert production_spec(multi_pod=True).size == 512
    for name, spec in MESHES.items():
        jm = _abstract(spec)
        assert batch_axes(spec) == tuple(
            a for a in jm.axis_names if a in ("pod", "data"))
        assert model_axis(spec) == "model"
        assert spec.shape == dict(jm.shape), name


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh, mode):
    jshape = _jax_params(arch)
    want = _dotted(jax_sh.param_shardings(jshape, _abstract(MESHES[mesh]),
                                          mode=mode))
    got = shardings.param_shardings(_port_params(arch), MESHES[mesh], mode)
    assert got == want


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_specs_match_reference(arch, mesh):
    """Moments as their parameters, with and without ZeRO-1, both modes;
    the step count replicated."""
    jshape = _jax_params(arch)
    opt_shape = {"m": jshape, "v": jshape,
                 "count": jax.ShapeDtypeStruct((), np.int32)}
    for mode in MODES:
        for zero1 in (False, True):
            want = jax_sh.opt_shardings(opt_shape, jshape,
                                        _abstract(MESHES[mesh]),
                                        zero1=zero1, mode=mode)
            got = shardings.opt_shardings(_port_params(arch), MESHES[mesh],
                                          zero1=zero1, mode=mode)
            assert got["count"] == tuple(want["count"].spec) == ()
            for key in ("m", "v"):
                assert got[key] == _dotted(want[key]), (mode, zero1, key)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_match_reference(arch, mesh):
    """Every shape of the table, through both packages' input_specs (the
    port's tokens int64, the reference's int32: the rule reads shapes)."""
    for shape in SHAPES.values():
        jb = jax_inputs.batch_specs(jax_config(arch), shape)
        pb = input_specs.batch_specs(get_config(arch), shape)
        assert {k: tuple(v.shape) for k, v in pb.items()} == \
            {k: tuple(v.shape) for k, v in jb.items()}
        for mode in MODES:
            want = jax_sh.batch_shardings(jb, _abstract(MESHES[mesh]), mode)
            got = shardings.batch_shardings(pb, MESHES[mesh], mode)
            assert got == {k: tuple(v.spec) for k, v in want.items()}, mode


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, mesh):
    """The decode caches of decode_32k and, where the arch takes it,
    long_500k (batch 1: context-parallel over the data axes)."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    for shape in (SHAPES["decode_32k"], SHAPES["long_500k"]):
        if not applicable(cfg, shape)[0]:
            continue
        jc = jax_inputs.cache_specs(jcfg, shape)
        pc = input_specs.cache_specs(cfg, shape)
        assert {k: tuple(v.shape) for k, v in pc.items()} == \
            {k: tuple(v.shape) for k, v in jc.items()}
        want = jax_sh.cache_shardings(jc, jcfg, _abstract(MESHES[mesh]))
        got = shardings.cache_shardings(pc, cfg, MESHES[mesh])
        assert got == {k: tuple(v.spec) for k, v in want.items()}


def test_placements():
    spec3 = MESHES["2x16x16"]
    assert shardings.placements((("pod", "data"), None, "model"), spec3) == \
        [Shard(0), Shard(0), Shard(2)]
    assert shardings.placements((), spec3) == [Replicate()] * 3
    assert shardings.placements((None, "model", None),
                                MESHES["2x2"]) == [Replicate(), Shard(1)]


@pytest.mark.parametrize("mesh", ["2x2", "1x4", "2x16x16"])
def test_local_slice_takes_the_row_major_part(mesh):
    """The rank at each mesh position takes part ``i`` of each sharded dim,
    ``i`` its position on the dim's axes with the first axis the major one
    (JAX's order: tests/test_torch_expert_parallel.py holds it to
    ``devices_indices_map``), for specs over one axis, over two axes of one
    dim, and over two dims; a contiguous copy."""
    spec = MESHES[mesh]
    names = spec.axis_names
    shape = (spec.size * 2, 6, spec.shape["model"] * 3)
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    for s in [(names[:-1], None, "model"), ("model",), (None, None, "model"),
              (names[-2], None, None), ()]:
        for flat in range(spec.size):
            coord = dict(zip(names, map(int, np.unravel_index(flat,
                                                              spec.sizes))))
            got = shardings.local_slice(x, shardings._spec(s), spec, coord)
            idx = []
            for d, n in enumerate(shape):
                entry = s[d] if d < len(s) else None
                axes = () if entry is None else (
                    entry if isinstance(entry, tuple) else (entry,))
                parts, pos = 1, 0
                for a in axes:
                    parts, pos = parts * spec.shape[a], \
                        pos * spec.shape[a] + coord[a]
                idx.append(slice(pos * n // parts, (pos + 1) * n // parts))
            np.testing.assert_array_equal(got.numpy(), x.numpy()[tuple(idx)])
            assert got.is_contiguous()


def test_expert_parallel_and_shard_params_on_meta():
    """Only the experts of a dividing "model" axis are sliced; at one rank
    of "model" nothing is copied."""
    params = {n: torch.empty(s, device="meta")
              for n, s in _port_params("arctic-480b").items()}
    spec = MESHES["1x4"]
    flags = {n: shardings.expert_parallel(n, p, spec)
             for n, p in params.items()}
    assert {n for n, f in flags.items() if f} == {
        "layers.moe.w_in", "layers.moe.w_gate", "layers.moe.w_out"}
    assert not any(shardings.expert_parallel(
        n, p, MeshSpec(("data", "model"), (1, 3))) for n, p in params.items())
    one = MeshSpec(("data", "model"), (1, 1))
    w_in = params["layers.moe.w_in"]
    spec = shardings.param_spec("layers.moe.w_in", w_in, one)
    assert spec == (None, "model", None, None)
    assert shardings.local_slice(w_in, spec, one, {"data": 0,
                                                   "model": 0}) is w_in


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cache_layout_is_the_references(arch, mesh, mode):
    """The port's decode-cache layout (``decode_cache_specs``) of a cache
    of each shape's batch and length: every leaf but ``pos`` as the
    reference's ``cache_shardings`` lays it, in both modes (positions over
    the batch axes for a batch of one, kv heads, the conv's channels and
    the ssm state's heads over "model"); the mesh dry run's layout keeps
    no leaf whole against the rules."""
    from repro_torch.launch import dryrun
    cfg, jcfg = get_config(arch), jax_config(arch)
    spec = MESHES[mesh]
    for shape in SHAPES.values():
        if not applicable(cfg, shape)[0]:
            continue
        jc = jax_inputs.cache_specs(jcfg, shape)
        pc = input_specs.cache_specs(cfg, shape)
        want = {k: tuple(v.spec) for k, v in jax_sh.cache_shardings(
            jc, jcfg, _abstract(spec)).items()}
        got = shardings.decode_cache_specs(pc, cfg, spec, mode)
        assert set(got) == set(want), shape.name
        for key, rule in want.items():
            if key != "pos":
                assert got[key] == rule, (shape.name, key)
        if "conv" in want:
            assert "model" in want["conv"] and "model" in want["ssm"], \
                shape.name
        if shape.kind == "decode":
            batch = input_specs.batch_specs(cfg, shape)
            kept = dryrun._layout(cfg, shape, batch, spec,
                                  mode)["cache_kept_whole"]
            assert kept == {}, (shape.name, kept)
            if shape.global_batch == 1 and "k" in pc:
                assert shardings.spec_axes(got["k"][2:3]) == \
                    batch_axes(spec)
