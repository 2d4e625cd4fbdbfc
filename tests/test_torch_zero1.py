"""ZeRO-1 on torch.distributed (gloo, the CPU) against the JAX package:
in "tp" mode, ``AdamW.init(params, model, zero1=True)`` holds each moment
as the rank's part of the reference's ``opt_shardings(..., zero1=True)``
spec (its largest dim that the parameter's spec leaves whole split over
"data" besides), and ``update`` updates the rank's part of the parameter
and all-gathers the parts over "data".  f32 smoke configs of deepseek-7b,
llama4-scout, mamba2-780m (and with 8 layers) and whisper-medium, on meshes
(1, 2), (2, 1), (1, 4) and (2, 2) of (data, model), each run with and
without ZeRO-1 (``_torch_fsdp.worker``, kind "zero1"), beside the JAX
reference's shard indices in a subprocess with 4 forced host devices.
"""
import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_fsdp as tf  # noqa: E402
from test_torch_fsdp import assemble, ranks, region, spawn_runs  # noqa

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402

KIND = "zero1"
ARCHS = tf.ARCHS[KIND]


def pytest_generate_tests(metafunc):
    if "arch" in metafunc.fixturenames:
        metafunc.parametrize("arch", ARCHS)
    if "shape" in metafunc.fixturenames:
        metafunc.parametrize("shape", tf.ALL_MESHES,
                             ids=map(tf.tag, tf.ALL_MESHES))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return spawn_runs(KIND, (2, 4), tmp_path_factory.mktemp(KIND))


def test_moments_are_the_jax_zero1_shards(runs, arch, shape):
    """Each rank's moments, after step 1 and after the last step, are the
    slice that JAX's ``opt_shardings(..., zero1=True)`` puts on the device
    at the same mesh position, of the whole moments of the same mesh
    without ZeRO-1 (each rank's "tp" part put where JAX's
    ``param_shardings(..., "tp")`` index says), bit for bit; where "data"
    has more than one rank, a moment so split holds 1 / nd of the
    parameter's part."""
    t = f"{tf.tag(shape)}/{arch}"
    pre = f"{arch}/state/"
    inp = runs["inputs"]
    nd = shape[0]
    split = 0
    for k in inp.files:
        if not k.startswith(pre):
            continue
        name, full = k[len(pre):], inp[k]
        for m in ("m1", "v1", "m", "v"):
            whole = assemble(runs, shape, f"{t}/plain/{m}", f"{t}/idx", name,
                             full.shape)
            for r, res in enumerate(ranks(runs, shape)):
                got = res[f"{t}/zero1/{m}/{name}"]
                want = whole[region(runs["jax"][f"{t}/zidx/{name}/{r}"])]
                np.testing.assert_array_equal(got, want.astype(got.dtype),
                                              err_msg=f"{m} {name}")
                param = res[f"{t}/plain/param/{name}"]
                if got.size != param.size:
                    assert got.size * nd == param.size, name
                    split += m == "m" and r == 0
    assert (split > 0) == (nd > 1)


def test_zero1_steps_are_the_same_mesh_without_it(runs, arch, shape):
    """3 ``make_train_step`` steps: the losses, grad norms, every step-1
    gradient leaf and every parameter after the steps are those of the
    same mesh without ZeRO-1, bit for bit (the update is elementwise, in
    the same f32 order, on the rank's part)."""
    t = f"{tf.tag(shape)}/{arch}"
    for res in ranks(runs, shape):
        keys = [k for k in res.files if k.startswith(f"{t}/plain/")
                and k.split("/")[3] in ("loss", "grad_norm", "grad",
                                        "param")]
        assert any("/grad/" in k for k in keys)
        for k in keys:
            np.testing.assert_array_equal(
                res[k.replace("/plain/", "/zero1/")], res[k], err_msg=k)


def test_zero1_needs_a_model_on_a_mesh():
    """ZeRO-1 without a mesh names what it needs rather than keeping
    whole moments."""
    model = Model(get_smoke("deepseek-7b"), device="cpu").init(
        torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    with pytest.raises(ValueError, match="ZeRO-1"):
        AdamW().init(params, model, zero1=True)
    state = AdamW().init(params, model)
    assert all(state["m"][n].shape == p.shape for n, p in params.items())
