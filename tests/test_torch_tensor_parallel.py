"""Tensor parallelism on torch.distributed (gloo, the CPU) against the JAX
package: the "tp" layout carried out for every leaf that the rules split
over "model", for the dense family (deepseek-7b: MHA; phi4-mini-3.8b: GQA,
whose kv weights stay whole at (1, 4); granite-34b: MQA and GELU) and the
MoE family beside expert parallelism (llama4-scout; with 2 experts, whose
hidden dim the rules split at (1, 4)), on meshes (1, 2),
(1, 4) and (2, 2) of (data, model), f32 smoke configs.  The cases are
``tests/_torch_tp_cases.py``'s (the other families are
tests/test_torch_tensor_parallel_families.py's); this file adds GSPMD's own
"tp" step, the vocabulary-parallel cross-entropy and the argmax.
"""
import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_tp as tt  # noqa: E402
from _torch_tp_cases import *  # noqa: E402,F401,F403
from _torch_tp_cases import TP_REL, leaf_rel, own, ranks  # noqa: E402

from repro_torch.launch.mesh import MeshSpec  # noqa: E402
from repro_torch.launch.shardings import carried  # noqa: E402
from repro_torch.models.common import cross_entropy_loss  # noqa: E402

ARCHS = tt.ARCHS["a"]
CE_REL = 1e-6
CE_MESHES = [(1, 1)] + tt.ALL_MESHES


@pytest.mark.parametrize("gspmd_arch", tt.GSPMD)
def test_gspmd_tp_step_matches(runs, gspmd_arch):
    """JAX's own "tp" step, ``value_and_grad`` of ``train_loss`` jitted with
    ``in_shardings=param_shardings(..., "tp")`` on an Auto (2, 2) mesh,
    gives the unsharded loss and gradients (GSPMD's values do not depend on
    the layout); the port's (2, 2) ranks hold its slices within TP_REL."""
    arch, jx = gspmd_arch, runs["jax"]
    shape = tt.GSPMD_MESH
    t = f"{tt.tag(shape)}/{arch}"
    want = float(jx[f"{arch}/gspmd/loss"])
    assert abs(want - float(jx[f"{arch}/jax/loss"])) <= 1e-6 * abs(want)
    for r, res in enumerate(ranks(runs, shape)):
        assert abs(float(res[f"{t}/train/loss"][0]) - want) <= \
            TP_REL * abs(want)
        for k in jx.files:
            if k.startswith(f"{arch}/gspmd/grad/"):
                n = k.split("/grad/", 1)[1]
                g = jx[k]
                assert leaf_rel(g, jx[f"{arch}/jax/grad/{n}"], g) < TP_REL
                assert leaf_rel(res[f"{t}/train/grad/{n}"],
                                own(g, n, shape, r), g) < TP_REL, n


@pytest.mark.parametrize("ce_shape", CE_MESHES, ids=map(tt.tag, CE_MESHES))
def test_vocab_cross_entropy_is_cross_entropy_loss(runs, ce_shape):
    """(vi) ``vocab_cross_entropy`` of each rank's (B, S, V/nm) slice of
    the logits: the loss of ``cross_entropy_loss`` on the whole logits,
    and the rank's slice of its gradient, within CE_REL at world 1, 2, 4."""
    x = torch.tensor(runs["inputs"]["ce/logits"], requires_grad=True)
    loss = cross_entropy_loss(x, torch.tensor(runs["inputs"]["ce/labels"]))
    loss.backward()
    want, grad = float(loss.detach()), x.grad.numpy()
    shape = ce_shape
    w, nm = int(np.prod(shape)), shape[1]
    part = grad.shape[-1] // nm
    for r in range(w):
        res = runs[w, r]
        assert abs(float(res[f"{tt.tag(shape)}/ce/loss"]) - want) <= \
            CE_REL * want
        m = r % nm
        got = res[f"{tt.tag(shape)}/ce/grad"]
        np.testing.assert_allclose(got, grad[..., m * part:(m + 1) * part],
                                   rtol=0, atol=CE_REL * np.abs(grad).max())


def test_rules_split_what_the_reference_splits_at_full_size():
    """At the reference's (16, 16) mesh: deepseek-7b splits its attention,
    phi4-mini (24 heads) and llama4-scout (40) keep theirs whole, llava
    splits wq and wo (32 heads) but not wk and wv (8), and mamba2's
    (vocab 50280) and whisper's (51865) embeddings stay whole."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import Model
    spec = MeshSpec(tt.AXES, (16, 16))

    def split(arch):
        model = Model(get_config(arch), device="cpu")
        return {n for n, s in model.whole_shapes.items()
                if carried(n, s, spec)}

    assert {"layers.attn.wq", "layers.attn.wk", "layers.attn.wo",
            "embed"} <= split("deepseek-7b")
    for arch in ("phi4-mini-3.8b", "llama4-scout-17b-a16e"):
        assert not {"layers.attn.wq", "layers.attn.wo"} & split(arch)
        assert "layers.moe.w_in" in split(arch) or arch != \
            "llama4-scout-17b-a16e"
    llava = split("llava-next-mistral-7b")
    assert {"layers.attn.wq", "layers.attn.wo"} <= llava
    assert not {"layers.attn.wk", "layers.attn.wv"} & llava
    assert "embed" not in split("mamba2-780m")
    assert "embed" not in split("whisper-medium")


def test_vocab_argmax_takes_the_lowest_tied_id(tmp_path):
    """The greedy token over gathered slices is ``torch.argmax`` of the
    whole row: a tie goes to the lowest id, whichever rank holds it."""
    import torch.distributed as dist

    from repro_torch.launch.collectives import vocab_argmax
    from repro_torch.launch.mesh import make_mesh
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), tt.AXES, device="cpu")
        logits = torch.tensor([[0.0, 3.0, 1.0, 3.0], [2.0, 2.0, 2.0, 2.0]])
        assert vocab_argmax(logits, mesh).tolist() == [1, 0]
    finally:
        dist.destroy_process_group()
