"""Package rules of the PyTorch port: it (its examples and chip_smoke.py
too) imports neither JAX nor the JAX package, and its entry points run on
CUDA unless told otherwise."""
import ast
from pathlib import Path

import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch.configs import ARCHS, get_smoke  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.api import flatten  # noqa: E402
from repro_torch.models.lm import FAMILIES  # noqa: E402
from repro_torch.runtime import ServingEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"] + sorted(
            (ROOT / "examples").glob("torch_*.py"))


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_no_jax_and_no_repro():
    files = _port_files()
    assert len(files) > 10 and all(f.exists() for f in files)
    assert ROOT / "src" / "repro_torch" / "models" / "encdec.py" in files
    assert len([f for f in files if f.parent.name == "examples"]) == 4
    bad = {str(f.relative_to(ROOT)): sorted(_imported_roots(f) & FORBIDDEN)
           for f in files if _imported_roots(f) & FORBIDDEN}
    assert not bad, bad


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke("deepseek-7b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(cfg)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke"])


# a parameter name that only its family's tree has
FAMILY_MARK = {"dense": "layers.mlp.w_in", "moe": "layers.moe.w_in",
               "ssm": "layers.in_proj", "hybrid": "shared.attn.wq",
               "encdec": "dec_layers.xattn.wq", "vlm": "projector"}
BUILT_ON = {"hybrid": {"ssm"}, "vlm": {"dense"}}


@pytest.mark.parametrize("arch", ARCHS)
def test_every_family_builds(arch):
    """Every arch builds (on the meta device) with the state-dict names and
    shapes of the JAX package's parameter tree."""
    cfg = get_smoke(arch)
    assert cfg.family == "encdec" or cfg.family in FAMILIES
    got = {n: tuple(p.shape)
           for n, p in Model(cfg, device="cpu").named_parameters()}
    tree = jax.eval_shape(JaxModel(jax_smoke(arch)).init,
                          jax.random.PRNGKey(0))
    assert got == {n: tuple(x.shape) for n, x in flatten(tree).items()}
    marks = {f for f, name in FAMILY_MARK.items() if name in got}
    # the hybrid's mamba layers are the ssm family's, the VLM's stack the
    # dense one
    assert marks == {cfg.family} | BUILT_ON.get(cfg.family, set())


def test_unknown_family_raises():
    cfg = get_smoke("deepseek-7b").replace(family="diffusion")
    with pytest.raises(ValueError, match="diffusion"):
        Model(cfg, device="cpu")


@pytest.mark.parametrize("arch", ["arctic-480b", "llama4-scout-17b-a16e"])
def test_moe_family_builds(arch):
    cfg = get_smoke(arch)
    assert cfg.family == "moe" and cfg.family in FAMILIES
    names = dict(Model(cfg, device="cpu").named_parameters())
    assert "layers.moe.w_in" in names and "layers.mlp.w_in" not in names


def test_ssm_family_builds():
    cfg = get_smoke("mamba2-780m").replace(param_dtype="bfloat16",
                                           compute_dtype="bfloat16")
    assert cfg.family == "ssm" and cfg.family in FAMILIES
    params = dict(Model(cfg, device="cpu").named_parameters())
    assert {n.split(".", 1)[1] for n in params if n.startswith("layers.")} \
        == {"ln", "in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias",
            "norm", "out_proj"}
    assert not any("attn" in n for n in params)
    assert {n for n, p in params.items() if p.dtype == torch.float32} == {
        "layers.A_log", "layers.D", "layers.dt_bias"}
    assert all(p.shape[0] == cfg.n_layers for n, p in params.items()
               if n.startswith("layers."))
