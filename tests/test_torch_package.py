"""Package rules of the PyTorch port: it imports neither JAX nor the JAX
package, and its entry points run on CUDA unless told otherwise."""
import ast
from pathlib import Path

import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, get_smoke  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.lm import FAMILIES  # noqa: E402
from repro_torch.runtime import ServingEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


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


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if get_smoke(a).family not in FAMILIES])
def test_later_families_raise_not_implemented(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Model(get_smoke(arch), device="cpu")


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
