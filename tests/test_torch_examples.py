"""The port's examples (``examples/torch_*.py``) on the CPU: each one's
``main`` runs through the port's entry points with ``--device cpu``
(``torch_train_wow_workflow`` at ``--steps 2``), and, without a card,
raises by default as the entry points do.  ``torch_quickstart``'s six
makespans and ``torch_workflow_sim``'s three equal the JAX package's
simulator (``repro.sim``, plain Python) on the same calls."""
import importlib.util
import math
from pathlib import Path

import pytest

np = pytest.importorskip("numpy")
torch = pytest.importorskip("torch")

from repro.sim import SimConfig, Simulation, run_workflow  # noqa: E402
from repro.workloads import make_workflow  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("torch_quickstart", "torch_workflow_sim", "torch_serve_batch",
            "torch_train_wow_workflow")


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_makespans_equal_the_reference():
    got = _example("torch_quickstart").main(["--device", "cpu"])
    wf = make_workflow("chain", scale=1.0)   # one workflow, as the example
    want = {(dfs, s): run_workflow(wf, s, SimConfig(dfs=dfs)).makespan
            for dfs in ("ceph", "nfs") for s in ("orig", "cws", "wow")}
    assert got == want
    assert got["ceph", "wow"] < got["ceph", "orig"]


def test_workflow_sim_makespans_equal_the_reference():
    got = _example("torch_workflow_sim").main(["--device", "cpu"])
    wf = make_workflow("rangeland", scale=0.05)
    cfg = SimConfig(dfs="ceph", n_nodes=4)
    base = Simulation(wf, cfg, "wow").run().makespan
    failed = Simulation(wf, cfg, "wow")
    failed.schedule_failure(base * 0.25, node=2)
    healed = Simulation(wf, cfg, "wow")
    healed.schedule_failure(base * 0.25, node=2)
    healed.schedule_join(base * 0.25 + 60, node_id=4)
    assert got == {"baseline": base, "failed": failed.run().makespan,
                   "healed": healed.run().makespan}


def test_serve_batch_generates_every_token():
    out = _example("torch_serve_batch").main(["--device", "cpu"])
    assert out.shape == (4, 24) and out.dtype == torch.int64
    assert int(out.min()) >= 0 and int(out.max()) < 512   # the smoke vocab


def test_train_wow_workflow_takes_its_steps():
    losses = _example("torch_train_wow_workflow").main(
        ["--device", "cpu", "--steps", "2"])
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_default_to_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _example(name).main([])
