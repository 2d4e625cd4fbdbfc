"""The scheduler's drain reduction twin in PyTorch (``repro_torch/core/
copmatrix.py::torch_winner``) against the JAX package's numpy path and its
JAX twin (``repro/core/copmatrix.py::_jax_winner``).

The twin is injected where the JAX one goes, ``BlockedDrainKernel.
_winner_jit``, by patching ``_jax_winner`` and running the scheduler with
``batched="jax"``: ``repro/core`` is not edited.  The twin reduces tensors,
so the injected call wraps the reference's numpy rows.  It must leave every
decision of the full simulation as the numpy reduction makes it."""
import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import repro.core.copmatrix as copmatrix  # noqa: E402
from repro_torch.core import torch_winner  # noqa: E402

BIG = np.iinfo(np.int64).max


def _t(a):
    return torch.from_numpy(a)


def _sim_run(batched, *, workflow="group", scale=0.6, n_nodes=14, seed=0,
             churn=False, topology=None):
    """tests/test_copmatrix.py's run: (action log, makespan, steps, COPs)."""
    from repro.sim import SimConfig, Simulation
    from repro.workloads import make_workflow

    wf = make_workflow(workflow, scale=scale, seed=seed)
    sim = Simulation(wf, SimConfig(n_nodes=n_nodes, dfs="ceph", seed=seed,
                                   batched=batched, topology=topology),
                     "wow")
    if churn:
        sim.schedule_failure(15.0, 3)
        sim.schedule_join(30.0, n_nodes)
    r = sim.run()
    return sim.action_log, r.makespan, r.sim_steps, r.cops_created


@pytest.fixture
def torch_twin(monkeypatch):
    """The scheduler's ``batched="jax"`` drain on the torch twin (CPU)."""
    calls = []
    winner = torch_winner("cpu")

    def counted(key, ids):
        calls.append(len(key))
        return winner(_t(key), _t(ids))

    monkeypatch.setattr(copmatrix, "_jax_winner", lambda: counted)
    return calls


@pytest.mark.parametrize("workflow", ["group", "fork", "syn_montage",
                                      "chipseq"])
@pytest.mark.parametrize("churn", [False, True])
def test_full_sim_bit_identity(torch_twin, workflow, churn):
    want = _sim_run(True, workflow=workflow, churn=churn)
    got = _sim_run("jax", workflow=workflow, churn=churn)
    assert torch_twin, "the twin was never called"
    assert got == want


def test_full_sim_bit_identity_topology(torch_twin):
    from repro.sim import TopologySpec
    topo = TopologySpec(rack_size=4, racks_per_site=2)
    for churn in (False, True):
        want = _sim_run(True, topology=topo, churn=churn)
        assert _sim_run("jax", topology=topo, churn=churn) == want
    assert torch_twin


def _staged(key, ids) -> int:
    m0 = key.min()
    return int(np.where(key == m0, ids, BIG).min())


@pytest.mark.parametrize("kind", ["float", "int"])
def test_padding_unit(kind):
    """tests/test_copmatrix.py::test_jax_winner_padding_unit's sizes, with
    float64 and int64 keys: the twin, the staged numpy reduction and the
    JAX twin, which pads to a power of two, agree (the x64 flag the JAX
    twin sets is restored)."""
    winner = torch_winner("cpu")
    prev_x64 = jax.config.jax_enable_x64
    try:
        jax_winner = copmatrix._jax_winner()
        rng = np.random.default_rng(0)
        for n in (1, 3, 7, 16, 33):
            key = rng.integers(0, 5, n)
            key = key.astype(np.float64 if kind == "float" else np.int64)
            ids = rng.permutation(n).astype(np.int64)
            want = _staged(key, ids)
            assert winner(_t(key), _t(ids)) == want
            assert jax_winner(key, ids) == want
    finally:
        jax.config.update("jax_enable_x64", prev_x64)


def test_ties_inf_and_int64_edges():
    """Keys of +inf (every candidate, and beside finite ones), int64 keys
    at int64 max (the JAX twin's pad key) and ids near it."""
    winner = torch_winner("cpu")
    inf = np.inf
    cases = [
        (np.array([inf, inf, inf]), np.array([7, 3, 5])),
        (np.array([inf, 2.0, 2.0, inf, 2.0]), np.array([0, 9, 4, 1, 6])),
        (np.array([BIG, BIG, BIG], np.int64), np.array([8, 2, 5])),
        (np.array([BIG, BIG - 1, BIG - 1], np.int64),
         np.array([0, BIG - 1, BIG - 2])),
        (np.array([-1.5, -inf, -inf]), np.array([2, 11, 10])),
    ]
    for key, ids in cases:
        ids = ids.astype(np.int64)
        assert winner(_t(key), _t(ids)) == _staged(key, ids), (key, ids)


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.float16,
                                   np.uint64])
def test_other_dtypes_refused(dtype):
    winner = torch_winner("cpu")
    with pytest.raises(TypeError, match="float64 or int64"):
        winner(_t(np.zeros(4, dtype)), _t(np.arange(4, dtype=np.int64)))


def test_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_winner()
