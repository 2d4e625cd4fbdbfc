"""The port's workloads (``repro_torch/workloads``) against the JAX
package's ``repro/workloads`` on the CPU: every registry workflow, built
at two scales and two seeds, equals the reference's through
``bridge.workflow_to_plain``, its consumer sets iterating in the same
order.  The three ML pipelines differ by design in one field: a task's
``compute_time`` comes from the port's H100 roofline, so their reports'
FLOPs and bytes are held to the reference's and their times to
max(FLOPs / 989e12, bytes / 3.35e12, collective bytes / 450e9).  Every
seed is fixed."""
from __future__ import annotations

import math

import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import repro.workloads as RW  # noqa: E402
import repro.workloads.mlpipes as RM  # noqa: E402
import repro_torch.workloads as PW  # noqa: E402
import repro_torch.workloads.mlpipes as PM  # noqa: E402
from repro_torch.bridge import workflow_to_plain  # noqa: E402

COMPUTE = 8          # TaskSpec's compute_time, in field order
CASES = [(s, seed) for s in (0.1, 0.5) for seed in (0, 3)]


def test_registry_names_equal_the_reference():
    assert PW.ALL_WORKFLOWS == RW.ALL_WORKFLOWS
    assert (PW.PATTERNS, PW.SYNTHETIC, PW.REAL_WORLD, PW.MLPIPES) == \
        (RW.PATTERNS, RW.SYNTHETIC, RW.REAL_WORLD, RW.MLPIPES)
    assert len(PW.ALL_WORKFLOWS) == 19
    with pytest.raises(KeyError, match="unknown workflow"):
        PW.make_workflow("nope")


def _consumer_orders(wf):
    return [list(f.consumers) for f in wf.files.values()]


@pytest.mark.parametrize("scale,seed", CASES)
@pytest.mark.parametrize("name", [n for n in RW.ALL_WORKFLOWS
                                  if n not in RW.MLPIPES])
def test_workflow_equals_the_reference(name, scale, seed):
    p = PW.make_workflow(name, scale=scale, seed=seed)
    r = RW.make_workflow(name, scale=scale, seed=seed)
    assert workflow_to_plain(p) == workflow_to_plain(r)
    assert _consumer_orders(p) == _consumer_orders(r)
    assert (p.n_physical(), p.n_abstract(), p.total_input_bytes(),
            p.total_generated_bytes(), p.id_bounds()) == \
        (r.n_physical(), r.n_abstract(), r.total_input_bytes(),
         r.total_generated_bytes(), r.id_bounds())


def _h100_seconds(rep) -> float:
    return max(rep.flops_per_device / 989e12, rep.bytes_per_device / 3.35e12,
               rep.collective_bytes_per_device / 450e9)


@pytest.mark.parametrize("chips", [1, 4])
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "deepseek-7b",
                                  "mamba2-780m"])
def test_pipeline_reports_count_the_reference_and_time_the_h100(arch, chips):
    got = PM.mlpipe_stages(arch, chips=chips)
    want = RM.mlpipe_stages(arch, chips=chips)
    assert list(got) == list(want) == ["train", "prefill", "decode"]
    for kind, rep in got.items():
        ref = want[kind]
        for field in ("arch", "shape", "mesh", "chips", "flops_per_device",
                      "bytes_per_device", "collective_bytes_per_device",
                      "collective_by_kind", "model_flops_global"):
            assert getattr(rep, field) == getattr(ref, field), (kind, field)
        assert rep.compute_s == rep.flops_per_device / 989e12
        assert rep.memory_s == rep.bytes_per_device / 3.35e12
        assert rep.collective_s == rep.collective_bytes_per_device / 450e9
        assert PM.step_seconds(rep) == _h100_seconds(rep)
    assert PM.checkpoint_bytes(PM.get_config(arch)) == \
        RM.checkpoint_bytes(RM.get_config(arch))


@pytest.mark.parametrize("scale,seed", CASES)
@pytest.mark.parametrize("name", RW.MLPIPES)
def test_pipeline_dag_equals_the_reference_but_compute(name, scale, seed):
    """Same tasks, files, edges, sizes, shards and draws; ``compute_time``
    of the train and eval tasks is the H100 roofline's."""
    p = workflow_to_plain(PW.make_workflow(name, scale=scale, seed=seed))
    r = workflow_to_plain(RW.make_workflow(name, scale=scale, seed=seed))
    drop = lambda ts: [t[:COMPUTE] + t[COMPUTE + 1:] for t in ts]  # noqa: E731
    assert drop(p["tasks"]) == drop(r["tasks"])
    assert (p["name"], p["files"], p["edges"]) == \
        (r["name"], r["files"], r["edges"])
    arch = {"mlpipe_phi4": "phi4-mini-3.8b", "mlpipe_deepseek": "deepseek-7b",
            "mlpipe_mamba": "mamba2-780m"}[name]
    reps = PM.mlpipe_stages(arch)
    train_s = _h100_seconds(reps["train"])
    eval_s = PM.EVAL_REQUESTS * (_h100_seconds(reps["prefill"])
                                 + PM.EVAL_DECODE_TOKENS
                                 * _h100_seconds(reps["decode"]))
    tokens = sum(t[5] for t in p["tasks"] if t[1] == "ingest") \
        // PM.TOKEN_BYTES
    steps = max(1, math.ceil(tokens / (PM.BATCH * PM.SEQ)))
    for got, ref in zip(p["tasks"], r["tasks"]):
        if got[1] == "train":
            assert got[COMPUTE] == steps * train_s
            assert got[COMPUTE] < ref[COMPUTE]      # the H100 beats v5e
        elif got[1] == "eval":
            assert got[COMPUTE] == eval_s
        else:
            assert got[COMPUTE] == ref[COMPUTE]
