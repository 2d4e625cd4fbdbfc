"""Scenario on the PyTorch port: fault-tolerant workflow execution with WOW.

Runs a real-world-like workflow (nf-core Chip-Seq shape), kills a node a
quarter of the way through, and hot-joins a replacement -- the DPS re-plans
replica placement and the scheduler re-executes lost producers (the paper's
§VIII fault-tolerance future work, implemented).  The scheduler's and the
flow network's tensors lie on ``--device`` (CUDA by default).

    PYTHONPATH=src python examples/torch_workflow_sim.py [--device cpu]
"""
import argparse

from repro_torch.sim import SimConfig, Simulation
from repro_torch.workloads import make_workflow


def main(argv: list[str] | None = None) -> dict:
    """Print the three runs; return their makespans in s."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    wf = make_workflow("rangeland", scale=0.05)
    cfg = SimConfig(dfs="ceph", n_nodes=4)

    base = Simulation(wf, cfg, "wow", device=args.device).run()
    print(f"baseline:           {base.makespan / 60:6.1f} min, "
          f"{base.tasks_total} tasks on 4 nodes")

    sim = Simulation(wf, cfg, "wow", device=args.device)
    sim.schedule_failure(base.makespan * 0.25, node=2)
    failed = sim.run()
    print(f"node 2 dies at 25%: {failed.makespan / 60:6.1f} min, "
          f"{failed.tasks_total} tasks completed "
          f"(+{100 * (failed.makespan - base.makespan) / base.makespan:.0f}%"
          f" makespan; lost outputs re-executed)")

    sim2 = Simulation(wf, cfg, "wow", device=args.device)
    sim2.schedule_failure(base.makespan * 0.25, node=2)
    sim2.schedule_join(base.makespan * 0.25 + 60, node_id=4)
    healed = sim2.run()
    print(f"... + hot spare:    {healed.makespan / 60:6.1f} min "
          f"(elastic join recovers "
          f"{100 * (failed.makespan - healed.makespan) / failed.makespan:.0f}"
          f"% of the loss)")
    return {"baseline": base.makespan, "failed": failed.makespan,
            "healed": healed.makespan}


if __name__ == "__main__":
    main()
