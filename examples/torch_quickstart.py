"""Quickstart on the PyTorch port: the WOW scheduler in 60 seconds.

Runs the paper's "chain" pattern workflow under all three schedulers on a
simulated 8-node / 1 Gbit cluster and prints the makespan comparison
(paper Table II: WOW cuts chain makespan by 86-94%).  The scheduler's and
the flow network's tensors lie on ``--device`` (CUDA by default; without a
card it raises, as the port's entry points do).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

from repro_torch.sim import SimConfig, run_workflow
from repro_torch.workloads import make_workflow


def main(argv: list[str] | None = None) -> dict:
    """Print the comparison; return {(dfs, strategy): makespan in s}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    wf = make_workflow("chain", scale=1.0)
    print(f"workflow: {wf.name} ({wf.n_physical()} tasks, "
          f"{wf.total_generated_bytes() / 1e9:.0f} GB generated)\n")
    makespans = {}
    for dfs in ("ceph", "nfs"):
        base = None
        for strategy in ("orig", "cws", "wow"):
            r = run_workflow(wf, strategy, SimConfig(dfs=dfs),
                             device=args.device)
            makespans[dfs, strategy] = r.makespan
            if strategy == "orig":
                base = r.makespan
            delta = 100 * (r.makespan - base) / base
            extra = ""
            if strategy == "wow":
                extra = (f"  [{r.pct_no_cop:.0f}% tasks needed no COP, "
                         f"{r.network_bytes / 1e9:.1f} GB over network]")
            print(f"  {dfs:4s} {strategy:4s}: {r.makespan / 60:6.1f} min "
                  f"({delta:+6.1f}%){extra}")
        print()
    return makespans


if __name__ == "__main__":
    main()
