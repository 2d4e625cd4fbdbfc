"""PyTorch / CUDA port of the repo, for one NVIDIA Hopper card.  It serves
and trains every model family; its TPU kernels become hand-written CUDA
kernels under ``kernels/``.  It also holds WOW itself: the three-step
scheduler, the DPS and the step-1 solver (``core/``), their DPS users
(``data/pipeline.py::WowPrefetchPlanner``,
``runtime/checkpoint.py::ReplicaPlacer``), the mock resource manager and
the Kubernetes dry run (``runtime/``), with the scheduler's dense node and
COP state on the card; and the discrete-event simulator that runs it
(``sim/``: churn, open-loop traffic, topologies, the flow network with its
dense fill on the card) with the paper's workloads (``workloads/``).

The JAX package ``repro`` is the reference: this package imports nothing of
it, nor JAX.  Entry points run on CUDA unless the caller passes another
device; a tensor's device decides between a kernel and its plain version.
"""
