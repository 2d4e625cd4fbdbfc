"""The ranks of "model" as threads of one process, for the CPU tests that
need no process group: the mamba block split over "model"
(tests/test_torch_mamba_split.py) and llava's sequence split with a rank
of pads only (tests/test_torch_seq_pads.py).

Each rank runs ``fn(rank)`` in a thread of its own and meets the others at
a barrier at each collective.  Under ``patched`` the port's collectives in
``models/ssm.py`` and ``models/common.py`` are torch ops on every rank's
tensors (a sum in rank order, a concatenation, the columns each rank
names cut from every rank's slice), so that one backward from the main
thread over the ranks' outputs runs every rank's backward and each
collective's as its transpose; ``all_to_all_v`` stands in for
``launch/collectives._all_to_all_v`` and keeps the column exchange's own
autograd Function, whose backward then runs in each rank's thread.  The
port's code sees a (1, n) mesh of ("data", "model") in ``mode`` and its
rank over "model" (``common.seq_rank``).  Under ``patched_seq`` it sees
the sequence split over "model" in "fsdp" mode with every leaf whole
(``fsdp_mesh`` None), and ``log`` keeps, rank by rank, the shape of each
part that the rank handed a collective.
"""
from __future__ import annotations

import threading
from contextlib import ExitStack
from unittest import mock

import torch

AXES = ("data", "model")


class Ranks:
    def __init__(self, n: int):
        self.n = n
        self.barrier = threading.Barrier(n, timeout=120)
        self.box: list = [None] * n
        self.local = threading.local()
        self.log: list = [[] for _ in range(n)]

    @property
    def rank(self) -> int:
        return self.local.rank

    def run(self, fn) -> list:
        """``fn(rank)`` in each rank's thread, with grad as the calling
        thread has it; the results in rank order."""
        out, errors = [None] * self.n, []
        grad = torch.is_grad_enabled()

        def body(r):
            self.local.rank = r
            try:
                with torch.set_grad_enabled(grad):
                    out[r] = fn(r)
            except BaseException as e:      # noqa: BLE001 (re-raised below)
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(r,), daemon=True)
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads), "a rank hung"
        if errors:
            raise next((e for e in errors
                        if not isinstance(e, threading.BrokenBarrierError)),
                       errors[0])
        return out

    def exchange(self, x) -> list:
        """Every rank's ``x`` of this collective, in rank order."""
        self.log[self.rank].append(tuple(x.shape) if isinstance(
            x, torch.Tensor) else len(x))
        self.box[self.rank] = x
        self.barrier.wait()
        parts = list(self.box)
        self.barrier.wait()
        return parts

    # ------------------------------------------------ the collectives
    def all_reduce(self, x, mesh, axes, grad_scale: float = 1.0):
        parts = self.exchange(x)
        out = parts[0]
        for p in parts[1:]:                  # in rank order
            out = out + p
        return out

    def copy_to(self, x, mesh, axis: str):
        return x

    def gather_leaf(self, x, mesh, dim: int, axes="model"):
        return torch.cat(self.exchange(x), dim)

    def seq_gather(self, x, mesh, axis: str, dim: int):
        return torch.cat(self.exchange(x), dim)

    def exchange_columns(self, x, mesh, axis: str, dim: int, want: tuple):
        """The ranges ``want[rank]`` cut from every rank's slice."""
        parts, held = self.exchange(x), x.shape[dim]
        pieces = []
        for a, b in want[self.rank]:
            for q, part in enumerate(parts):
                lo, hi = max(a, q * held), min(b, (q + 1) * held)
                if lo < hi:
                    pieces.append(part.narrow(dim, lo - q * held, hi - lo))
        return torch.cat(pieces, dim)

    def all_to_all_v(self, x, dim: int, recv: tuple, send: tuple, ax):
        parts = self.exchange(list(x.split(list(send), dim)))
        return torch.cat([p[self.rank] for p in parts], dim).contiguous()

    def seq_rank(self, mesh, axes, coord=None):
        return (self.rank, self.n) if "model" in axes else (0, 1)

    def mesh(self):
        from repro_torch.launch.mesh import MeshSpec
        return MeshSpec(AXES, (1, self.n))

    def patched(self, mode: str = "tp") -> ExitStack:
        from repro_torch.models import common, ssm
        stack = ExitStack()
        for mod, names in ((ssm, ("all_reduce", "copy_to", "gather_leaf",
                                  "exchange_columns")),
                           (common, ("all_reduce", "copy_to", "seq_gather",
                                     "seq_rank"))):
            for name in names:
                stack.enter_context(mock.patch.object(mod, name,
                                                      getattr(self, name)))
        stack.enter_context(common.use_mesh(self.mesh(), mode, rows=()))
        return stack

    def patched_seq(self, whole: tuple = ()) -> ExitStack:
        """The sequence over the ranks of "model" of a (1, n) mesh in
        "fsdp" mode, its leaves whole, the batch leaves ``whole`` whole
        beside it: the port's gathers of the sequence (attention's k/v,
        ``lm``'s embeddings and labels, ``collectives.seq_last``) among the
        threads."""
        from repro_torch.launch import collectives
        from repro_torch.launch.mesh import MeshSpec
        from repro_torch.models import attention, common, lm
        stack = ExitStack()
        for mod in (collectives, attention, lm):
            stack.enter_context(mock.patch.object(mod, "gather_leaf",
                                                  self.gather_leaf))
        stack.enter_context(mock.patch.object(common, "seq_rank",
                                              self.seq_rank))
        stack.enter_context(mock.patch.object(common, "fsdp_mesh",
                                              lambda: None))
        stack.enter_context(common.use_mesh(
            MeshSpec(AXES, (1, self.n)), "fsdp", rows=(), seq=("model",),
            whole=whole))
        return stack
