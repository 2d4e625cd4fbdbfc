"""Counting what a step does: FLOPs and HBM bytes by kind, kernel calls, and
the peak of live device bytes.  The counterpart of the reference's
``roofline/hlo_analysis.py``, which reads them from compiled HLO; here a
``TorchDispatchMode`` sees every aten op that runs under it, on the meta
device (the dry run), on the CPU or on the card.

    with Counter("meta") as c:
        step(...)
    c.kinds     # {kind: {"flops": int, "bytes": int}}
    c.calls     # {kernel name: calls of its wrapper}
    c.peak      # most bytes of the step's own storages alive at once

Rules, per aten op:
- FLOPs: the formulas of ``torch.utils.flop_counter`` (matrix products,
  convolutions, attention); every other op counts none.
- bytes: operands plus results (a tensor's elements times its item size),
  with views and aliasing ops free, allocations (``empty``) free, and an
  in-place op's mutated operand counted once.
- only ops that touch a tensor on the counter's device count: a CUDA step's
  host-side ops (the RNG state remat stashes) are not device work.

Kinds: "products" (ops with a FLOP formula), each hand-written kernel by
name, "optimizer" (``AdamW.update``), "collectives" (the HBM traffic of a
collective's result, as the reference's ``hbm_bytes += cb(ins.shape)``
books it) and "rest".  A kernel call on the card
or on meta books its ``kernel_model`` work through ``call`` (or
``record_kernel``) and none of the aten ops inside it (the wrapper's
allocations); on the CPU its plain version's aten ops are booked under the
kernel's name, so the other kinds compare across devices.

Collectives (``c10d`` all-reduce, all-gather and reduce-scatter, the
functional all-to-all, whose parts may differ in size: the column exchange
of ``launch/collectives.exchange_columns``), on any process group (NCCL,
gloo, or the "fake" backend of the mesh dry run), are booked under the
reference's kind names at its ring costs for the group's n ranks
(``repro/roofline/hlo_analysis.py::_collective_link_bytes``): all-reduce 2
(n-1)/n of its size, all-gather and all-to-all (n-1)/n of the result,
reduce-scatter (n-1) times the result shard.  These link bytes are counted
by kind, by mesh axis (the axis the port's collectives name, ``backend``;
else the group's axis on ``mesh``, else its description) and by (kind,
axis) calls; ``collective_shapes`` lists each call's (kind, axis, result
shape) in order (not in the summary).  A group of one rank books its call
and 0 link bytes.

When no counter is active the kernel wrappers pay one check of ``active``
and nothing else.
"""
from __future__ import annotations

import contextlib
import weakref

import torch
from torch.distributed import distributed_c10d
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

PRODUCTS, OPTIMIZER, REST = "products", "optimizer", "rest"
COLLECTIVES = "collectives"
KERNELS = ("flash_attn_fwd", "flash_attn_bwd", "moe_gmm", "moe_gmm_bwd",
           "ssd_intra_chunk", "ssd_intra_chunk_bwd")
_ALLOCATIONS = {torch.ops.aten.empty.memory_format,
                torch.ops.aten.empty_strided.default,
                torch.ops.aten.empty_like.default,
                torch.ops.aten.new_empty.default,
                torch.ops.aten.new_empty_strided.default}
_BOOK, _SKIP, _BACKEND, _UNBOOKED = "book", "skip", "backend", "unbooked"
# the collectives' ops, torch 2.13's renamed entry points included
# (``dist.all_gather_single`` and ``reduce_scatter_single`` dispatch as the
# old ``_base_`` ops), under the reference's kind names
_COLLECTIVE_OPS = {"c10d::allreduce_": "all-reduce",
                   "c10d::_allgather_base_": "all-gather",
                   "c10d::_reduce_scatter_base_": "reduce-scatter",
                   "_c10d_functional::all_reduce": "all-reduce",
                   "_c10d_functional::all_gather_into_tensor": "all-gather",
                   "_c10d_functional::reduce_scatter_tensor":
                       "reduce-scatter",
                   "_c10d_functional::all_to_all_single": "all-to-all"}
# a functional collective's completion, no work of its own (a backend may
# hand back a new tensor or the same one)
_COMPLETIONS = {"_c10d_functional::wait_tensor",
                "_c10d_functional::_wrap_tensor_autograd"}

# the counter aten ops run under, or None (set by Counter's enter and exit)
active: "Counter | None" = None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def ring_bytes(kind: str, n: int, result_bytes: int) -> float:
    """A collective's link bytes per device at the reference's ring costs,
    ``result_bytes`` its result's (an all-reduce's tensor, an all-gather's
    whole output, a reduce-scatter's shard, an all-to-all's output)."""
    frac = (n - 1) / max(n, 1)
    if kind == "all-reduce":
        return 2.0 * frac * result_bytes
    if kind == "reduce-scatter":
        return float((n - 1) * result_bytes)
    return frac * result_bytes          # all-gather, all-to-all


def _group(func, args, kwargs):
    """The process group a collective op runs on, from its schema's
    "process_group" (a boxed group) or "group_name" (a registered name)."""
    for i, a in enumerate(func._schema.arguments):
        v = args[i] if i < len(args) else kwargs.get(a.name)
        if a.name == "process_group":
            return torch._C._distributed_c10d.ProcessGroup.unbox(v)
        if a.name == "group_name":
            return distributed_c10d._resolve_process_group(v)
    raise RuntimeError(f"{func}: no process group among its arguments")


def _result(func, args, kwargs, out) -> torch.Tensor:
    """The collective's result tensor: the in-place ops' output operand
    (``output_tensor``, or the all-reduce's tensor), else what it returns."""
    names = [a.name for a in func._schema.arguments]
    for name in ("output_tensor", "tensors"):
        if name in names:
            i = names.index(name)
            v = args[i] if i < len(args) else kwargs[name]
            return v[0] if isinstance(v, (list, tuple)) else v
    return out


def _mutates(func) -> bool:
    return any(a.alias_info is not None and a.alias_info.is_write
               for a in func._schema.arguments)


class Counter(TorchDispatchMode):
    """Counts the aten ops that run under it on ``device`` (a device or its
    type: "meta", "cpu", "cuda")."""

    def __init__(self, device, mesh=None) -> None:
        super().__init__()
        self.device_type = torch.device(device).type
        self.kinds: dict[str, dict[str, int]] = {}
        self.calls: dict[str, int] = {}
        # link bytes by kind and by axis, calls by kind and by (kind, axis)
        self.collective_by_kind: dict[str, float] = {}
        self.collective_by_axis: dict[str, float] = {}
        self.collective_counts: dict[str, int] = {}
        self.collective_calls: dict[str, int] = {}
        self.collective_shapes: list[tuple[str, str, tuple]] = []
        # the axis of each of ``mesh``'s groups, by the group's name
        self._axes = {} if mesh is None else {
            mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}
        # the "rest" kind's bytes by aten op, which tell two torch versions'
        # counts apart.  One such difference: the backward of
        # ``torch.topk`` (``models/mlp.py``'s router) allocates its zeros by
        # ``aten.zeros`` on torch 2.11 and by ``aten.new_zeros`` on 2.13,
        # whose template operand (the top values' gradient) is booked too:
        # llama4-scout's train_4k fsdp rank books 786432 bytes more on 2.13
        # (48 layers of a (16, 256, 1) f32 gradient into (16, 256, 16))
        self.rest_by_op: dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self._regions: list[tuple[str, str]] = []
        self._storages: dict[int, int] = {}

    # ----------------------------------------------------------- enter/exit
    def __enter__(self):
        global active
        if active is not None:
            raise RuntimeError("a Counter is already active")
        active = self
        return super().__enter__()

    def __exit__(self, *exc):
        global active
        active = None
        return super().__exit__(*exc)

    # --------------------------------------------------------------- totals
    def add(self, kind: str, flops: int, nbytes: int) -> None:
        k = self.kinds.setdefault(kind, {"flops": 0, "bytes": 0})
        k["flops"] += int(flops)
        k["bytes"] += int(nbytes)

    @property
    def flops(self) -> int:
        return sum(k["flops"] for k in self.kinds.values())

    @property
    def bytes(self) -> int:
        return sum(k["bytes"] for k in self.kinds.values())

    def _add_collective(self, kind: str, axis: str,
                        link_bytes: float) -> None:
        self.collective_by_kind[kind] = \
            self.collective_by_kind.get(kind, 0.0) + link_bytes
        self.collective_by_axis[axis] = \
            self.collective_by_axis.get(axis, 0.0) + link_bytes
        self.collective_counts[kind] = self.collective_counts.get(kind, 0) + 1
        key = f"{kind}/{axis}"
        self.collective_calls[key] = self.collective_calls.get(key, 0) + 1

    def summary(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "kinds": {k: dict(v) for k, v in sorted(self.kinds.items())},
                "calls": dict(sorted(self.calls.items())),
                "peak_bytes": self.peak,
                "collective_bytes": sum(self.collective_by_kind.values()),
                "collective_by_kind": dict(sorted(
                    self.collective_by_kind.items())),
                "collective_counts": dict(sorted(
                    self.collective_counts.items())),
                "collective_by_axis": dict(sorted(
                    self.collective_by_axis.items())),
                "collective_calls": dict(sorted(
                    self.collective_calls.items())),
                "rest_by_op": dict(sorted(self.rest_by_op.items()))}

    # ------------------------------------------------------------- the mode
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        coll = _COLLECTIVE_OPS.get(func._schema.name)
        region = self._regions[-1] if self._regions else None
        mode = None if region is None else region[0]
        if coll is not None and mode == _SKIP:
            raise RuntimeError(f"{func} inside {region[1]}: a kernel's call "
                               f"runs no collective")
        out = func(*args, **kwargs)
        if mode == _UNBOOKED:
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        dev = self.device_type
        if not any(t.device.type == dev for t in ins + outs):
            return out
        in_storages = {id(t.untyped_storage()) for t in ins}
        fresh = [t for t in outs
                 if id(t.untyped_storage()) not in in_storages]
        self._track(fresh)
        if coll is not None:
            self._collective(coll, func, args, kwargs, out,
                             region[1] if mode == _BACKEND else "")
            return out
        if mode in (_SKIP, _BACKEND):
            return out
        if func in _ALLOCATIONS or func._schema.name in _COMPLETIONS or (
                not fresh and not _mutates(func)):
            return out                      # allocations, views, aliases
        packet = func._overloadpacket
        flops = (flop_registry[packet](*args, **kwargs, out_val=out)
                 if packet in flop_registry else 0)
        nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in fresh)
        if region is not None:
            kind = region[1]
        else:
            kind = PRODUCTS if packet in flop_registry else REST
        if kind == REST:
            name = str(packet)
            self.rest_by_op[name] = self.rest_by_op.get(name, 0) + nbytes
        self.add(kind, flops, nbytes)
        return out

    def _collective(self, kind: str, func, args, kwargs, out,
                    axis: str) -> None:
        """Book one collective: its link bytes at the ring cost of its
        group's size, by kind and by ``axis`` (else the group's axis on the
        counter's mesh, else its description), and its result's HBM
        traffic."""
        group = _group(func, args, kwargs)
        res = _result(func, args, kwargs, out)
        nbytes = _nbytes(res)
        axis = axis or self._axes.get(group.group_name, group.group_desc)
        self._add_collective(kind, axis,
                             ring_bytes(kind, group.size(), nbytes))
        self.collective_shapes.append((kind, axis, tuple(res.shape)))
        self.add(COLLECTIVES, 0, nbytes)

    def _track(self, fresh: list) -> None:
        """Live bytes of the storages the step allocates, each freed when
        its storage dies (autograd's and remat's own lifetimes)."""
        for t in fresh:
            if t.device.type != self.device_type:
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._storages:
                continue
            nb = st.nbytes()
            self._storages[key] = nb
            self.live += nb
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    @contextlib.contextmanager
    def region(self, mode: str, name: str):
        self._regions.append((mode, name))
        try:
            yield
        finally:
            self._regions.pop()


def record_kernel(name: str, flops: int, nbytes: int) -> None:
    """Book one call of kernel ``name`` and its work, if a counter is
    active."""
    if active is not None:
        active.add(name, flops, nbytes)
        active.calls[name] = active.calls.get(name, 0) + 1


def region(name: str):
    """A context that books the aten work inside it under ``name`` (the
    optimizer's update), or does nothing when no counter is active."""
    if active is None:
        return contextlib.nullcontext()
    return active.region(_BOOK, name)


def backend(axis: str = ""):
    """A context around a collective's call on mesh axis ``axis``: the
    collective is booked under that axis (two axes of one rank share the
    world's group), and its backend's own aten work is the collective's,
    not booked (gloo's reduce-scatter copies the rank's part out when the
    call waits, after its op has returned)."""
    if active is None:
        return contextlib.nullcontext()
    return active.region(_BACKEND, axis)


def unbooked():
    """A context whose aten work is neither booked nor held live: a
    model's shapes built on meta once for a cache, which is not the step's
    work nor its memory."""
    if active is None:
        return contextlib.nullcontext()
    return active.region(_UNBOOKED, "unbooked")


def call(name: str, device: torch.device, work, fn, *args):
    """``fn(*args)`` as one call of kernel ``name`` while a counter is
    active.  On the card and on meta: ``work()`` (its ``kernel_model``
    (flops, bytes)) is booked and the aten ops inside are not.  On the CPU,
    where ``fn`` takes the plain version, its aten work is booked under
    ``name``."""
    counter = active
    if device.type == "cpu":
        counter.calls[name] = counter.calls.get(name, 0) + 1
        with counter.region(_BOOK, name):
            return fn(*args)
    record_kernel(name, *work())
    with counter.region(_SKIP, name):
        return fn(*args)
