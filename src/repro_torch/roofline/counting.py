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
name, "optimizer" (``AdamW.update``), and "rest".  A kernel call on the card
or on meta books its ``kernel_model`` work through ``call`` (or
``record_kernel``) and none of the aten ops inside it (the wrapper's
allocations); on the CPU its plain version's aten ops are booked under the
kernel's name, so the other kinds compare across devices.

When no counter is active the kernel wrappers pay one check of ``active``
and nothing else.
"""
from __future__ import annotations

import contextlib
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

PRODUCTS, OPTIMIZER, REST = "products", "optimizer", "rest"
KERNELS = ("flash_attn_fwd", "flash_attn_bwd", "moe_gmm", "moe_gmm_bwd",
           "ssd_intra_chunk", "ssd_intra_chunk_bwd")
_ALLOCATIONS = {torch.ops.aten.empty.memory_format,
                torch.ops.aten.empty_strided.default,
                torch.ops.aten.empty_like.default,
                torch.ops.aten.new_empty.default,
                torch.ops.aten.new_empty_strided.default}
_BOOK, _SKIP = "book", "skip"

# the counter aten ops run under, or None (set by Counter's enter and exit)
active: "Counter | None" = None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _mutates(func) -> bool:
    return any(a.alias_info is not None and a.alias_info.is_write
               for a in func._schema.arguments)


class Counter(TorchDispatchMode):
    """Counts the aten ops that run under it on ``device`` (a device or its
    type: "meta", "cpu", "cuda")."""

    def __init__(self, device) -> None:
        super().__init__()
        self.device_type = torch.device(device).type
        self.kinds: dict[str, dict[str, int]] = {}
        self.calls: dict[str, int] = {}
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

    def summary(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "kinds": {k: dict(v) for k, v in sorted(self.kinds.items())},
                "calls": dict(sorted(self.calls.items())),
                "peak_bytes": self.peak}

    # ------------------------------------------------------------- the mode
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
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
        region = self._regions[-1] if self._regions else None
        if region is not None and region[0] == _SKIP:
            return out
        if func in _ALLOCATIONS or (not fresh and not _mutates(func)):
            return out                      # allocations, views, aliases
        packet = func._overloadpacket
        flops = (flop_registry[packet](*args, **kwargs, out_val=out)
                 if packet in flop_registry else 0)
        nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in fresh)
        if region is not None:
            kind = region[1]
        else:
            kind = PRODUCTS if packet in flop_registry else REST
        self.add(kind, flops, nbytes)
        return out

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
