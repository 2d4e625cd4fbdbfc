"""Continuous-batching serving engine.

The WOW idea applied to inference: the *slot* is the resource, the request
is the task, and prefill is the "COP" that prepares a slot while decode
steps for other requests keep running.  A fixed pool of B cache slots
decodes in lock-step; freed slots are refilled from a priority queue
(shortest-prompt-first by default, mirroring the paper's input-size
prioritization) without stopping the decode batch.

Host orchestration around the model's prefill and decode steps.  The slot
cache is allocated in the config's compute dtype and updated in place.

A request is a token prompt, so the engine serves the families whose prefill
takes only tokens: dense, MoE, SSM and hybrid.  The encoder-decoder (audio
frames) and the VLM (image patches) are served by the batched loop of
``launch/serve.py``, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from .. import telemetry
from ..launch.steps import make_serve_step
from ..models import Model
from ..models.common import require_device

# families whose prefill takes more than a token prompt
PREFILL_NEEDS = {"encdec": "audio frames", "vlm": "image patches"}


@dataclasses.dataclass
class Request:
    id: int
    prompt: np.ndarray            # (len,) int
    max_new: int = 16
    priority: float = 0.0         # smaller = sooner
    submitted: float | None = None  # telemetry's clock at submit, if on

    def __lt__(self, other: "Request") -> bool:
        return (self.priority, self.id) < (other.priority, other.id)


@dataclasses.dataclass
class Completion:
    id: int
    tokens: list[int]


class ServingEngine:
    """Slot-based continuous batching with greedy decoding.

    Runs where ``model`` lives, which must be ``device`` (CUDA unless the
    caller names another device).  A model on a mesh (``Model(cfg,
    mesh=...)``) serves the same requests on every rank, each rank with its
    own slices of the leaves; its prefill and decode steps run under the
    mesh, and the greedy token of the vocabulary's slices is alike on every
    rank (``Model.greedy``)."""

    def __init__(self, model: Model, slots: int = 4, max_len: int = 128,
                 device="cuda") -> None:
        if model.cfg.family in PREFILL_NEEDS:
            raise ValueError(
                f"{model.cfg.name}: a {model.cfg.family} prefill needs "
                f"{PREFILL_NEEDS[model.cfg.family]} besides tokens; serve it "
                f"with repro_torch.launch.serve (the batched loop)")
        device = require_device(device)
        if model.device != device:
            raise ValueError(f"model is on {model.device}, engine asked to "
                             f"run on {device}")
        self.cfg = model.cfg
        self.model = model
        self.device = device
        self.slots = slots
        self.max_len = max_len
        self.cache = model.init_decode_cache(slots, max_len)
        self._decode = make_serve_step(model, whole=True)
        self._queue: list[Request] = []
        self._active: dict[int, dict] = {}      # slot -> request state
        self._free = list(range(slots))
        self._last_tok = np.zeros((slots, 1), np.int64)
        self._done: list[Completion] = []
        self._next_id = 0

    # ----------------------------------------------------------------- API
    def submit(self, prompt: np.ndarray, max_new: int = 16,
               priority: float | None = None) -> int:
        """Queue a request.  Raises if it cannot fit the slot cache
        (``len(prompt) + max_new > max_len``): the JAX engine drops cache
        writes past the end silently, torch indexing would fail mid-decode."""
        if len(prompt) + max_new > self.max_len:
            raise ValueError(f"prompt of {len(prompt)} + max_new {max_new} "
                             f"exceeds max_len {self.max_len}")
        rid = self._next_id
        self._next_id += 1
        pr = float(len(prompt)) if priority is None else priority
        heapq.heappush(self._queue,
                       Request(rid, np.asarray(prompt, np.int64), max_new,
                               pr, telemetry.stamp()))
        return rid

    def step(self) -> list[Completion]:
        """Admit waiting requests into free slots (prefill), run one decode
        step for all active slots, retire finished requests.

        Spans (``telemetry``): ``engine.step`` (queued, active and free
        slots as it starts; the allocator's ``mallocs``) holds one
        ``engine.admit`` a request, ``engine.decode`` (``rows``, stream
        time), ``engine.read`` (the host waiting for the step's tokens)
        and one ``engine.retire`` a finished request."""
        with telemetry.span("engine.step", allocator=self.device,
                            queued=len(self._queue), active=len(self._active),
                            free=len(self._free)):
            self._admit()
            out: list[Completion] = []
            if self._active:
                tok = torch.as_tensor(self._last_tok, device=self.device)
                with telemetry.span("engine.decode", device=self.device,
                                    rows=len(self._active)):
                    next_tok, self.cache = self._decode(tok, self.cache)
                with telemetry.span("engine.read"):
                    nxt = next_tok.cpu().numpy()
                for slot, st in list(self._active.items()):
                    t = int(nxt[slot, 0])
                    st["tokens"].append(t)
                    if len(st["tokens"]) >= st["req"].max_new:
                        out.append(self._retire(slot))
                    else:
                        self._last_tok[slot, 0] = t
                # free slots decode too (lock-step batch) and their output
                # is dropped; rewind them so their cache writes stay inside
                # max_len
                if self._free:
                    self.cache["pos"][self._free] = 0
            self._done.extend(out)
        return out

    def run_until_drained(self, max_steps: int = 10_000) -> list[Completion]:
        steps = 0
        while (self._queue or self._active) and steps < max_steps:
            self.step()
            steps += 1
        return self._done

    @property
    def utilization(self) -> float:
        return len(self._active) / self.slots

    # ------------------------------------------------------------ internal
    def _admit(self) -> None:
        while self._free and self._queue:
            req = heapq.heappop(self._queue)
            slot = self._free.pop()
            with telemetry.span("engine.admit", req=req.id,
                                prompt_tokens=len(req.prompt),
                                queue_wait_s=telemetry.since(req.submitted)):
                # prefill the single request, then splice its cache row
                # into the batch cache at `slot` (the COP analogue:
                # preparing the slot overlaps with other slots' decoding at
                # engine level)
                tokens = torch.as_tensor(req.prompt[None, :],
                                         device=self.device)
                with telemetry.span("model.prefill"):
                    logits, cache1 = self.model.prefill({"tokens": tokens},
                                                        pad_to=self.max_len)
                with telemetry.span("engine.splice"):
                    self._splice(slot, cache1)
                with telemetry.span("engine.read"):
                    first = int(self.model.greedy(logits)[0])
                self._last_tok[slot, 0] = first
                self._active[slot] = {"req": req, "tokens": [first]}
                if req.max_new <= 1:
                    self._done.append(self._retire(slot))

    def _splice(self, slot: int, cache1) -> None:
        """Copy a one-row prefill cache into row ``slot``: axis 1 of k/v and
        of the SSM family's conv and ssm states, axis 2 of the hybrid's
        (nb, pb, B, ...) conv and ssm states.  On a mesh each leaf is the
        rank's part (``Model.own_heads``: a "tp" prefill hands over the
        rank's kv heads, channels and heads, an "fsdp" prefill every one,
        which it cuts)."""
        hybrid = self.cfg.family == "hybrid"
        cache1 = self.model.own_heads(cache1)
        for key, big in self.cache.items():
            if key == "pos":
                big[slot] = cache1["pos"][0]
            elif hybrid and key in ("conv", "ssm"):
                big[:, :, slot:slot + 1] = cache1[key]
            else:
                big[:, slot:slot + 1] = cache1[key]

    def _retire(self, slot: int) -> Completion:
        """Free ``slot``; the completion of the request it held."""
        st = self._active.pop(slot)
        with telemetry.span("engine.retire", req=st["req"].id,
                            tokens=len(st["tokens"])):
            self._free.append(slot)
        return Completion(st["req"].id, st["tokens"])
