"""Model API.

    model = Model(cfg, device="cuda").init(torch.Generator("cuda").manual_seed(0))
    loss, metrics = model.train_loss(batch)      # with autograd
    logits = model.forward_logits(batch)
    logits, cache = model.prefill(batch, pad_to=...)
    logits, cache = model.decode_step(tokens, cache)     # cache updated in place

The model dispatches by family, as the reference does: ``encdec.py`` for
the encoder-decoder (whisper), ``lm.py`` for the rest.  The cache holds K/V
for the attention families, the conv and ssm states for the SSM family,
both for the hybrid, and the cross-attention K/V besides for the
encoder-decoder; ``pad_to`` reserves K/V slots and the mamba states ignore
it.

``batch`` is a dict with "tokens" (B,S) int64 on the model's device, and
"frames" (B, enc_len, d_model) for the encoder-decoder or "patches" (B,
n_patches, 1024) for the VLM; ``train_loss`` takes "labels" (B,S) besides.
The parameters require grad: ``train_loss`` builds the autograd graph, the
serving methods run under ``torch.no_grad``.

On a mesh (``Model(cfg, mesh=mesh)``, a DeviceMesh from ``launch/mesh.py``)
each rank keeps its slice of the leaves that the sharding mode set when the
model is built carries out (``launch/shardings.shard_params``): in "tp"
mode every leaf the rules split over "model", in "fsdp" mode every leaf the
fsdp rule splits over the whole mesh (ZeRO-3; each use gathers it whole);
the methods run under ``use_mesh(mesh, mode)`` in that mode, whatever
``set_sharding_mode`` says later.  ``train_loss`` takes the rank's rows of
a training batch (``shard_batch(batch, mesh, mode)``: over the data axes
in "tp" mode, over every axis in "fsdp" mode); the serving methods take
the same rows on every rank.  In "tp" mode the logits are the rank's
vocabulary slice; ``greedy`` takes the token of the whole vocabulary.

An "fsdp" batch smaller than the mesh splits each row's sequence over the
axes its rows leave.  The steps that shard a whole batch
(``launch/steps.py``) install the axes of its rows and of its sequence, and
the leaves that lie whole beside them, as ``launch/shardings.split_batch``
cut it (``on_mesh(split=...)``), and the methods called inside keep them:
each rank runs its slice of its rows, in every family.  The MoE routes the
reference's blocks (``mlp.py``); whisper's encoder runs its frames split
as the tokens are or whole on every rank (``encdec.py``); llava's ranks
hold contiguous slices of its patches and tokens joined, its patches split
as the tokens are or whole on every rank, the joined sequence's tail
padded where the ranks do not divide it (``lm.py``).
"""
from __future__ import annotations

import torch
from torch import nn

from ..launch.collectives import vocab_argmax
from ..launch.mesh import coordinate, mesh_device
from ..launch.shardings import (decode_cache_specs, local_slice, row_axes,
                                shard_params, sharded_specs)
from . import encdec, lm
from .common import (SHARDING_MODE, ambient_cache, ambient_mesh,
                     ambient_rows, ambient_seq, ambient_whole, dtype_of,
                     kv_split, require_device, state_split, state_whole,
                     use_mesh)
from .config import ArchConfig


def _populate(mod: nn.Module, tree: dict) -> nn.Module:
    """Register ``tree``'s leaves as trainable parameters of ``mod``,
    sub-dicts as child modules, so that state-dict keys are the tree's
    dotted paths."""
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            mod.add_module(name, _populate(nn.Module(), leaf))
        else:
            mod.register_parameter(name, nn.Parameter(leaf))
    return mod


def _tree_of(mod: nn.Module) -> dict:
    tree: dict = dict(mod.named_parameters(recurse=False))
    for name, child in mod.named_children():
        tree[name] = _tree_of(child)
    return tree


class Model(nn.Module):
    """Every family of the repo (dense, MoE, SSM, hybrid, VLM through
    ``lm``; encoder-decoder through ``encdec``) as an ``nn.Module``.

    Parameters keep the JAX tree's names and stacked layout (state-dict keys
    such as ``layers.attn.wq`` of shape (L, D, H, hd)).  A new model holds
    its parameters on the meta device, without memory; ``init`` draws them
    and ``load_state`` takes given ones.  Runs on CUDA unless the caller
    passes another device; raises if CUDA is asked for and absent.  On a
    ``mesh``, ``mode`` is the sharding mode it was built in, ``sharded``
    maps each leaf of which this rank holds a slice to the spec that names
    the axes it is split over (``launch/shardings.leaf_spec`` in the mode;
    the whole leaf where those axes have one rank) and ``whole_shapes``
    gives every leaf's whole shape."""

    def __init__(self, cfg: ArchConfig, device="cuda", mesh=None) -> None:
        super().__init__()
        self.cfg = cfg
        self.device = require_device(device)
        self.mesh = mesh
        self.mode = SHARDING_MODE[0]
        if mesh is not None and mesh_device(mesh) != self.device.type:
            raise ValueError(f"a {mesh_device(mesh)} mesh cannot run a model "
                             f"on {self.device}")
        self._mod = encdec if cfg.family == "encdec" else lm
        full = flatten(self._mod.init_params(cfg, None, "meta"))
        self.whole_shapes = {n: tuple(p.shape) for n, p in full.items()}
        self.sharded = {} if mesh is None else sharded_specs(full, mesh,
                                                             self.mode)
        _populate(self, _unflatten(self._shard(full)))

    def on_mesh(self, train: bool = False, split: tuple | None = None):
        """``use_mesh`` of the model's mesh in the mode it was built in,
        with the axes its batch lies over.  ``split`` = (rows, seq, whole)
        or (rows, seq, whole, cache): the axes of the rank's rows and of
        its slice of their sequence, and the leaves that lie whole beside
        them, as a step cut the whole batch (``launch/shardings.
        split_batch``), and the decode cache's leaves whose positions lie
        over axes (``launch/steps.make_serve_step``).  Without it, inside a
        ``use_mesh`` of the model's own mesh (a step's) the split
        installed there is kept whole; elsewhere the rows lie as
        ``shard_batch`` lays out a training batch with ``train`` (over
        every axis in "fsdp" mode), else over the data axes, and no
        sequence is split."""
        if split is None and self.mesh is not None:
            split = (ambient_rows(), ambient_seq(), ambient_whole(),
                     ambient_cache()) if ambient_mesh() is self.mesh else \
                (row_axes(self.mesh, self.mode) if train else None, (), ())
        rows, seq, whole, *cache = split or (None, (), ())
        return use_mesh(self.mesh, self.mode, rows, seq, whole,
                        cache[0] if cache else ())

    def _shard(self, state: dict) -> dict:
        """The rank's part of a whole flat state (all of it off a mesh)."""
        return state if self.mesh is None else shard_params(state, self.mesh,
                                                            self.mode)

    @property
    def params(self) -> dict:
        """The parameters as the nested dict ``lm`` takes."""
        return _tree_of(self)

    def init(self, generator: torch.Generator) -> "Model":
        """Draw the parameters on the model's device from ``generator``."""
        self.load_state(flatten(self._mod.init_params(self.cfg, generator,
                                                       self.device)))
        return self

    def load_state(self, state: dict) -> "Model":
        """Take a flat state dict (name -> tensor) of whole leaves, moved to
        the model's device; every parameter must be given.  Each leaf is
        cast to the dtype of the parameter it replaces, which
        ``init_params`` set: ``cfg.param_dtype`` for most, f32 for the MoE
        router and for mamba's ``A_log``, ``D`` and ``dt_bias``.  On a mesh
        the rank keeps its slice of each sharded leaf."""
        dtypes = {k: p.dtype for k, p in self.named_parameters()}
        self.load_state_dict(self._shard(
            {k: v.to(device=self.device, dtype=dtypes.get(k, v.dtype))
             for k, v in state.items()}), strict=True, assign=True)
        return self

    def train_loss(self, batch):
        """(total loss, metrics) of ``batch["tokens"]`` against
        ``batch["labels"]``, with autograd, from the family's module as the
        reference dispatches it: ``encdec.train_loss`` ({"ce"}) for whisper,
        ``lm.train_loss`` ({"ce", "aux"}) for the rest.  On a mesh, call
        its backward under ``model.on_mesh(train=True)`` too (remat
        recomputes the forward there), as ``make_train_step`` does."""
        with self.on_mesh(train=True):
            return self._mod.train_loss(self.params, batch, self.cfg)

    @torch.no_grad()
    def forward_logits(self, batch) -> torch.Tensor:
        params = self.params
        with self.on_mesh():
            if self.cfg.family == "encdec":
                enc_out = encdec.encode(params, batch["frames"], self.cfg)
                logits, _ = encdec.dec_forward(params, batch["tokens"],
                                               enc_out, self.cfg)
                return logits
            logits, _, _ = lm.forward(params, batch["tokens"], self.cfg,
                                      patches=batch.get("patches"))
            return logits

    @torch.no_grad()
    def prefill(self, batch, pad_to: int | None = None):
        with self.on_mesh():
            return self._mod.prefill(self.params, batch, self.cfg,
                                     pad_to=pad_to)

    @torch.no_grad()
    def decode_step(self, tokens, cache):
        with self.on_mesh():
            return self._mod.decode_step(self.params, tokens, cache,
                                         self.cfg)

    def init_decode_cache(self, batch: int, max_len: int,
                          dtype: torch.dtype | None = None) -> dict:
        """Zero cache; ``dtype`` defaults to the config's compute dtype.  On
        a mesh it holds the rank's kv heads, conv channels and ssm heads,
        every row and every position (the serving engine's; ``cache_part``
        cuts a rank's part)."""
        dtype = dtype_of(self.cfg.compute_dtype) if dtype is None else dtype
        with self.on_mesh():
            return self._mod.init_decode_cache(self.cfg, batch, max_len,
                                               dtype, self.device)

    def cache_part(self, cache: dict) -> dict:
        """This rank's part of a whole decode cache (every row, every
        position, every kv head, channel and head), as ``make_serve_step``
        takes it on the model's mesh (``launch/shardings.
        decode_cache_specs``, both modes): its rows over the batch axes, or
        its positions where they do not divide the batch (a batch of one:
        context-parallel decode), and its kv heads, conv channels and ssm
        heads over "model"; the cache itself off a mesh."""
        if self.mesh is None:
            return cache
        specs = decode_cache_specs(cache, self.cfg, self.mesh, self.mode)
        coord = coordinate(self.mesh)
        return {k: local_slice(v, specs[k], self.mesh, coord)
                for k, v in cache.items()}

    def own_heads(self, cache: dict) -> dict:
        """``cache`` with every leaf that holds all of what
        ``decode_cache_specs`` lays over "model" (an "fsdp" prefill's,
        whose rows lie over every axis) cut to the rank's part: the k/v
        leaves to its kv heads, ``conv`` to its channels, ``ssm`` to its
        heads; a leaf of the rank's part, and every other leaf, as it
        is."""
        cfg = self.cfg
        dims = {**{k: (3, cfg.n_kv_heads) for k in ("k", "v", "xk", "xv")},
                **state_whole(cfg)}
        out = {}
        with self.on_mesh():
            for key, v in cache.items():
                split = None if key not in dims else (
                    state_split(cfg, key) if key in ("conv", "ssm")
                    else kv_split(cfg))
                dim, whole = dims.get(key, (0, 0))
                if split is not None and split[2] > 1 and \
                        v.shape[dim] == whole:
                    size = whole // split[2]
                    v = v.narrow(dim, split[1] * size, size)
                out[key] = v
        return out

    @torch.no_grad()
    def greedy(self, logits: torch.Tensor) -> torch.Tensor:
        """The greedy token ids (B,) of the last-position logits (B, V) that
        ``prefill`` and ``decode_step`` return: ``torch.argmax`` over the
        whole vocabulary, whose slices a "tp" mesh gathers first
        (``collectives.vocab_argmax``), so every rank gets the same ids."""
        with self.on_mesh():
            mesh = lm.vocab_mesh(self.cfg)
        if mesh is None:
            return torch.argmax(logits, dim=-1)
        return vocab_argmax(logits, mesh)



def _unflatten(state: dict) -> dict:
    """A flat {dotted name: leaf} as the nested dict."""
    tree: dict = {}
    for name, leaf in state.items():
        *path, last = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def flatten(tree: dict, prefix: str = "") -> dict:
    """A nested dict as {dotted path: leaf}, the state-dict keys."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out
