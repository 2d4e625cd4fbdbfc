"""The plain reference: the configurations' models and their optimizer in
plain PyTorch, written from the models' equations, in float32 with TF32
off.  It imports nothing of the program (nor JAX), calls none of its
kernels or plain kernel versions, and takes only what the benchmark hands
it: the configuration, the weights drawn from the seed, the token rows.

The parameter tree is the one the port's ``Model.load_state`` takes
(names and stacked layout), so both sides are given the same tensors:

- dense (deepseek): ``embed`` (V, D), ``final_norm`` (D), ``lm_head`` (D,
  V); ``layers.*`` stacked over L: ``ln1``, ``ln2`` (D), ``attn.wq``,
  ``attn.wk``, ``attn.wv`` (D, H, hd), ``attn.wo`` (H, hd, D), ``mlp.w_in``,
  ``mlp.w_gate`` (D, F), ``mlp.w_out`` (F, D).

The equations: pre-norm residual blocks; RMS norm in f32 scaled by (1 +
scale); RoPE on the two halves of each head at positions 0..S-1; causal
softmax attention scaled by hd^-0.5; SwiGLU MLP; mean cross-entropy of
the logits.

``precision="fp8"`` is the control, the model computed in float8 e4m3 as
the program computes in bfloat16: every matrix product's operands and
result, every norm's output and the residual stream after each block are
rounded to float8 (one scale per tensor, its largest magnitude to 448);
the elementwise arithmetic between them stays float32, and the gradient
passes each rounding straight through.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ------------------------------------------------------------------ layout
def leaf_specs(arch) -> dict:
    """{leaf name: (shape, dtype name, init)} of the configuration's
    parameter tree; init is ("normal", std) or ("zeros",)."""
    if arch.family != "dense":
        raise ValueError(f"no reference for the {arch.family} family")
    d, v, dt = arch.d_model, arch.vocab, arch.param_dtype
    h, k, hd, ff = arch.n_heads, arch.n_kv_heads, arch.head_dim, arch.d_ff
    n = arch.n_layers
    return {
        "embed": ((v, d), dt, ("normal", 0.02)),
        "final_norm": ((d,), dt, ("zeros",)),
        "lm_head": ((d, v), dt, ("normal", d ** -0.5)),
        "layers.ln1": ((n, d), dt, ("zeros",)),
        "layers.ln2": ((n, d), dt, ("zeros",)),
        "layers.attn.wq": ((n, d, h, hd), dt, ("normal", d ** -0.5)),
        "layers.attn.wk": ((n, d, k, hd), dt, ("normal", d ** -0.5)),
        "layers.attn.wv": ((n, d, k, hd), dt, ("normal", d ** -0.5)),
        "layers.attn.wo": ((n, h, hd, d), dt, ("normal", (h * hd) ** -0.5)),
        "layers.mlp.w_in": ((n, d, ff), dt, ("normal", d ** -0.5)),
        "layers.mlp.w_gate": ((n, d, ff), dt, ("normal", d ** -0.5)),
        "layers.mlp.w_out": ((n, ff, d), dt, ("normal", ff ** -0.5)),
    }


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------- numerics
def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 at one scale (largest magnitude to 448)
    and back to float32; the gradient passes straight through."""
    amax = t.detach().abs().amax().clamp_min(1e-30)
    scale = 448.0 / amax
    q = (t.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return t + (q - t.detach())


def _rms(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale.float())


def _rope(x, positions, theta):
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = (positions.float()[:, None] * freqs)[None, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class Reference:
    """The model of ``arch`` on ``params`` ({leaf name: tensor}, the
    configuration's dtypes), computed in float32 (``precision="float32"``)
    or with float8 products (``"fp8"``, the control)."""

    def __init__(self, arch, params: dict, precision: str = "float32",
                 attn_block: int = 1024) -> None:
        if precision not in ("float32", "fp8"):
            raise ValueError(precision)
        self.arch = arch
        self.params = params
        self.q8 = precision == "fp8"
        self.attn_block = attn_block

    # -------------------------------------------------------------- pieces
    def _q(self, t: torch.Tensor) -> torch.Tensor:
        """An activation as the precision keeps it: as is in float32,
        rounded to float8 in the control."""
        return _fp8(t) if self.q8 else t

    def _ein(self, eq, *ops):
        return self._q(torch.einsum(eq, *(self._q(o.float()) for o in ops)))

    def _norm(self, x, scale):
        return self._q(_rms(x, scale, self.arch.norm_eps))

    def _ckpt(self, fn, *args):
        if torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def _attend(self, q, k, v):
        """Causal softmax attention, q (B,S,H,hd), k/v (B,S,K,hd), in
        blocks of query rows (each recomputed alone in the backward)."""
        b, s, h, hd = q.shape
        g = h // k.shape[2]
        if g > 1:
            k = k.repeat_interleave(g, dim=2)
            v = v.repeat_interleave(g, dim=2)

        def rows(q_blk, k, v, start):
            n = q_blk.shape[1]
            sc = self._ein("bshd,bthd->bhst", q_blk, k[:, :start + n]) \
                * hd ** -0.5
            i = torch.arange(start, start + n, device=q.device)[:, None]
            j = torch.arange(start + n, device=q.device)[None, :]
            sc = sc.masked_fill(j > i, float("-inf"))
            p = torch.softmax(sc, dim=-1)
            return self._ein("bhst,bthd->bshd", p, v[:, :start + n])

        out = [self._ckpt(rows, q[:, i:i + self.attn_block], k, v, i)
               for i in range(0, s, self.attn_block)]
        return torch.cat(out, dim=1)

    def _attn_block(self, p, h, positions):
        a = self.arch
        x = self._norm(h, p["ln1"])
        q = _rope(self._ein("bsd,dhk->bshk", x, p["attn.wq"]), positions,
                  a.rope_theta)
        k = _rope(self._ein("bsd,dhk->bshk", x, p["attn.wk"]), positions,
                  a.rope_theta)
        v = self._ein("bsd,dhk->bshk", x, p["attn.wv"])
        h = self._q(h + self._ein("bshk,hkd->bsd", self._attend(q, k, v),
                                  p["attn.wo"]))
        x = self._norm(h, p["ln2"])
        gated = F.silu(self._ein("bsd,df->bsf", x, p["mlp.w_gate"])) \
            * self._ein("bsd,df->bsf", x, p["mlp.w_in"])
        return self._q(h + self._ein("bsf,fd->bsd", gated, p["mlp.w_out"]))

    # ------------------------------------------------------------ forwards
    def _layers(self) -> list[dict]:
        """Per-layer views of the stacked ``layers.*`` leaves, each leaf
        unbound once (its gradient stacked once)."""
        parts = {name[len("layers."):]: torch.unbind(leaf)
                 for name, leaf in self.params.items()
                 if name.startswith("layers.")}
        count = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(count)]

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """The final hidden states (B,S,D), float32, of ``tokens`` (B,S)."""
        h = self._q(self.params["embed"].float()[tokens])
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        for lp in self._layers():
            h = self._ckpt(lambda h, lp=lp: self._attn_block(
                lp, h, positions), h)
        return h

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        h = self._norm(h, self.params["final_norm"])
        return self._ein("bsd,dv->bsv", h, self.params["lm_head"])

    def train_loss(self, tokens, labels) -> torch.Tensor:
        """Mean cross-entropy of the logits of ``tokens`` against
        ``labels``, with autograd."""
        def head(h, labels):
            logits = self.logits(h)
            lse = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, labels[..., None])[..., 0]
            return (lse - gold).mean()
        return self._ckpt(head, self.hidden(tokens), labels)

    @torch.no_grad()
    def sequence_logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """Logits (S, V), float32, of one sequence (S,) at every position."""
        return self.logits(self.hidden(tokens[None]))[0]


# --------------------------------------------------------------- optimizer
class AdamWRef:
    """AdamW as the configuration states it: the global-norm clip in
    float32, linear warmup then cosine to a floor of a tenth of ``lr``,
    bias-corrected moments kept in ``moment_dtype``, decoupled weight decay
    on leaves of two dims or more; each new parameter rounded to its
    dtype once."""

    def __init__(self, cfg: dict, params: dict) -> None:
        self.cfg = cfg
        mdt = dtype_of(cfg["moment_dtype"])
        self.m = {k: torch.zeros_like(p, dtype=mdt) for k, p in
                  params.items()}
        self.v = {k: torch.zeros_like(p, dtype=mdt) for k, p in
                  params.items()}
        self.count = 0

    def lr(self, count: int) -> float:
        c = self.cfg
        warm = min(count / max(c["warmup_steps"], 1), 1.0)
        prog = min(max((count - c["warmup_steps"])
                       / max(c["total_steps"] - c["warmup_steps"], 1), 0.0),
                   1.0)
        return c["lr"] * warm * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi
                                                                 * prog)))

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> float:
        """One update in place, leaf by leaf in slices of 2^26 values;
        returns the gradient's global norm."""
        c = self.cfg
        self.count += 1
        gnorm = math.sqrt(sum(float(part.float().square().sum())
                              for g in grads.values() for part in _slices(g)))
        scale = min(1.0, c["clip_norm"] / (gnorm + 1e-9))
        lr = self.lr(self.count)
        b1c = 1.0 - c["b1"] ** self.count
        b2c = 1.0 - c["b2"] ** self.count
        for k, p in params.items():
            decay = p.dim() >= 2
            for g, mk, vk, w in zip(_slices(grads[k]), _slices(self.m[k]),
                                    _slices(self.v[k]), _slices(p)):
                g = g.float() * scale
                m = c["b1"] * mk.float() + (1 - c["b1"]) * g
                v = c["b2"] * vk.float() + (1 - c["b2"]) * g * g
                upd = (m / b1c) / (torch.sqrt(v / b2c) + c["eps"])
                if decay:
                    upd = upd + c["weight_decay"] * w.float()
                w.copy_(w.float() - lr * upd)
                mk.copy_(m)
                vk.copy_(v)
        return gnorm


def _slices(x: torch.Tensor, size: int = 1 << 26) -> list:
    """Flat views of the contiguous ``x`` in slices of ``size`` values."""
    if not x.is_contiguous():
        raise ValueError("AdamWRef updates contiguous leaves only")
    flat = x.view(-1)
    return [flat[i:i + size] for i in range(0, max(flat.numel(), 1), size)]
