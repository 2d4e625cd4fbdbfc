"""The mamba block split over "model" without a process group: the ranks of
"model" as threads of one process (``tests/_torch_ranks.py``), each holding
the parts that ``launch/shardings.shard_params`` gives it, against the whole
computation in f32.

- the column exchange (``launch/collectives.exchange_columns``'s autograd
  Function and ``column_plan``) at the smoke configs' boundaries on 2 and 4
  ranks and at mamba2-780m's and zamba2-2.7b's published widths on 16: each
  rank's [z | x | B | C | dt] columns of ``in_proj`` and [x | B | C]
  channels of the conv, and, backward, each column's gradient summed into
  the rank that holds it;
- the gated norm's statistic over the ranks' columns (``common.
  rms_norm_cols``) against ``common.rms_norm``, with its gradient;
- ``mamba_forward`` on each rank's heads, forward and backward, in "tp"
  mode, and ``mamba_decode`` on each rank's parts of the decode states in
  both modes: y summed in rank order, dx, every gradient slice and the
  states' parts against the whole layer; a variant whose heads do not
  divide the ranks runs the block whole beside a split conv state.
"""
import numpy as np
import pytest
import torch

from _torch_ranks import Ranks

from repro_torch.configs import get_config, get_smoke
from repro_torch.launch import collectives
from repro_torch.launch.mesh import MeshSpec
from repro_torch.launch.shardings import model_dim, param_spec, shard_params
from repro_torch.models import ssm
from repro_torch.models.common import mamba_split, rms_norm, rms_norm_cols

# f32 on both sides; the ranks sum their shares of y, of the norm's
# statistic and of the B and C columns' gradients in another order than the
# whole layer adds them
REL = 1e-5
NORM_REL = 1e-6


def _rel(got, want) -> float:
    got, want = (np.asarray(t.detach(), np.float64) for t in (got, want))
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def _wants(cfg, nm: int, s: int) -> tuple[list, list]:
    """The columns of ``in_proj`` and the conv channels that rank s of nm
    reads for its heads [s H/nm, (s+1) H/nm)."""
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dl, hl, t = di // nm, h // nm, 2 * di + 2 * n
    proj = [*range(s * dl, (s + 1) * dl), *range(di + s * dl, di + (s + 1) * dl),
            *range(2 * di, t), *range(t + s * hl, t + (s + 1) * hl)]
    conv = [*range(s * dl, (s + 1) * dl), *range(di, di + 2 * n)]
    return proj, conv


def _columns(ranges) -> list:
    return [c for a, b in ranges for c in range(a, b)]


CASES = [("smoke", "mamba2-780m", 2), ("smoke", "mamba2-780m", 4),
         ("smoke", "zamba2-2.7b", 4), ("published", "mamba2-780m", 16),
         ("published", "zamba2-2.7b", 16)]


@pytest.mark.parametrize("size,arch,nm", CASES)
def test_column_exchange_hands_each_rank_its_heads(size, arch, nm):
    """Each rank's slice of the packed ``in_proj`` columns (and of the conv
    channels) through the exchange's own autograd Function, the all-to-all
    done among the ranks' threads: forward, exactly the columns its heads
    read, in order; backward, each rank's slice gets the sum, in rank
    order, of the gradients that every rank gave its columns."""
    cfg = (get_smoke if size == "smoke" else get_config)(arch)
    wanted = ssm._wanted(cfg, nm)
    rng = np.random.default_rng(nm)
    for which, total in ((0, 2 * cfg.d_inner + 2 * cfg.ssm_state
                          + cfg.ssm_heads),
                         (1, cfg.d_inner + 2 * cfg.ssm_state)):
        want = wanted[which]
        cols = [_wants(cfg, nm, s)[which] for s in range(nm)]
        assert [_columns(w) for w in want] == cols
        held = total // nm
        whole = torch.tensor(rng.standard_normal((3, total)), dtype=torch.float32)
        grads = [torch.tensor(rng.standard_normal((3, len(c))),
                              dtype=torch.float32) for c in cols]
        ranks = Ranks(nm)

        def rank(r, held=held, want=want, whole=whole, grads=grads):
            x = whole[:, r * held:(r + 1) * held].clone().requires_grad_()
            plan = collectives.column_plan(r, held, want)
            assert sum(plan[2]) == grads[r].shape[1]
            out = collectives._ColumnExchange.apply(
                x, 1, collectives._Axis(None, "model"), plan)
            out.backward(grads[r])
            return out.detach(), x.grad

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(collectives, "_all_to_all_v", ranks.all_to_all_v)
            got = ranks.run(rank)
        summed = torch.zeros_like(whole)
        for c, g in zip(cols, grads):
            summed[:, c] += g
        for r, (out, dx) in enumerate(got):
            assert torch.equal(out, whole[:, cols[r]]), (which, r)
            np.testing.assert_allclose(dx, summed[:, r * held:(r + 1) * held],
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("nm", [2, 4])
def test_norm_statistic_over_the_ranks_columns(nm):
    """``rms_norm_cols`` of each rank's columns, the sum of squares summed
    over the ranks: the ranks' outputs joined, the gradients of their
    columns and of their slices of the scales, against ``rms_norm`` of the
    whole rows (NORM_REL); and without a mesh the two agree."""
    rng = np.random.default_rng(7)
    b, s, di = 2, 5, 128
    x, scale, dy = (torch.tensor(rng.standard_normal(shape),
                                 dtype=torch.float32)
                    for shape in ((b, s, di), (di,), (b, s, di)))
    xw, sw = x.clone().requires_grad_(), scale.clone().requires_grad_()
    want = rms_norm(xw, sw, 1e-5)
    want.backward(dy)
    assert _rel(rms_norm_cols(x, scale, 1e-5), want) < NORM_REL
    w = di // nm
    xs = [x[..., r * w:(r + 1) * w].clone().requires_grad_()
          for r in range(nm)]
    ss = [scale[r * w:(r + 1) * w].clone().requires_grad_()
          for r in range(nm)]
    ranks = Ranks(nm)
    with ranks.patched():
        ys = ranks.run(lambda r: rms_norm_cols(xs[r], ss[r], 1e-5,
                                               ranks.mesh()))
    torch.autograd.backward(ys, list(dy.split(w, dim=-1)))
    assert _rel(torch.cat(ys, -1), want) < NORM_REL
    assert _rel(torch.cat([t.grad for t in xs], -1), xw.grad) < NORM_REL
    assert _rel(torch.cat([t.grad for t in ss]), sw.grad) < NORM_REL


# the smoke configs, and a variant whose 5 heads do not divide 4 ranks
# while its 112 conv channels do: there the block runs whole on every rank
# (its leaves gathered) beside a conv state split over the ranks
VARIANTS = [("mamba2-780m", {}, 2), ("mamba2-780m", {}, 4),
            ("zamba2-2.7b", {}, 4), ("mamba2-780m", {"d_model": 40}, 4)]


def _layer(arch: str, over: dict, seed: int = 0):
    """(cfg, one layer's whole leaves): the smoke config, f32, with the
    zeros the init leaves (conv_b, dt_bias, norm) and D drawn too."""
    cfg = get_smoke(arch).replace(**over)
    gen = torch.Generator().manual_seed(seed)
    leaves = ssm.init_mamba_params(gen, cfg, torch.float32, "cpu")
    for k in ("conv_b", "dt_bias", "norm", "D"):
        leaves[k] = 0.1 * torch.randn(leaves[k].shape, generator=gen)
    return cfg, leaves


def _parts(leaves: dict, nm: int, mode: str) -> list[dict]:
    """Each rank's leaves: in "tp" mode ``shard_params``' slices (fresh
    leaves) and the whole leaves the rules replicate, one tensor shared by
    every rank, as every rank's "f" sums their gradient; in "fsdp" mode the
    whole leaves (a layer gathered whole)."""
    if mode == "fsdp":
        return [leaves] * nm
    spec = MeshSpec(("data", "model"), (1, nm))
    out = []
    for r in range(nm):
        part = shard_params(leaves, spec, "tp", {"data": 0, "model": r})
        out.append({k: v.detach().clone().requires_grad_()
                    if v is not leaves[k] else v for k, v in part.items()})
    return out


def _slice(t: torch.Tensor, dim: int, r: int, nm: int) -> torch.Tensor:
    size = t.shape[dim] // nm
    return t.narrow(dim, r * size, size)


@pytest.mark.parametrize("arch,over,nm", VARIANTS,
                         ids=["mamba2-2", "mamba2-4", "zamba2-4",
                              "five-heads-4"])
def test_forward_on_the_ranks_heads(arch, over, nm):
    """``mamba_forward`` in "tp" mode on each rank's parts, forward and
    backward (one cotangent through the summed y): every rank's y alike
    and within REL of the whole layer's, dx, each rank's gradient of its
    slices and the replicated leaves' gradients (every rank's share
    summed) within REL of the whole's, and the decode states each rank's
    part of the whole's (its channels and heads)."""
    cfg, leaves = _layer(arch, over)
    leaves = {k: v.requires_grad_() for k, v in leaves.items()}
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((2, 12, cfg.d_model)),
                     dtype=torch.float32, requires_grad=True)
    dy = torch.tensor(rng.standard_normal(x.shape), dtype=torch.float32)
    y, (conv, st) = ssm.mamba_forward(leaves, x, cfg, return_state=True)
    y.backward(dy)
    want = {k: v.grad.clone() for k, v in leaves.items()}
    dx = x.grad.clone()
    for t in (*leaves.values(), x):
        t.grad = None
    parts = _parts(leaves, nm, "tp")
    ranks = Ranks(nm)
    with ranks.patched("tp"):
        split = ranks.run(lambda r: mamba_split(cfg))
        got = ranks.run(lambda r: ssm.mamba_forward(parts[r], x, cfg,
                                                    return_state=True))
    assert (split[0] is None) == bool(over)
    for r, (yr, _) in enumerate(got):
        assert torch.equal(yr, got[0][0]), r
    assert _rel(got[0][0], y) < REL
    got[0][0].backward(dy)
    assert _rel(x.grad, dx) < REL
    spec = MeshSpec(("data", "model"), (1, nm))
    for k, g in want.items():
        d = model_dim(param_spec(k, g.shape, spec))
        for r in range(nm):
            if d is None:
                assert parts[r][k] is leaves[k]
                assert _rel(leaves[k].grad, g) < REL, k
            else:
                assert _rel(parts[r][k].grad, _slice(g, d, r, nm)) < REL, \
                    (k, r)
    for r, (_, (cr, sr)) in enumerate(got):
        assert torch.equal(cr, _slice(conv, -1, r, nm)), r
        want_st = st if over else _slice(st, -3, r, nm)
        assert _rel(sr, want_st) < REL, r


@pytest.mark.parametrize("mode", ["tp", "fsdp"])
@pytest.mark.parametrize("arch,over,nm", VARIANTS,
                         ids=["mamba2-2", "mamba2-4", "zamba2-4",
                              "five-heads-4"])
def test_decode_on_the_ranks_parts(arch, over, nm, mode):
    """``mamba_decode`` of one token on each rank's parts of the decode
    states (its channels of the conv state, its heads of the ssm state
    where the rules split them), without grad, in "tp" mode (the rank's
    slices of the leaves) and in "fsdp" mode (the whole leaves, of which
    the rank cuts its slices): every rank's y, the ranks' shares summed in
    rank order, alike and within REL of the whole step's; each rank's new
    states the whole step's parts."""
    cfg, leaves = _layer(arch, over, seed=1)
    rng = np.random.default_rng(5)
    b, c = 3, cfg.d_inner + 2 * cfg.ssm_state
    x1 = torch.tensor(rng.standard_normal((b, 1, cfg.d_model)),
                      dtype=torch.float32)
    conv0 = torch.tensor(rng.standard_normal((b, cfg.ssm_conv - 1, c)),
                         dtype=torch.float32)
    st0 = torch.tensor(rng.standard_normal(
        (b, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim)),
        dtype=torch.float32)
    with torch.no_grad():
        y, (conv, st) = ssm.mamba_decode(leaves, x1, conv0, st0, cfg)
        parts = _parts(leaves, nm, mode)
        heads = not over          # the ssm state's heads over the ranks
        ranks = Ranks(nm)
        with ranks.patched(mode):
            got = ranks.run(lambda r: ssm.mamba_decode(
                parts[r], x1, _slice(conv0, -1, r, nm),
                _slice(st0, -3, r, nm) if heads else st0, cfg))
    for r, (yr, (cr, sr)) in enumerate(got):
        assert torch.equal(yr, got[0][0]), r
        assert _rel(cr, _slice(conv, -1, r, nm)) < REL, r
        assert _rel(sr, _slice(st, -3, r, nm) if heads else st) < REL, r
    assert _rel(got[0][0], y) < REL


def test_decode_refuses_every_head():
    """Where the rank works on its own heads, a decode state of every
    channel and head (an "fsdp" prefill's, which ``Model.own_heads`` cuts)
    raises naming ``Model.cache_part``."""
    cfg, leaves = _layer("mamba2-780m", {})
    c = cfg.d_inner + 2 * cfg.ssm_state
    conv0 = torch.zeros((1, cfg.ssm_conv - 1, c))
    st0 = torch.zeros((1, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim))
    ranks = Ranks(2)
    with torch.no_grad(), ranks.patched("fsdp"), \
            pytest.raises(ValueError, match="Model.cache_part"):
        ranks.run(lambda r: ssm.mamba_decode(
            leaves, torch.zeros((1, 1, cfg.d_model)), conv0, st0, cfg))
