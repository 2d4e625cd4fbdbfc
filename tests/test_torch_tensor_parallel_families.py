"""Tensor parallelism on torch.distributed (gloo, the CPU) against the JAX
package, for the families beside the dense LM: the SSM (mamba2-780m: a tied
embedding, the mamba block on each rank's heads from the rules' slices of
its projections), the hybrid (zamba2-2.7b: its mamba layers the same, its
shared attention and MLP block split), the encoder-decoder
(whisper-medium: the encoder's, the decoder's and the cross-attention's
heads) and the VLM (llava-next: the projector gathered on use), on meshes
(1, 2), (1, 4) and (2, 2) of (data, model), f32 smoke configs.  The cases
are ``tests/_torch_tp_cases.py``'s, and for the mamba archs the
collectives of a training step and each rank's decode states
(``_torch_tp.MAMBA``).
"""
import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_tp as tt  # noqa: E402
from _torch_tp_cases import *  # noqa: E402,F401,F403
from _torch_tp_cases import TP_REL, leaf_rel, ranks  # noqa: E402

from repro_torch.launch.mesh import MeshSpec  # noqa: E402
from repro_torch.launch.shardings import local_slice  # noqa: E402

ARCHS = tt.ARCHS["b"]


def _numel(shape: str) -> int:
    return int(np.prod([int(n) for n in shape.split("x")]))


@pytest.mark.parametrize("mamba_arch", tt.MAMBA)
def test_mamba_layers_gather_no_whole_leaf(runs, mamba_arch, shape):
    """Each rank of "model" runs the mamba block on its own heads from its
    slices of the leaves: the collectives of one ``make_train_step`` step,
    as ``roofline/counting`` books them on every rank, hold no all-gather
    over "model" of as many values as a whole ``in_proj``, ``conv_w``,
    ``conv_b`` or ``out_proj`` of a layer or of the stacked leaf; and the
    column exchanges (all-to-alls over "model") hand each layer's rank its
    [z | x | B | C | dt] columns of ``in_proj`` and [x | B | C] of the
    conv's weights and bias (their bias row joined) in the forward and in
    remat's recompute, and send each column's gradient back to the rank
    that holds it once in the backward."""
    from repro_torch.configs import get_smoke
    cfg = tt.smoke(mamba_arch, get_smoke)
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    k, c, nm = cfg.ssm_conv, cfg.d_inner + 2 * cfg.ssm_state, shape[1]
    layers = cfg.n_layers
    whole = {d * (2 * di + 2 * n + h), k * c, c, di * d}
    whole |= {layers * w for w in whole}
    dl, hl, t = di // nm, h // nm, 2 * di + 2 * n

    def wants(s: int) -> tuple:
        """The columns of in_proj and the channels of the conv that rank s
        of "model" reads for its heads."""
        proj = [*range(s * dl, (s + 1) * dl),
                *range(di + s * dl, di + (s + 1) * dl), *range(2 * di, t),
                *range(t + s * hl, t + (s + 1) * hl)]
        conv = [*range(s * dl, (s + 1) * dl), *range(di, c)]
        return proj, conv

    for r, res in enumerate(ranks(runs, shape)):
        m = r % nm
        proj, conv = wants(m)
        # a rank sends back the gradient of every column it sent: its
        # slice's columns that each rank read
        sent = [sum(len({*wants(s)[i]} & {*range(m * w, (m + 1) * w)})
                    for s in range(nm))
                for i, w in enumerate(((t + h) // nm, c // nm))]
        want = {f"{len(proj)}x{d}": 2 * layers,
                f"{len(conv)}x{k + 1}": 2 * layers}
        for size, rows in zip(sent, (d, k + 1)):
            want[f"{size}x{rows}"] = want.get(f"{size}x{rows}", 0) + layers
        calls = [str(x).split("/") for x in
                 res[f"{tt.tag(shape)}/{mamba_arch}/collectives"]]
        gathers = [s for kind, axis, s in calls
                   if kind == "all-gather" and axis == "model"]
        assert not [s for s in gathers if _numel(s) in whole], (r, gathers)
        exchanged = [s for kind, axis, s in calls
                     if kind == "all-to-all" and axis == "model"]
        assert {s: exchanged.count(s) for s in set(exchanged)} == want, r


@pytest.mark.parametrize("mamba_arch", tt.MAMBA)
def test_mamba_decode_states_are_the_rank_parts(runs, mamba_arch, shape):
    """``make_prefill_step`` on the mesh in "tp" mode, then STATE_STEPS
    ``make_serve_step`` steps fed one process's greedy tokens: each rank's
    conv and ssm states, after the prefill and after the steps, are its
    rows, channels and heads of one process's (``decode_cache_specs`` =
    the reference's ``cache_shardings``: the channels and heads over
    "model") within TP_REL, and its greedy tokens one process's rows."""
    from repro_torch.launch.shardings import (batch_shardings,
                                              decode_cache_specs)
    cfg = tt.train_cfg(mamba_arch)
    spec = MeshSpec(tt.AXES, shape)
    t = f"{tt.tag(shape)}/{mamba_arch}/states"
    for r, res in enumerate(ranks(runs, shape)):
        coord = dict(zip(tt.AXES, map(int, np.unravel_index(r, shape))))
        for when in ("prefill", "decode"):
            wc = {leaf: res[f"{t}/whole/{when}/{leaf}"]
                  for leaf in ("conv", "ssm")}
            specs = decode_cache_specs(wc, cfg, spec, "tp")
            for leaf, w in wc.items():
                got = res[f"{t}/part/{when}/{leaf}"]
                part = local_slice(torch.tensor(w), specs[leaf], spec,
                                   coord).numpy()
                dim = -1 if leaf == "conv" else -3
                assert got.shape == part.shape, (r, when, leaf)
                assert got.shape[dim] * shape[1] == w.shape[dim]
                assert leaf_rel(got, part, w) < TP_REL, (r, when, leaf)
        toks = torch.tensor(res[f"{t}/whole/tok"])
        rows = batch_shardings({"tokens": toks}, spec, "tp")["tokens"]
        own = local_slice(toks, rows, spec, coord).numpy()
        np.testing.assert_array_equal(res[f"{t}/part/tok0"], own[:, 0])
        for i in range(1, tt.STATE_STEPS + 1):
            np.testing.assert_array_equal(res[f"{t}/part/tok{i}"][:, 0],
                                          own[:, i])
