"""llava's sequence split where the joined sequence's padded tail leaves a
rank of pads only, without a process group: the ranks of "model" as
threads of one process (``tests/_torch_ranks.py``, ``Ranks.patched_seq``).

One patch lies whole on every rank beside one token a rank on 4 ranks:
L = 1 + 4 = 5 positions cut into slices of s = 2 ([0, 2), [2, 4), [4, 6),
[6, 8)), so rank 2 holds the last real position and a pad and rank 3 pads
only.  ``lm.train_loss`` (the mean of the ranks' losses and its gradient
in every leaf) and ``lm.prefill`` (each rank's last logits, and its cache
cut to the L real positions) are held against one process on the same
batch; every rank hands its collectives parts of the same shapes, in the
same order, which a group of processes needs or it hangs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_ranks import Ranks  # noqa: E402

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import Model, lm  # noqa: E402
from repro_torch.models.api import flatten  # noqa: E402

# f32 on both sides; the ranks' shares of the loss and of each gradient
# are summed in another order than one process adds them
REL = 1e-5
N = 4


def _rel(got, want) -> float:
    got, want = (np.asarray(t.detach(), np.float64) for t in (got, want))
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def _setup():
    cfg = get_smoke("llava-next-mistral-7b").replace(n_patches=1)
    params = Model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0)).params
    rng = np.random.default_rng(0)
    toks = torch.tensor(rng.integers(0, cfg.vocab, size=(2, N + 1)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "patches": torch.tensor(rng.standard_normal(
                 (2, 1, lm.PATCH_DIM)).astype(np.float32))}
    return cfg, params, batch


def _rank_batch(batch: dict, r: int) -> dict:
    """Rank r's tokens and labels (one each a row); the patches whole."""
    return {k: v if k == "patches" else v[:, r:r + 1]
            for k, v in batch.items()}


def test_a_rank_of_pads_only_matches_one_process():
    cfg, params, batch = _setup()
    leaves = flatten(params)
    whole = lm.train_loss(params, batch, cfg)[0]
    want = torch.autograd.grad(whole, list(leaves.values()))

    ranks = Ranks(N)
    with ranks.patched_seq(whole=("patches",)):
        losses = ranks.run(lambda r: lm.train_loss(
            params, _rank_batch(batch, r), cfg)[0])
    loss = torch.stack(losses).sum() / N
    assert abs(float(loss.detach()) - float(whole.detach())) <= \
        REL * abs(float(whole.detach()))
    assert float(losses[3].detach()) == 0.0     # no text position there
    got = torch.autograd.grad(loss, list(leaves.values()))
    for name, g, w in zip(leaves, got, want):
        assert _rel(g, w) < REL, name
    assert all(log == ranks.log[0] for log in ranks.log), ranks.log
    train_calls = len(ranks.log[0])

    pre = {k: v for k, v in batch.items() if k != "labels"}
    with torch.no_grad():
        want_logits, want_cache = lm.prefill(params, pre, cfg)
    ranks = Ranks(N)
    with ranks.patched_seq(whole=("patches",)), torch.no_grad():
        outs = ranks.run(lambda r: lm.prefill(params, _rank_batch(pre, r),
                                              cfg))
    assert all(log == ranks.log[0] for log in ranks.log), ranks.log
    # the prefill gathers the embeddings, each layer's k and v, and the
    # last logits (where the training step gathers the labels)
    assert len(ranks.log[0]) == train_calls
    for logits, cache in outs:
        assert _rel(logits, want_logits) < REL
        assert torch.equal(cache["pos"], want_cache["pos"])
        assert int(cache["pos"][0]) == 1 + N
        for key in ("k", "v"):
            assert cache[key].shape == want_cache[key].shape, key
            assert cache[key].shape[2] == 1 + N, key
            assert _rel(cache[key], want_cache[key]) < REL, key
