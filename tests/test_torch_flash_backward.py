"""The port's flash-attention backward on the CPU: the plain backward
(``attention_backward_reference``) against torch autograd of the plain
forward and against ``jax.grad`` of the JAX reference, the forward's row
logsumexp, the autograd Function, and the input checks of the CUDA path.

Inputs and cotangents are drawn once with numpy and handed to both
frameworks.  The CUDA backward kernel runs only on the card: chip_smoke.py
holds it against the same plain backward there."""

import pytest

np = pytest.importorskip("numpy")
jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import \
    attention_reference as jax_attention  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttention, attention_backward_reference, attention_reference,
    flash_attention)
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    BWD_TILE_KV, BWD_TILE_Q, band_schedule, bwd_body, workspace_words)
from repro_torch.kernels.flash_attention.ops import \
    _check_cuda_inputs  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gmm_ops  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402

# f32 on both sides; only the order of sums differs (observed <= 1e-6)
REL = 1e-5
# B, S, T, H, K, hd, causal, window
CASES = {
    "mha": (2, 24, 24, 4, 4, 16, True, 0),
    "gqa": (1, 20, 20, 8, 2, 32, True, 0),
    "window": (1, 33, 33, 4, 2, 16, True, 7),
    "kv prefix": (2, 12, 30, 4, 1, 16, True, 0),
    "non-causal": (1, 18, 18, 2, 2, 32, False, 0),
    "hd 80": (1, 16, 16, 4, 2, 80, True, 5),
}


def _draw(b, s, t, h, k, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, hd), np.float32),
            rng.standard_normal((b, t, k, hd), np.float32),
            rng.standard_normal((b, t, k, hd), np.float32),
            rng.standard_normal((b, s, h, hd), np.float32))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def _plain_backward(q, k, v, do, causal, window):
    tq, tk, tv = (torch.as_tensor(x) for x in (q, k, v))
    o, lse = attention_reference(tq, tk, tv, causal=causal, window=window,
                                 return_lse=True)
    return attention_backward_reference(tq, tk, tv, o, lse,
                                        torch.as_tensor(do), causal=causal,
                                        window=window)


@pytest.mark.parametrize("case", list(CASES))
def test_backward_reference_matches_autograd(case):
    b, s, t, h, k, hd, causal, window = CASES[case]
    q, kk, v, do = _draw(b, s, t, h, k, hd)
    got = _plain_backward(q, kk, v, do, causal, window)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, kk, v))
    out = attention_reference(tq, tk, tv, causal=causal, window=window)
    want = torch.autograd.grad(out, (tq, tk, tv), torch.as_tensor(do))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert _rel(g, w) < REL


@pytest.mark.parametrize("case", list(CASES))
def test_backward_reference_matches_jax_grad(case):
    b, s, t, h, k, hd, causal, window = CASES[case]
    q, kk, v, do = _draw(b, s, t, h, k, hd, seed=1)
    got = _plain_backward(q, kk, v, do, causal, window)

    @jax.jit
    def jax_grads(a, b_, c, cot):
        _, vjp = jax.vjp(lambda x, y, z: jax_attention(
            x, y, z, causal=causal, window=window), a, b_, c)
        return vjp(cot)

    want = jax_grads(*(jnp.asarray(x) for x in (q, kk, v, do)))
    for g, w in zip(got, want):
        assert _rel(g, w) < REL


@pytest.mark.parametrize("case", list(CASES))
def test_lse_matches_jax_logsumexp(case):
    b, s, t, h, k, hd, causal, window = CASES[case]
    q, kk, _, _ = _draw(b, s, t, h, k, hd, seed=2)
    _, lse = attention_reference(*(torch.as_tensor(x) for x in (q, kk, kk)),
                                 causal=causal, window=window,
                                 return_lse=True)
    rows, cols = np.arange(s)[:, None], np.arange(t)[None, :]
    mask = np.ones((s, t), bool)
    if causal:
        mask &= cols <= rows + (t - s)
    if window > 0:
        mask &= cols > rows + (t - s) - window

    @jax.jit
    def jax_lse(a, b_):
        scores = jnp.einsum("bskgd,btkd->bkgst",
                            a.reshape(b, s, k, h // k, hd), b_) * hd ** -0.5
        scores = jnp.where(mask, scores, -2.0 ** 30)
        return jax.nn.logsumexp(scores, axis=-1).reshape(b, h, s)

    want = jax_lse(jnp.asarray(q), jnp.asarray(kk))
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    assert _rel(lse, want) < REL


@pytest.mark.parametrize("case", ["gqa", "window", "kv prefix"])
def test_function_matches_autograd_on_cpu(case):
    """FlashAttention.apply on the CPU (the plain forward keeping lse, the
    plain backward) against autograd of the plain forward; flash_attention
    routes through it when an input requires grad, and not otherwise."""
    b, s, t, h, k, hd, causal, window = CASES[case]
    q, kk, v, do = _draw(b, s, t, h, k, hd, seed=3)
    args = [torch.tensor(x, requires_grad=True) for x in (q, kk, v)]
    out = FlashAttention.apply(*args, causal, window, hd ** -0.5)
    assert out.grad_fn is not None and "FlashAttention" in \
        type(out.grad_fn).__name__
    got = torch.autograd.grad(out, args, torch.as_tensor(do))
    ref_args = [torch.tensor(x, requires_grad=True) for x in (q, kk, v)]
    ref = attention_reference(*ref_args, causal=causal, window=window)
    want = torch.autograd.grad(ref, ref_args, torch.as_tensor(do))
    assert _rel(out.detach(), ref.detach()) < REL
    for g, w in zip(got, want):
        assert _rel(g, w) < REL
    routed = flash_attention(*args, causal=causal, window=window)
    assert "FlashAttention" in type(routed.grad_fn).__name__
    with torch.no_grad():
        assert flash_attention(*args, causal=causal,
                               window=window).grad_fn is None


def test_function_refuses_causal_with_fewer_keys():
    """Causal attention with T < S leaves rows without a key, whose gradient
    the kernel and the plain version would give differently: the Function
    refuses it on the CPU as on the card, and the no-grad forward (serving)
    still takes it."""
    q, kk, v, _ = _draw(1, 12, 8, 2, 2, 16, seed=4)
    args = [torch.tensor(x, requires_grad=True) for x in (q, kk, v)]
    with pytest.raises(ValueError, match="fewer keys than queries"):
        FlashAttention.apply(*args, True, 0, 0.25)
    with pytest.raises(ValueError, match="fewer keys than queries"):
        flash_attention(*args, causal=True)
    assert flash_attention(*args, causal=False).shape == args[0].shape
    with torch.no_grad():
        assert flash_attention(*args, causal=True).shape == args[0].shape


def test_check_cuda_inputs_checks_do():
    q = torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16)
    _check_cuda_inputs(q, k, k, torch.zeros_like(q))
    with pytest.raises(ValueError, match="cotangent must match q"):
        _check_cuda_inputs(q, k, k, torch.zeros(1, 8, 2, 16))
    with pytest.raises(ValueError, match="cotangent must match q"):
        _check_cuda_inputs(q, k, k, torch.zeros(1, 7, 2, 16,
                                                dtype=torch.bfloat16))
    strided = torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        _check_cuda_inputs(q, k, k, strided)
    # a row that starts 8 bytes in: not 16-byte aligned
    unaligned = torch.zeros(1 * 8 * 2 * 16 + 4,
                            dtype=torch.bfloat16)[4:].view(1, 8, 2, 16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _check_cuda_inputs(q, k, k, unaligned)


@pytest.mark.parametrize("kernel", ["moe_gmm", "ssd"])
def test_kernels_without_backward_refuse_grad_on_cuda(kernel):
    """Every kernel has its backward now, so no wrapper refuses a gradient:
    moe_gmm's (``GroupedFFN``) and SSD's (``SSDIntraChunk``) keep no
    refusal, and an input that needs a gradient goes through the
    Function."""
    if kernel == "moe_gmm":
        assert not hasattr(gmm_ops, "NO_GRAD")
        assert not hasattr(gmm_ops, "refuse_grad")
        w = torch.zeros(2, 8, 16, requires_grad=True)
        out = gmm_ops.grouped_ffn(torch.ones(1, 2, 4, 8), w, w,
                                  torch.zeros(2, 16, 8))
        assert type(out.grad_fn).__name__ == "GroupedFFNBackward"
        return
    assert not hasattr(ssd_ops, "NO_GRAD")
    assert not hasattr(ssd_ops, "refuse_grad")
    assert not hasattr(kernels, "refuse_grad")     # and its last user gone
    x = torch.zeros(1, 1, 4, 2, 8, requires_grad=True)
    y, st = ssd_ops.ssd_intra_chunk(x, torch.ones(1, 1, 4, 2),
                                    torch.zeros(1, 1, 4, 2),
                                    torch.ones(1, 1, 4, 3),
                                    torch.ones(1, 1, 4, 3))
    assert type(y.grad_fn).__name__ == "SSDIntraChunkBackward"
    assert y.grad_fn is st.grad_fn


# chip_smoke.py's BWD_CASES (B, S, T, H, K, hd, causal, window; the tests'
# flash cases, the training shape, GQA with a window, a kv prefix, hd 80,
# the smoke configs' hd 16, one partial tile, hd-64 GQA with a window over
# several tiles, MQA at hd 128; whisper's non-causal cross-attention (T >
# S, T ragged), T < S and its encoder), phi4-mini's GQA and granite-34b's
# 48:1 MQA at their training length
SCHEDULE_CASES = [
    (2, 64, 64, 4, 2, 32, True, 0), (1, 100, 100, 4, 4, 64, True, 0),
    (2, 32, 128, 4, 1, 16, True, 0), (1, 128, 128, 8, 2, 64, True, 24),
    (1, 96, 96, 2, 2, 32, False, 0), (1, 64, 64, 2, 2, 128, True, 0),
    (2, 2048, 2048, 32, 32, 128, True, 0),
    (2, 1024, 1024, 32, 8, 128, True, 256),
    (1, 200, 328, 8, 2, 128, True, 0), (1, 663, 663, 32, 32, 80, True, 0),
    (1, 300, 300, 8, 2, 80, True, 64), (2, 32, 32, 4, 4, 16, True, 0),
    (2, 32, 32, 4, 2, 16, True, 8), (1, 20, 20, 4, 2, 64, True, 0),
    (1, 1024, 1024, 16, 4, 64, True, 256), (1, 512, 512, 48, 1, 128, True, 0),
    (2, 2048, 2048, 24, 8, 128, True, 0),
    (1, 2048, 2048, 48, 1, 128, True, 0),
    (1, 300, 700, 4, 2, 64, True, 100), (1, 300, 200, 4, 2, 64, False, 50),
    (2, 448, 1500, 16, 16, 64, False, 0), (1, 300, 100, 4, 4, 64, False, 0),
    (4, 1500, 1500, 16, 16, 64, False, 0), (1, 96, 96, 2, 2, 64, False, 0)]
# non-causal, no window (whisper's encoder and cross-attention): T > S with
# T ragged against the 128-row kv tiles, T < S (one partial kv tile), and
# T = S ragged; (B, S, T, K)
NON_CAUSAL = [(2, 448, 1500, 16), (1, 300, 100, 4), (4, 1500, 1500, 16)]


@pytest.mark.parametrize("case", SCHEDULE_CASES, ids=str)
def test_band_schedule_matches_the_mask(case):
    """The wgmma backward's schedule against the dense mask of
    attention_reference: each (q tile, kv tile) pair with a kept element is
    walked exactly once per (batch, kv head, query head of the group); the
    per-tile counts and first adders match; every item that an item waits
    on (a lower kv tile of its (b, kh) that sees the same q tile) holds a
    lower ticket."""
    b, s, t, h, k, hd, causal, window = case
    sched = band_schedule(b, s, t, k, causal, window)
    n_kv, n_q = -(-t // BWD_TILE_KV), -(-s // BWD_TILE_Q)
    n_items = n_kv * b * k
    assert sched.dtype == np.int32
    assert sched.shape == (n_items + 2 * n_kv + 2 * n_q,)
    items = sched[:n_items]
    q_lo, q_hi = sched[n_items:n_items + n_kv], sched[n_items + n_kv:
                                                      n_items + 2 * n_kv]
    first = sched[n_items + 2 * n_kv:n_items + 2 * n_kv + n_q]
    count = sched[n_items + 2 * n_kv + n_q:]
    _, mask = _scores_mask(s, t, causal, window)
    pad = np.zeros((n_q * BWD_TILE_Q, n_kv * BWD_TILE_KV), bool)
    pad[:s, :t] = mask
    seen = pad.reshape(n_q, BWD_TILE_Q, n_kv, BWD_TILE_KV).any((1, 3)).T
    assert sorted(items.tolist()) == list(range(n_items))
    ticket = np.empty(n_items, np.int64)
    ticket[items] = np.arange(n_items)
    walked = np.zeros((b, k, n_kv, n_q), np.int64)
    for item in items.tolist():
        kh, bb, n = item % k, item // k % b, item // (k * b)
        for tt in range(q_lo[n], q_hi[n]):
            walked[bb, kh, n, tt] += 1
            rank = n - first[tt]
            assert 0 <= rank < count[tt]
            for m in range(first[tt], n):      # the adds it waits on
                assert ticket[(m * b + bb) * k + kh] < ticket[item]
    assert (walked == seen[None, None].astype(np.int64)).all()
    np.testing.assert_array_equal(count, seen.sum(0))
    np.testing.assert_array_equal(first, np.argmax(seen, axis=0))
    # the kv tiles that see a q tile are contiguous, so ranks are dense
    for tt in range(n_q):
        assert seen[first[tt]:first[tt] + count[tt], tt].all()


@pytest.mark.parametrize("case", NON_CAUSAL, ids=str)
def test_band_schedule_non_causal_walks_every_q_tile_once(case):
    """Without a causal mask or a window every kv tile walks every q tile,
    the last partial ones included, once: q_lo 0 and q_hi n_q for each kv
    tile, and each q tile's adds come from all n_kv kv tiles from the first
    (so its dq is written by the add of rank n_kv - 1, kv tile n_kv - 1)."""
    b, s, t, kh = case
    sched = band_schedule(b, s, t, kh, False, 0)
    n_kv, n_q = -(-t // BWD_TILE_KV), -(-s // BWD_TILE_Q)
    n_items = n_kv * b * kh
    items = sched[:n_items]
    q_lo, q_hi, first, count = np.split(
        sched[n_items:], np.cumsum([n_kv, n_kv, n_q]))
    assert sorted(items.tolist()) == list(range(n_items))
    np.testing.assert_array_equal(q_lo, np.zeros(n_kv))
    np.testing.assert_array_equal(q_hi, np.full(n_kv, n_q))
    np.testing.assert_array_equal(first, np.zeros(n_q))
    np.testing.assert_array_equal(count, np.full(n_q, n_kv))
    # the tiles cover S and T exactly: the last of each is partial or full
    assert (n_q - 1) * BWD_TILE_Q < s <= n_q * BWD_TILE_Q
    assert (n_kv - 1) * BWD_TILE_KV < t <= n_kv * BWD_TILE_KV


def _scores_mask(s, t, causal, window):
    q = torch.zeros(1, s, 1, 1)
    k = torch.zeros(1, t, 1, 1)
    from repro_torch.kernels.flash_attention.ref import _scores
    scores, mask = _scores(q, k, causal, window, 1.0)
    return scores, mask.numpy()


def test_backward_body_and_workspace():
    """The wrapper's choice of body (wgmma for bf16 at hd 64 and 128,
    mma.sync at 16, 32 and 80, FMAs in f32; mma.sync at hd 128 only when
    asked by name) and the workspace it allocates for each."""
    bf, f32 = torch.bfloat16, torch.float32
    assert [bwd_body(bf, hd) for hd in (16, 32, 64, 80, 128)] == [
        "mma", "mma", "wgmma", "mma", "wgmma"]
    assert bwd_body(f32, 128) == "fma" and bwd_body(bf, 128, "mma") == "mma"
    for dt, hd, body in ((bf, 64, "mma"), (f32, 128, "mma"),
                         (bf, 128, "fma")):
        with pytest.raises(ValueError, match="no .* body"):
            bwd_body(dt, hd, body)
    # D padded to whole 64-row tiles; the wgmma body adds lse * log2 e, the
    # dq sums and one counter per (b, h, q tile) plus the ticket
    assert workspace_words(2, 100, 4, 128, "mma") == 2 * 4 * 128
    assert workspace_words(2, 100, 4, 128, "wgmma") == (
        2 * 2 * 4 * 128 + 2 * 4 * 100 * 128 + 2 * 4 * 2 + 1)
