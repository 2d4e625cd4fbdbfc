"""Flash attention's share of its roofline in a training step: the least
time of one forward (keeping the row logsumexp) and one backward per
attention layer, as the frozen ``flash_fwd`` and ``flash_bwd`` count the
cell's shapes at the H100's data-sheet peaks, over the device time of
every kernel launched inside the forward calls (remat's recompute
included) and inside their autograd nodes, in %."""
from harness.roofline import bound_s, flash_bwd, flash_fwd

MOVES = "train_tokens_per_s"
WRAP = [("repro_torch.models.attention", "flash_attention", "flash")]


def read(run):
    if "train_steps" not in run.values or not run.arch.attn_layers:
        return None
    node = run.nodes.get("flash")
    secs = run.trace.under("bench:flash", *([node] if node else []))
    if node is None or secs <= 0:
        raise RuntimeError("flash's calls or its backward were not found "
                           "in the trace")
    a, b, s = run.arch, run.values["batch"], run.values["seq"]
    shape = (b, s, s, a.n_heads, a.n_kv_heads, a.head_dim)
    need = bound_s(*flash_fwd(*shape, with_lse=True)) \
        + bound_s(*flash_bwd(*shape))
    return 100.0 * need * a.attn_layers * run.traced / secs
