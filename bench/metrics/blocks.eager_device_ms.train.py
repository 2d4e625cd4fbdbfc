"""Device time per traced training step of every kernel outside the cuBLAS
products (the kernels of ``aten::mm``, ``bmm``, ``addmm``, ``baddbmm``),
the port's hand-written kernels (flash and SSD, forward and backward) and
the optimizer's update: the eager work of the blocks, in ms."""
MOVES = "train_tokens_per_s"
WRAP = [("repro_torch.models.attention", "flash_attention", "flash"),
        ("repro_torch.models.ssm", "ssd_intra_chunk", "ssd")]
PRODUCTS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")


def read(run):
    if "train_steps" not in run.values or not run.traced:
        return None
    kernels = ["bench:flash", "bench:ssd", *run.nodes.values()]
    secs = run.trace.not_under("bench:opt.update", *PRODUCTS, *kernels)
    return 1e3 * secs / run.traced
