"""CPU tests of the harness: the traffic generator, the metric arithmetic on
hand-made inputs, the imports of a run, and whole runs of cells added at
smoke sizes (a scratch checkout, by files and entries alone), sound and
with the timed path broken underneath."""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(ROOT / "src"), str(BENCH),
                str(Path(__file__).resolve().parent)]

from _bench_cells import CELLS, TRAFFIC, smoke_root  # noqa: E402
from harness import roofline, stats, traffic  # noqa: E402
from harness.cell import run  # noqa: E402
from harness.common import cell_files, forbidden_modules  # noqa: E402
from harness.reference import Reference  # noqa: E402
from harness.serve import replay  # noqa: E402
from harness.trace import _union  # noqa: E402

SEED = 2 ** 31 + 977          # more than 32 signed bits hold


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke_root(tmp_path_factory.mktemp("bench"))


def _run(root, cell, seed=SEED, seconds=1.0):
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds,
                              trace=0)
    return run(args, time.perf_counter(), root, "cpu")


# ------------------------------------------------------------------ traffic
def test_traffic_is_the_seeds_and_every_seed_gets_the_same_sizes():
    tr = json_traffic("serve-batch")
    a, b = (traffic.requests(tr, SEED, 102400) for _ in range(2))
    c = traffic.requests(tr, SEED + 1, 102400)
    assert all(np.array_equal(x["prompt"], y["prompt"])
               and x["max_new"] == y["max_new"] for x, y in zip(a, b))
    assert any(not np.array_equal(x["prompt"], y["prompt"])
               for x, y in zip(a, c))
    sizes = sorted((len(r["prompt"]), r["max_new"]) for r in a)
    assert sizes == sorted((len(r["prompt"]), r["max_new"]) for r in c)
    assert len(a) == tr["arrival"]["count"]
    lens = [len(r["prompt"]) for r in a]
    assert min(lens) >= 64 and max(lens) <= 512
    assert abs(np.median(lens) - 256) <= 8
    assert all(128 <= r["max_new"] <= 512 for r in a)


def test_the_slot_cache_holds_the_longest_request_and_no_more():
    """No position of the engine's cache is padding that no request can
    reach: ``max_len`` is the longest prompt and output the mix can pair."""
    tr = json_traffic("serve-batch")
    assert tr["max_len"] == tr["prompt"]["max"] + tr["output"]["max"]
    longest = max(len(r["prompt"]) + r["max_new"]
                  for r in traffic.requests(tr, SEED, 102400))
    assert tr["max_len"] - 64 <= longest <= tr["max_len"]


def json_traffic(name):
    import json
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def test_token_files_are_the_seeds(tmp_path):
    from harness.train import write_tokens
    a = np.load(write_tokens(str(tmp_path), SEED, 512, 2, 8, 4))
    (tmp_path / "b").mkdir()
    b = np.load(write_tokens(str(tmp_path / "b"), SEED, 512, 2, 8, 4))
    (tmp_path / "c").mkdir()
    c = np.load(write_tokens(str(tmp_path / "c"), SEED + 1, 512, 2, 8, 4))
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.shape == (4 * 2 * 9,)


# --------------------------------------------------------------- arithmetic
def test_rate_over_whole_steps():
    # steps end at 1.5, 2.5, 4.0 after a window opened at 0.5
    assert stats.whole_steps_rate([1.5, 2.5, 4.0], 0.5, 100) == \
        pytest.approx(300 / 3.5)
    with pytest.raises(ValueError):
        stats.whole_steps_rate([0.2], 0.5, 100)


def test_percentile_is_the_nearest_rank_over_every_sample():
    xs = list(range(100, 0, -1))
    assert stats.percentile(xs, 90) == 90
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile([7.0], 95) == 7.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_flash_work_is_counted_by_hand():
    # causal 4 x 4: 10 kept pairs; b 2, h 3, hd 8
    f, nb = roofline.flash_fwd(2, 4, 4, 3, 3, 8, True, 0, 2, with_lse=True)
    assert f == 4 * 2 * 3 * 10 * 8
    assert nb == 2 * (2 * 2 * 4 * 3 * 8 + 2 * 2 * 4 * 3 * 8) + 4 * 2 * 3 * 4
    f, nb = roofline.flash_bwd(2, 4, 4, 3, 3, 8)
    assert f == 10 * 2 * 3 * 10 * 8
    assert nb == 2 * (4 * 2 * 4 * 3 * 8 * 2) + 4 * 2 * 3 * 4
    assert roofline.attention_pairs(4096, 4096, True, 0) == 4096 * 4097 // 2


def test_ssd_work_is_counted_by_hand():
    b, nc, l, h, p, n = 1, 2, 4, 3, 5, 6
    pairs = 10
    f, nb = roofline.ssd(b, nc, l, h, p, n)
    assert f == 2 * nc * (pairs * n + h * pairs * p + h * l * n * p)
    assert nb == (2 * nc * l * h * p + 8 * nc * l * h + 8 * nc * l * n
                  + 4 * nc * l * h * p + 4 * nc * h * n * p)
    f, _ = roofline.ssd_bwd(b, nc, l, h, p, n)
    assert f == 2 * nc * (h * (2 * pairs * p + 2 * l * n * p) + 3 * pairs * n)


def test_model_flops_and_bound():
    arch = roofline.Arch({"family": "dense", "n_layers": 30, "d_model": 4096,
                          "n_heads": 32, "n_kv_heads": 32, "head_dim": 128,
                          "d_ff": 11008, "vocab": 102400})
    n = roofline.param_counts(arch)["active"]
    assert n == 6910115840
    tokens = 4096
    want = 6 * n * tokens + 12 * 30 * 4096 * 2048 * tokens
    assert roofline.model_flops(arch, "train", 1, 4096) == want
    assert roofline.bound_s(989e12, 1.0) == pytest.approx(1.0)
    assert roofline.bound_s(1.0, 3.35e12) == pytest.approx(1.0)


def test_busy_time_is_the_union_of_device_spans():
    assert _union([(0, 2), (1, 3), (5, 6)]) == [[0, 3], [5, 6]]


def test_replay_gives_every_gap_and_token():
    reqs = [{"prompt": np.zeros(5), "max_new": 3},
            {"prompt": np.zeros(7), "max_new": 2}]
    events = [("p", 1.0, 0), ("d", 1.5, 1), ("p", 2.0, 1), ("d", 2.4, 2)]
    out = replay(events, reqs, slots=4)
    # request 0: tokens at 1.0, 1.5, 2.4; request 1: at 2.0, 2.4
    assert len(out["tokens"]) == 5
    gaps = [g for _, g, _, _ in out["tokens"] if g is not None]
    assert sorted(gaps) == pytest.approx(sorted([0.5, 0.9, 0.4]))
    assert out["occupancy"] == [(1.5, 0.25), (2.4, 0.5)]
    assert [(k, n) for _, _, k, n in out["tokens"]] == [
        ("prefill", 5), ("decode", 6), ("prefill", 7), ("decode", 7),
        ("decode", 8)]
    with pytest.raises(RuntimeError):
        replay([("p", 1.0, 0), ("d", 1.5, 2)], reqs, slots=4)


# ------------------------------------------------------------------ imports
def test_a_run_imports_no_jax_nor_the_jax_package(root):
    code = (f"import sys, time, argparse; sys.path[:0] = {[str(ROOT / 'src'), str(root / 'bench')]!r}\n"
            "from harness.cell import run\n"
            "from harness.common import forbidden_modules\n"
            f"a = argparse.Namespace(workload='smoke-dense.smoke-train', seed={SEED}, seconds=0.2, trace=0)\n"
            f"line, ctx = run(a, time.perf_counter(), __import__('pathlib').Path({str(root)!r}), 'cpu')\n"
            "assert line['correct'], line\n"
            "import repro_torch\n"
            "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole():
    sys.modules.setdefault("repro_torch_lookalike", type(sys)("x"))
    try:
        assert "repro_torch_lookalike" not in forbidden_modules()
    finally:
        sys.modules.pop("repro_torch_lookalike")


def test_the_reference_imports_nothing_of_the_program():
    code = (f"import sys; sys.path[:0] = [{str(BENCH)!r}]\n"
            "import harness.reference, harness.weights, harness.roofline\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


# ------------------------------------------------------------- whole runs
def test_a_cell_is_added_by_files_and_an_entry(root):
    for cell in CELLS:
        files = cell_files(cell, root)
        assert files["traffic"].is_file() and files["config"].is_file()


@pytest.mark.parametrize("cell", list(CELLS))
def test_smoke_cells_agree_with_the_reference(root, cell):
    """At the smoke sizes on the CPU the port's plain path and the
    reference agree to float32 rounding, under the smoke cells' limits."""
    line, ctx = _run(root, cell)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) >= {"setup_s"}
    assert list(line)[-1] == "checks"


def test_an_untraced_serving_run_times_no_decode_step(root):
    """Only a traced run times ``decode_step`` to a synchronize; an
    untraced one counts every token by the engine's own steps."""
    line, ctx = _run(root, "smoke-dense.smoke-serve")
    assert ctx.values["decodes"] == []
    assert ctx.values["work"] and ctx.end_to_end["tpot_p95_ms"] > 0
    assert line["metrics"]["gen_tokens_per_s"]["value"] > 0


def _broken(monkeypatch, fault):
    from repro_torch.models import Model
    from repro_torch.optim import AdamW
    if fault == "unchanged":
        monkeypatch.setattr(AdamW, "leaf_update", lambda self, *a: None)
    elif fault == "half_batch":
        orig = Model.train_loss

        def half(self, batch):
            n = batch["tokens"].shape[0] // 2
            return orig(self, {k: v[:n] for k, v in batch.items()})
        monkeypatch.setattr(Model, "train_loss", half)
    elif fault == "token":
        orig = Model.greedy

        def altered(self, logits):
            return (orig(self, logits) + 1) % logits.shape[-1]
        monkeypatch.setattr(Model, "greedy", altered)


@pytest.mark.parametrize("cell,fault", [
    ("smoke-dense.smoke-train", "unchanged"),
    ("smoke-dense.smoke-train", "half_batch"),
    ("smoke-dense.smoke-serve", "token"),
])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, cell, fault):
    _broken(monkeypatch, fault)
    line, _ = _run(root, cell)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", ["smoke-dense.smoke-train"])
def test_the_float8_control_fails_training(root, cell):
    """The control, the reference with float8 products in the program's
    place, fails the cell's limits on the same inputs."""
    from harness import train
    line, ctx = _run(root, cell)
    tr = TRAFFIC[ctx.files["cell"]["traffic"]]
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = train.write_tokens(tmp, SEED, ctx.arch.vocab, tr["batch"],
                                  tr["seq_len"], tr["file_steps"])
        got = train.reference_steps(ctx.config, ctx.arch, SEED, path,
                                    tr["batch"], tr["seq_len"],
                                    tr["checked_steps"], "cpu",
                                    precision="fp8")
    gaps = train.gaps(got, ctx.values["reference"])
    assert any(gaps[k] > ctx.limits[k] for k in gaps), gaps


def test_the_float8_control_fails_serving(root):
    from harness import serve
    line, ctx = _run(root, "smoke-dense.smoke-serve")
    gap = serve.served_gap(ctx.arch, SEED, ctx.values["checked"], "cpu",
                           "fp8", control=True)
    assert gap > ctx.limits["logit_gap"]


def test_reference_float8_rounds_products_only():
    arch = roofline.Arch({"family": "dense", "n_layers": 1, "d_model": 16,
                          "n_heads": 2, "n_kv_heads": 2, "head_dim": 8,
                          "d_ff": 32, "vocab": 64, "param_dtype": "float32"})
    from harness.weights import draw
    params = draw(arch, SEED, "cpu")
    tokens = torch.arange(12)[None] % 64
    a = Reference(arch, params).hidden(tokens)
    b = Reference(arch, params, "fp8").hidden(tokens)
    assert 0 < float((a - b).abs().max()) < float(a.abs().max())


def test_a_traced_run_reads_its_per_layer_metrics(root):
    """The traced run's plumbing on the CPU: the profiler over the traced
    steps, the readers of the cell's per-layer metrics (those of the host
    clock read outside the traced stretch), the device block and the
    breakdown; the kernel readers need the card."""
    args = argparse.Namespace(workload="smoke-dense.smoke-serve", seed=SEED,
                              seconds=2.0, trace=1)
    line, ctx = run(args, time.perf_counter(), root, "cpu")
    assert {"engine.slot_occupancy.batch", "model.decode_step_ms.batch",
            "mfu.batch"} <= set(line["metrics"])
    assert line["device"]["window_s"] > 0 and "busy_s" in line["device"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert ctx.traced > 0
    assert not ctx.untraced((ctx.tracer.t0 + ctx.tracer.t1) / 2)
    lo, hi = ctx.tracer.span
    assert lo <= ctx.tracer.t0 < ctx.tracer.t1 <= hi
    t0, t1 = ctx.values["window"]
    assert ctx.untraced_seconds(t0, t1) == pytest.approx(
        (t1 - t0) - (min(t1, hi) - max(t0, lo)))


def test_device_time_within_a_ranges_spans_counts_each_operation_once():
    from harness.trace import Summary
    s = Summary.__new__(Summary)
    s.spans = {"bench:x": [(10, 20), (30, 40), (15, 20)]}
    s._dev = [(9, 12), (12, 15), (18, 25), (33, 34), (50, 60)]
    # 2 + 3 + 2 us inside [10, 20], 1 inside [30, 40]
    assert s.within("bench:x") == pytest.approx(8e-6)
    assert s.within("bench:y") == 0.0
