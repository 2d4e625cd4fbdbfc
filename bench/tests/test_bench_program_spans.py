"""CPU tests of the per-layer readers of the program's own spans
(``harness/program.py`` over ``repro_torch.telemetry``): traced runs of the
smoke cells read what needs no card, an untraced run never records, a
program without the recorder reads nothing, and the readers' arithmetic on
hand-made spans and trace events."""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace as NS

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(ROOT / "src"), str(BENCH),
                str(Path(__file__).resolve().parent)]

from _bench_cells import smoke_root  # noqa: E402
from harness import cell, program  # noqa: E402
from harness.cell import Context, run  # noqa: E402
from harness.common import benchmark, metric_reader  # noqa: E402
from repro_torch import telemetry  # noqa: E402

SEED = 2 ** 31 + 4099
NEW = {"train": {"steps.forward_stream_ms.train",
                 "steps.backward_stream_ms.train",
                 "optimizer.stream_ms.train", "trainer.gc_pause_ms.train",
                 "device.mallocs.train"},
       "serve": {"engine.admit_share.batch", "engine.host_ms.batch",
                 "model.decode_stream_ms.batch",
                 "model.decode_launches.batch",
                 "engine.decode_idle_ms.batch", "device.mallocs.batch"}}
# what the CPU can read: host time and the collector; stream times, the
# allocator and the device trace need the card
ON_CPU = {"trainer.gc_pause_ms.train", "engine.admit_share.batch",
          "engine.host_ms.batch"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The smoke checkout, its training cell without the device-trace
    readers of training, which need the card's kernels in the trace."""
    root = smoke_root(tmp_path_factory.mktemp("bench"))
    path = root / "BENCHMARK.json"
    spec = json.loads(path.read_text())
    for m in spec["per_layer"]:
        if m["source"] == "device_trace":
            m["workloads"] = [w for w in m["workloads"]
                              if w != "smoke-dense.smoke-train"]
    path.write_text(json.dumps(spec, indent=1))
    return root


@pytest.fixture(autouse=True)
def _no_recorder_left():
    telemetry.stop()
    yield
    telemetry.stop()


def _run(root, cell_name, trace, seconds=1.0):
    args = argparse.Namespace(workload=cell_name, seed=SEED, seconds=seconds,
                              trace=trace)
    return run(args, time.perf_counter(), root, "cpu")


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_a_traced_smoke_run_reads_the_program_spans(root, kind):
    line, ctx = _run(root, f"smoke-dense.smoke-{kind}", trace=1,
                     seconds=5.0)
    assert line["correct"], line["checks"]
    got = set(line["metrics"]) & NEW[kind]
    assert got == NEW[kind] & ON_CPU
    assert all(line["metrics"][m]["value"] >= 0 for m in got)
    if kind == "serve":
        assert 0 < line["metrics"]["engine.admit_share.batch"]["value"] < 100
    names = {s.name for s in ctx.values["program_spans"]}
    assert {f"{kind}.step" if kind == "train" else "engine.step"} <= names
    # the readers stopped the recorder once they had read
    assert telemetry.active is None


def test_the_new_metrics_are_entries_with_readers():
    spec = {m["name"]: m for m in benchmark()["per_layer"]}
    cells = {"train": "deepseek-7b.train-1x4096",
             "serve": "deepseek-7b.serve-batch"}
    for kind, names in NEW.items():
        for name in names:
            assert spec[name]["workloads"] == [cells[kind]]
            reader = metric_reader(name)
            assert reader.MOVES == spec[name]["moves"]


def test_an_untraced_run_never_records(root, monkeypatch):
    seen = []
    close = cell.Context.close_window

    def noting(self, t1):
        seen.append(telemetry.active)
        close(self, t1)

    monkeypatch.setattr(cell.Context, "close_window", noting)
    assert telemetry.active is None
    for kind in ("train", "serve"):
        line, ctx = _run(root, f"smoke-dense.smoke-{kind}", trace=0)
        assert line["correct"] and "program_spans" not in ctx.values
    assert seen == [None, None] and telemetry.active is None


def test_a_program_without_the_recorder_reads_nothing(root, monkeypatch):
    """A program from before the recorder (the parent of this benchmark's
    readers): the traced run passes and the new metrics are left out."""
    monkeypatch.setattr(program, "telemetry", None)
    line, _ = _run(root, "smoke-dense.smoke-serve", trace=1, seconds=3.0)
    assert line["correct"]
    assert not set(line["metrics"]) & NEW["serve"]
    assert "engine.slot_occupancy.batch" in line["metrics"]
    code = (f"import sys; sys.path[:0] = [{str(ROOT / 'src')!r}, "
            f"{str(BENCH)!r}]\n"
            "sys.modules['repro_torch.telemetry'] = None\n"
            "from harness import program\n"
            "program.record()\n"
            "print(program.telemetry)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "None"


# ------------------------------------------------------------ arithmetic
def _span(i, name, start, end, parent=None, ms=None, **attrs):
    return NS(id=i, name=name, parent=parent, start=start, end=end,
              seconds=end - start, device_ms=ms, attrs=attrs)


def _fake_run(spans, traced=(4.0, 6.0), window=(1.0, 10.0),
              events=(), device="cpu"):
    r = NS(values={"program_spans": list(spans)}, t0=window[0],
           t1=window[1], device=torch.device(device),
           tracer=NS(span=traced, _prof=NS(events=lambda: list(events))))
    r.untraced_seconds = lambda a, b: Context.untraced_seconds(r, a, b)
    return r


def _read(name, r):
    return metric_reader(name).read(r)


def test_engine_readers_take_untraced_steps_of_the_window():
    spans = [
        # before the window, in the traced stretch, and two kept steps
        _span(0, "engine.step", 0.2, 0.9, mallocs=9),
        _span(1, "engine.step", 4.5, 5.0, mallocs=9),
        _span(2, "engine.step", 7.0, 8.0, mallocs=2),
        _span(3, "engine.admit", 7.0, 7.4, parent=2, req=5),
        _span(4, "engine.read", 7.3, 7.4, parent=3),
        _span(5, "engine.decode", 7.4, 7.5, parent=2, ms=60.0, rows=1),
        _span(6, "engine.read", 7.5, 7.9, parent=2),
        _span(7, "engine.step", 8.0, 8.5, mallocs=0),
        _span(8, "engine.decode", 8.0, 8.1, parent=7, ms=100.0, rows=1),
        _span(9, "engine.read", 8.1, 8.4, parent=7),
    ]
    r = _fake_run(spans)
    assert _read("engine.admit_share.batch", r) == pytest.approx(
        100 * 0.4 / 1.5)
    assert _read("engine.host_ms.batch", r) == pytest.approx(
        1e3 * ((1.0 - 0.5 - 0.1) + (0.5 - 0.3 - 0.1)) / 2)
    assert _read("model.decode_stream_ms.batch", r) == pytest.approx(80.0)
    assert _read("device.mallocs.batch", r) == pytest.approx(1.0)
    # the CPU's spans have no stream time nor allocator counts
    spans[5].device_ms = None
    spans[2].attrs.pop("mallocs")
    assert _read("model.decode_stream_ms.batch", r) is None
    assert _read("device.mallocs.batch", r) is None
    assert _read("model.decode_launches.batch", r) is None


def test_training_readers_sum_a_steps_spans_and_its_collections():
    spans = [
        _span(0, "train.step", 1.0, 2.0, mallocs=4),
        _span(1, "train.forward", 1.0, 1.2, parent=0, ms=150.0),
        _span(2, "train.backward", 1.2, 1.6, parent=0, ms=350.0),
        _span(3, "train.optimizer", 1.6, 2.0, parent=0, ms=600.0),
        _span(4, "gc", 1.1, 1.15, parent=1),
        _span(5, "train.step", 4.2, 5.0, mallocs=100),   # traced
        _span(6, "gc", 4.3, 4.4, parent=5),
        # two microbatches
        _span(7, "train.step", 7.0, 8.0, mallocs=0),
        _span(8, "train.forward", 7.0, 7.1, parent=7, ms=50.0, micro=0),
        _span(9, "train.forward", 7.3, 7.4, parent=7, ms=70.0, micro=1),
        _span(10, "train.backward", 7.1, 7.3, parent=7, ms=300.0),
        _span(11, "train.optimizer", 7.5, 8.0, parent=7, ms=620.0),
        _span(12, "gc", 8.1, 8.12),            # between steps, in the window
    ]
    r = _fake_run(spans)
    assert _read("steps.forward_stream_ms.train", r) == pytest.approx(135.0)
    assert _read("steps.backward_stream_ms.train", r) == pytest.approx(325.0)
    assert _read("optimizer.stream_ms.train", r) == pytest.approx(610.0)
    assert _read("trainer.gc_pause_ms.train", r) == pytest.approx(
        1e3 * (0.05 + 0.02) / 2)
    assert _read("device.mallocs.train", r) == pytest.approx(2.0)
    assert _read("optimizer.stream_ms.train", _fake_run([])) is None
    assert _read("trainer.gc_pause_ms.train", _fake_run([])) is None


def _event(name, start, end, device="cpu", parent=None, kernels=(),
           annotation=False):
    dt = (torch.autograd.DeviceType.CUDA if device == "cuda"
          else torch.autograd.DeviceType.CPU)
    return NS(name=name, device_type=dt, cpu_parent=parent,
              time_range=NS(start=start, end=end),
              kernels=[NS(name=k) for k in kernels],
              is_user_annotation=annotation)


def test_decode_launches_and_idle_from_the_trace():
    # two traced decode steps; the host in engine.decode over [0, 100) and
    # [200, 300) us, the device busy over [10, 40), [50, 120) and [200, 300)
    d1 = _event("engine.decode", 0, 100, annotation=True)
    d2 = _event("engine.decode", 200, 300, annotation=True)
    mm = _event("aten::mm", 5, 20, parent=d1, kernels=["gemm", "gemm"])
    cp = _event("aten::copy_", 30, 60, parent=d2,
                kernels=["copy", "engine.decode"])
    other = _event("aten::add", 130, 140, kernels=["add"])
    dev = [_event("gemm", 10, 40, "cuda"), _event("gemm", 50, 120, "cuda"),
           _event("copy", 200, 300, "cuda"),
           _event("engine.decode", 0, 300, "cuda", annotation=True)]
    r = _fake_run([], events=[d1, d2, mm, cp, other, *dev], device="cuda")
    assert _read("model.decode_launches.batch", r) == pytest.approx(3 / 2)
    # idle in [0, 100): 10 + 10; in [200, 300): 0
    assert _read("engine.decode_idle_ms.batch", r) == pytest.approx(
        1e3 * 20e-6 / 2)
    assert _read("engine.decode_idle_ms.batch",
                 _fake_run([], events=dev, device="cuda")) is None
