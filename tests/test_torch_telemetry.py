"""The port's recorder (``repro_torch.telemetry``) on the CPU: off, a span is
one check and changes nothing; on, the serving engine's and the training
step's spans nest as documented, with request ids, garbage collections and
the profiler's ranges, and outputs are those of recording off."""
import gc
import threading

import pytest

np = pytest.importorskip("numpy")
torch = pytest.importorskip("torch")

from repro_torch import telemetry  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import AdamW, AdamWConfig  # noqa: E402
from repro_torch.runtime import ServingEngine  # noqa: E402
from repro_torch.runtime.trainer import make_accum_train_step  # noqa: E402

ENGINE = {"engine.admit", "engine.decode", "engine.read", "engine.retire"}
ADMIT = ["model.prefill", "engine.splice", "engine.read"]


@pytest.fixture(autouse=True)
def _no_recorder_left():
    telemetry.stop()
    yield
    telemetry.stop()


def _model():
    return Model(get_smoke("deepseek-7b"), device="cpu").init(
        torch.Generator().manual_seed(0))


def _serve(lengths=(3, 9, 5, 12, 4), max_new=(4, 1, 6, 3, 5), slots=2):
    """(the ids submitted, the completions) of a smoke engine's run."""
    model = _model()
    eng = ServingEngine(model, slots=slots, max_len=32, device="cpu")
    rng = np.random.default_rng(3)
    ids = [eng.submit(rng.integers(0, model.cfg.vocab, size=n), max_new=m)
           for n, m in zip(lengths, max_new)]
    return ids, eng.run_until_drained()


def _train(steps=2, micro=1):
    """The losses of ``steps`` smoke training steps."""
    model = _model()
    opt = AdamW(AdamWConfig(warmup_steps=1, total_steps=10))
    params = dict(model.named_parameters())
    state = {"params": params, "opt": opt.init(params)}
    step = (make_train_step(model, opt) if micro == 1
            else make_accum_train_step(model, opt, micro))
    g = torch.Generator().manual_seed(7)
    losses = []
    for _ in range(steps):
        toks = torch.randint(0, model.cfg.vocab, (2, 9), generator=g)
        state, metrics = step(state, {"tokens": toks[:, :-1],
                                      "labels": toks[:, 1:]})
        losses.append(metrics["loss"].clone())
    return losses


def _children(rec):
    """{span id: the spans whose parent it is}."""
    out = {}
    for s in rec.spans:
        out.setdefault(s.parent, []).append(s)
    return out


def _refuse(*_a, **_k):
    raise AssertionError("called with recording off")


def test_off_a_span_reads_no_clock_and_opens_no_range(monkeypatch):
    """Recording off, the engine and a train step run (under a profiler
    too) without the recorder's clock, ranges or allocator reads."""
    monkeypatch.setattr(telemetry, "_clock", _refuse)
    monkeypatch.setattr(telemetry, "_record_function", _refuse)
    monkeypatch.setattr(telemetry, "_allocator_counts", _refuse)
    callbacks = list(gc.callbacks)
    assert telemetry.active is None
    assert telemetry.span("x", device="cpu", req=1) is telemetry.OFF
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ids, done = _serve()
        _train(steps=1)
    assert sorted(c.id for c in done) == ids
    names = {e.name for e in prof.events()}
    assert not names & (ENGINE | {"engine.step", "train.step",
                                  "train.optimizer"})
    assert gc.callbacks == callbacks and telemetry.active is None


def test_outputs_are_equal_on_and_off():
    off = (_serve(), _train())
    rec = telemetry.start()
    on = (_serve(), _train())
    telemetry.stop()
    assert rec.spans
    (ids_a, done_a), loss_a = off
    (ids_b, done_b), loss_b = on
    assert ids_a == ids_b
    assert [(c.id, c.tokens) for c in done_a] == \
        [(c.id, c.tokens) for c in done_b]
    assert all(torch.equal(a, b) for a, b in zip(loss_a, loss_b))


def test_engine_steps_hold_their_children():
    rec = telemetry.start()
    _serve()
    telemetry.stop()
    kids = _children(rec)
    steps = [s for s in rec.spans if s.name == "engine.step"]
    assert steps and all(s.parent is None for s in steps)
    assert all(s.start <= s.end for s in rec.spans)
    by_id = {s.id: s for s in rec.spans}
    for s in rec.spans:
        if s.name in ENGINE:
            parent = by_id[s.parent]
            assert parent.name in ("engine.step", "engine.admit")
            assert parent.start <= s.start <= s.end <= parent.end
    for st in steps:
        assert set(st.attrs) == {"queued", "active", "free"}
        assert st.attrs["active"] + st.attrs["free"] == 2
        names = [c.name for c in kids.get(st.id, []) if c.name != "gc"]
        assert set(names) <= ENGINE
        if "engine.decode" in names:
            # the decode, then the host's read of its tokens
            i = names.index("engine.decode")
            assert names[i + 1] == "engine.read"
            dec = [c for c in kids[st.id] if c.name == "engine.decode"]
            assert len(dec) == 1 and dec[0].attrs["rows"] >= 1
        admits = [c for c in kids.get(st.id, []) if c.name == "engine.admit"]
        for adm in admits:
            # a request of one token retires as it is admitted
            got = [c.name for c in kids[adm.id] if c.name != "gc"]
            assert got in (ADMIT, ADMIT + ["engine.retire"])
    # a step that starts with an active request decodes
    for st in steps:
        if st.attrs["active"]:
            assert "engine.decode" in [c.name for c in kids[st.id]]


def test_every_request_is_admitted_and_retired_once():
    rec = telemetry.start()
    ids, done = _serve()
    telemetry.stop()
    admits = [s for s in rec.spans if s.name == "engine.admit"]
    retires = [s for s in rec.spans if s.name == "engine.retire"]
    assert sorted(s.attrs["req"] for s in admits) == sorted(ids)
    assert sorted(s.attrs["req"] for s in retires) == sorted(ids)
    assert all(s.attrs["queue_wait_s"] >= 0 for s in admits)
    # the later requests waited for a slot
    assert max(s.attrs["queue_wait_s"] for s in admits) > 0
    lengths = {s.attrs["req"]: s.attrs["prompt_tokens"] for s in admits}
    assert [lengths[i] for i in ids] == [3, 9, 5, 12, 4]
    tokens = {c.id: len(c.tokens) for c in done}
    assert {s.attrs["req"]: s.attrs["tokens"] for s in retires} == tokens


def test_a_request_submitted_before_recording_has_no_queue_wait():
    model = _model()
    eng = ServingEngine(model, slots=1, max_len=16, device="cpu")
    eng.submit(np.arange(4), max_new=2)
    rec = telemetry.start()
    eng.run_until_drained()
    telemetry.stop()
    (adm,) = [s for s in rec.spans if s.name == "engine.admit"]
    assert adm.attrs["queue_wait_s"] is None


@pytest.mark.parametrize("micro", [1, 2])
def test_a_train_step_holds_forward_backward_and_optimizer(micro):
    rec = telemetry.start()
    _train(steps=2, micro=micro)
    telemetry.stop()
    kids = _children(rec)
    steps = [s for s in rec.spans if s.name == "train.step"]
    assert len(steps) == 2 and all(s.parent is None for s in steps)
    for st in steps:
        names = [c.name for c in kids[st.id] if c.name != "gc"]
        assert names == (["train.forward", "train.backward"] * micro
                         + ["train.optimizer"])
        if micro > 1:
            assert [c.attrs["micro"] for c in kids[st.id]
                    if c.name == "train.forward"] == list(range(micro))


def test_a_collection_inside_a_span_is_its_gc_child():
    rec = telemetry.start()
    with telemetry.span("outer") as outer:
        gc.collect()
    gc.collect()
    telemetry.stop()
    gcs = [s for s in rec.spans if s.name == "gc"]
    inside = [s for s in gcs if s.parent == outer.id]
    assert inside and inside[0].attrs["generation"] == 2
    assert outer.start <= inside[0].start <= inside[0].end <= outer.end
    assert any(s.parent is None for s in gcs)
    assert rec._gc not in gc.callbacks
    n = len(rec.spans)
    gc.collect()
    assert len(rec.spans) == n


def test_each_thread_has_its_own_stack():
    rec = telemetry.start()
    seen = {}

    def other():
        with telemetry.span("theirs") as s:
            seen["theirs"] = s

    with telemetry.span("mine") as mine:
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with telemetry.span("child") as child:
            pass
    telemetry.stop()
    assert seen["theirs"].parent is None and child.parent == mine.id
    assert seen["theirs"].thread != mine.thread


def test_spans_are_profiler_ranges_over_the_aten_ops_they_ran():
    from torch.profiler import ProfilerActivity, profile
    rec = telemetry.start()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _train(steps=1)
        _serve(lengths=(3,), max_new=(3,), slots=1)
    telemetry.stop()
    events = prof.events()
    names = {e.name for e in events}
    assert {"train.step", "train.forward", "train.backward",
            "train.optimizer", "engine.step", "engine.admit",
            "model.prefill", "engine.decode"} <= names

    def under(e, name):
        while e is not None:
            if e.name == name:
                return True
            e = e.cpu_parent
        return False

    for name in ("train.forward", "train.optimizer", "engine.decode"):
        assert any(e.name.startswith("aten::") and under(e, name)
                   for e in events), name
    # a span outside a profiler opens no range
    assert rec.spans and all(s._range is None or s.name in names
                             for s in rec.spans)


def test_a_range_the_caller_wraps_the_update_in_stays_innermost():
    """``train.optimizer`` is opened around the optimizer's call, so a
    range wrapped around ``update`` on the instance lies inside it, with
    the update's ops directly under it (the trace mirrors only the
    innermost range on the device)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    model = _model()
    opt = AdamW(AdamWConfig(warmup_steps=1, total_steps=10))
    params = dict(model.named_parameters())
    state = {"params": params, "opt": opt.init(params)}
    update = opt.update

    def wrapped(*a, **k):
        with record_function("caller:update"):
            return update(*a, **k)

    opt.update = wrapped
    toks = torch.randint(0, model.cfg.vocab, (2, 9),
                         generator=torch.Generator().manual_seed(1))
    telemetry.start()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        make_train_step(model, opt)(state, {"tokens": toks[:, :-1],
                                            "labels": toks[:, 1:]})
    telemetry.stop()
    events = prof.events()
    (outer,) = [e for e in events if e.name == "caller:update"]
    assert outer.cpu_parent.name == "train.optimizer"
    assert not any(e.name.startswith("train.")
                   for e in events if _under(e, "caller:update"))


def _under(e, name):
    e = e.cpu_parent
    while e is not None:
        if e.name == name:
            return True
        e = e.cpu_parent
    return False


def test_the_cpu_records_no_device_time_nor_allocator_counts():
    rec = telemetry.start()
    _serve(lengths=(3, 5), max_new=(2, 2))
    _train(steps=1)
    telemetry.stop()
    assert rec.spans
    assert all(s.device_ms is None for s in rec.spans)
    assert not any("mallocs" in s.attrs for s in rec.spans)


def test_one_recorder_at_a_time():
    rec = telemetry.start()
    with pytest.raises(RuntimeError, match="already active"):
        telemetry.start()
    assert telemetry.stop() is rec and telemetry.stop() is None
