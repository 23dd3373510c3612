"""The port's spans (``repro_torch.core.spans``) on the CPU: nothing
recorded and no profiler call while recording is off; records with their
parent, request and thread under the torch profiler, each span's mark
holding on the profiler's timeline the operations it wraps; a request
carried from ``Runtime.submit`` to the worker that launches the task; each
span's CUDA events on the card of the stream it times (two cards mocked);
the spans of a served prefill and of a tasked decode loop in their order;
and the runtime's counters taken at the same boundaries."""
import contextlib
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.apps import jacobi3d as app
from repro_torch.configs import get_smoke_config
from repro_torch.core import Runtime, RuntimeConfig, spans
from repro_torch.launch.serve import Engine
from repro_torch.models import build_smoke
from repro_torch.serve import tasked_decode_loop


def _names(recs):
    return [r.name for r in recs]


@pytest.fixture(scope="module")
def yi():
    cfg = get_smoke_config("yi-9b")
    model = build_smoke(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    return cfg, model, params, toks


def test_off_records_nothing_and_calls_no_profiler(monkeypatch):
    with spans.recording():
        with spans.span("before"):
            pass

    def no_mark(name):
        raise AssertionError(f"a mark for {name} while recording is off")
    monkeypatch.setattr(spans, "_mark", no_mark)
    with spans.request("engine.prefill", batch=1), spans.span("model.norm"):
        assert spans.current_request() is None
    with Runtime(RuntimeConfig(device="cpu", cpu_devices=1)) as rt:
        x = rt.hetero_object(np.ones(4, np.float32))
        rt.run(lambda v: v + 1, [(x, "rw")])
        rt.barrier()
        assert x.get()[0] == 2
    assert _names(spans.records()) == ["before"]


def test_profiler_records_parents_requests_threads_and_marks():
    x = torch.randn(64, 64)
    seen = {}

    def other():
        with spans.span("other.thread") as rec:
            seen["rec"] = rec
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.request("outer", batch=3) as outer:
            with spans.span("inner") as inner:
                x @ x
            th = threading.Thread(target=other, name="side")
            th.start()
            th.join(timeout=10)
    assert not th.is_alive()
    recs = {r.name: r for r in spans.records()}
    assert set(recs) == {"outer", "inner", "other.thread"}
    assert outer.parent is None and outer.request is not None
    assert outer.attrs == {"batch": 3}
    assert inner.parent == outer.id and inner.request == outer.request
    assert inner.thread == outer.thread == threading.current_thread().name
    side = seen["rec"]
    assert side.thread == "side" and side.parent is None
    assert side.request is None
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert inner.device_ms is None       # no card
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    (m0, m1), = events["inner"]
    (o0, o1), = events["outer"]
    assert o0 <= m0 and m1 <= o1
    assert any(m0 <= a and b <= m1 for a, b in events["aten::mm"])
    # a new profiler session is a new recording period
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("next"):
            pass
    assert _names(spans.records()) == ["next"]


def test_a_request_crosses_from_submit_to_the_worker():
    def kernel(v):
        with spans.span("in.kernel"):
            return v * 2
    with Runtime(RuntimeConfig(device="cpu", cpu_devices=1)) as rt:
        x = rt.hetero_object(np.ones(8, np.float32))
        with spans.recording():
            with spans.request("client") as client:
                task = rt.run(kernel, [(x, "rw")])
                rt.barrier()
        assert task.request == client.request
    recs = spans.records()
    by = {r.name: r for r in recs}
    assert by["runtime.submit"].request == client.request
    assert by["runtime.submit"].attrs == {"task": task.id}
    launch = by["runtime.launch"]
    assert launch.request == client.request
    assert launch.attrs == {"task": task.id}
    assert launch.thread.startswith("repro-worker") and launch.parent is None
    assert by["in.kernel"].parent == launch.id
    assert by["in.kernel"].request == client.request
    assert by["runtime.barrier"].parent == client.id


def test_events_keep_to_the_card_of_their_stream(monkeypatch):
    """Two cards mocked, each with its default stream at raw handle 0: a
    span records its events on the stream current on the card current
    where it opens, or on the stream it is given (a worker launching on
    card 1's compute stream from card 0), and a read event is reused only
    on the card that made it."""
    class Stream:
        def __init__(self, device):
            self.device_index = device

    recorded = []

    class Event:
        made = 0

        def __init__(self, enable_timing=False):
            self.device = None
            Event.made += 1

        def record(self, stream):
            if self.device is None:
                self.device = stream.device_index
            assert self.device == stream.device_index, \
                "an event recorded on another card's stream"
            recorded.append(stream)

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return 1.5

    card = {"now": 0}
    default = {0: Stream(0), 1: Stream(1)}
    compute = Stream(1)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: default[card["now"]])
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: card["now"],
                        raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda device: 0, raising=False)
    monkeypatch.setattr(spans, "_streams", {})
    monkeypatch.setattr(spans, "_free_events", {})
    for period in range(3):
        recorded.clear()
        with spans.recording():
            for c in (0, 1, 0):
                card["now"] = c
                with spans.span("on.default"):
                    pass
            card["now"] = 0
            with spans.span("runtime.launch", stream=compute):
                pass
        assert [r.device_ms for r in spans.records()] == [1.5] * 4
        want = [default[0], default[1], default[0], compute]
        assert recorded == [s for s in want for _ in range(2)], period
        assert Event.made == 8           # made in the first period only


def test_prefill_spans_each_layer_under_its_request(yi):
    cfg, model, params, toks = yi
    eng = Engine(model, params, 2, 24)
    with spans.recording():
        eng.prefill(toks, logits=True)
    recs = spans.records()
    top = recs[0]
    assert top.name == "engine.prefill" and top.attrs == {"batch": 2,
                                                          "tokens": 16}
    assert all(r.request == top.request for r in recs)
    names = _names(recs)
    n = cfg.n_layers
    assert names.count("model.attention") == n
    assert names.count("model.mlp") == n
    assert names.count("model.norm") == 2 * n + 1
    assert names[:3] == ["engine.prefill", "engine.init_cache",
                         "model.forward"]
    assert names[-1] == "model.unembed"
    fwd = recs[2]
    layer = [r for r in recs if r.parent == fwd.id][:4]
    assert _names(layer) == ["model.norm", "model.attention", "model.norm",
                             "model.mlp"]


def test_tasked_decode_loop_spans_in_order(yi):
    cfg, model, params, toks = yi
    steps, s = 6, toks.shape[1]
    nxt, cache = Engine(model, params, 2, s + steps).prefill(toks)
    with spans.recording():
        rt = Runtime(RuntimeConfig(device="cpu", cpu_devices=1,
                                   trace_graphs=True))
        try:
            tasked_decode_loop(rt, model, params, cache, nxt,
                               torch.full((2,), s, dtype=torch.int32), steps)
            stats = rt.stats()
        finally:
            rt.shutdown()
    recs = spans.records()
    by = {}
    for r in recs:
        by.setdefault(r.name, []).append(r)
    gen, = by["serve.generation"]
    init, = by["runtime.init"]
    down, = by["runtime.shutdown"]
    adopt, = by["serve.adopt"]
    compile_, = by["taskgraph.compile"]
    assert by["topology.probe"][0].parent == init.id
    assert init.end_ns <= gen.start_ns and gen.end_ns <= down.start_ns
    assert adopt.parent == gen.id and compile_.parent == gen.id
    replays = by["taskgraph.replay"]
    assert len(replays) == steps - 3 == stats["graph_replays"]
    assert adopt.end_ns <= compile_.start_ns <= replays[0].start_ns
    assert all(r.parent == gen.id for r in replays)
    # the interpreted steps: submitted and launched under the generation's
    # request, each running the model step; a CPU device runs each replayed
    # step's chain eagerly under its replay
    assert len(by["runtime.submit"]) == len(by["runtime.launch"]) == 3
    assert {r.request for r in by["runtime.launch"]} == {gen.request}
    launched = {r.id for r in by["runtime.launch"]}
    replayed = {r.id for r in replays}
    fwd = by["model.forward"]
    assert sum(r.parent in launched for r in fwd) == 3
    assert sum(r.parent in replayed for r in fwd) == steps - 3
    assert {r.request for r in fwd} == {gen.request}
    assert len(by["model.attention"]) == steps * cfg.n_layers


def test_stats_count_adoptions_and_captures(yi):
    cfg, model, params, toks = yi
    steps, s = 5, toks.shape[1]
    nxt, cache = Engine(model, params, 2, s + steps).prefill(toks)
    leaves = []

    def walk(t):
        for v in t.values():
            walk(v) if isinstance(v, dict) else leaves.append(v)
    walk(params.tree())
    walk(cache)
    lengths = torch.full((2,), s, dtype=torch.int32)
    want = sum(t.numel() * t.element_size() for t in leaves) \
        + nxt.numel() * nxt.element_size() \
        + lengths.numel() * lengths.element_size()
    with Runtime(RuntimeConfig(device="cpu", cpu_devices=1,
                               trace_graphs=True)) as rt:
        assert rt.stats()["objects_adopted"] == 0
        tasked_decode_loop(rt, model, params, cache, nxt, lengths, steps)
        st = rt.stats()
    assert st["objects_adopted"] == len(leaves) + 2
    assert st["bytes_adopted"] == want
    # a CPU device replays its chains eagerly: nothing is captured
    assert st["graph_replays"] == steps - 3 and st["graph_captures"] == 0


def test_run_tasked_spans_upload_sweeps_and_download():
    u0 = np.random.default_rng(0).random((8, 6, 4)).astype(np.float32)
    with Runtime(RuntimeConfig(device="cpu", cpu_devices=2)) as rt:
        with spans.recording():
            got = app.run_tasked(u0, 3, rt, over_decomposition=2)
    np.testing.assert_array_equal(got, app.run_reference(u0, 3,
                                                         device="cpu"))
    top = [r.name for r in spans.records() if r.name.startswith("jacobi.")]
    assert top == ["jacobi.upload", "jacobi.sweeps", "jacobi.download"]


def test_moe_spans_nest_under_each_mlp_and_cost_nothing_off(monkeypatch):
    """OLMoE's smoke model: ``moe.route``, ``moe.experts`` and
    ``moe.combine`` once each, in that order, under every layer's
    ``model.mlp``; with recording off the MoE layer records nothing and
    calls no profiler."""
    cfg = get_smoke_config("olmoe-1b-7b-0924")
    model = build_smoke(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    eng = Engine(model, params, 2, 16)
    with spans.recording():
        eng.prefill(toks)
    recs = spans.records()
    mlps = [r for r in recs if r.name == "model.mlp"]
    assert len(mlps) == cfg.n_layers
    for mlp in mlps:
        kids = [r for r in recs if r.parent == mlp.id]
        assert _names(kids) == ["moe.route", "moe.experts", "moe.combine"]
        assert all(mlp.start_ns <= r.start_ns <= r.end_ns <= mlp.end_ns
                   for r in kids)
    moe_names = [n for n in _names(recs) if n.startswith("moe.")]
    assert len(moe_names) == 3 * cfg.n_layers

    def no_mark(name):
        raise AssertionError(f"a mark for {name} while recording is off")
    monkeypatch.setattr(spans, "_mark", no_mark)
    eng.prefill(toks)
    assert _names(spans.records()) == _names(recs)
