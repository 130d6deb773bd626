"""The turbo mapper's span record (sigmap_tpu_torch/mapping/spans.py) on
the mixed-length workload of tests/test_torch_turbo.py, cut to its first
read batches (some of its off-target reads overflow and go to the rescue).

Four passes of one mapper: of two batches, with each batch prepared inline
and with the cross-batch overlap, no profiler running; then of one batch
(a profiler slows the CPU's rounds some five times), inline under
``torch.profiler.profile(activities=[CPU])`` and with the overlap under a
profiler that records every thread (``profile_all_threads``).  Every span
of the table in spans.py appears with its pass's ``pass_id``, a child lies
inside its parent, only rescued reads have spans of their own, the legacy
stamps are the spans' clock reads, the records do not change, and
``record_function`` is entered for each span exactly while a profiler
records.
"""

import collections
import json
import threading
from dataclasses import dataclass

import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from sigmap_tpu_torch.mapping import spans as sp
from sigmap_tpu_torch.mapping import turbo as port
from _torch_util import (  # noqa: F401 - fixtures
    MIXED_BATCH, PARAMS, mixed_workload, workload,
)
from test_torch_turbo import PREPARE_THREAD, _without_mt

RESCUE_THREAD = "sigmap-turbo-rescue"
CALLER = threading.current_thread().name

HEAD = ("head.stage", "head.quantize", "head.features")
PER_BATCH = (*HEAD, "round.loop", "round.epilogue")
PARENT = {"head.stage": "map.pass", "head.quantize": "map.pass",
          "head.features": "map.pass", "head.wait": "map.pass",
          "round.loop": "map.pass", "round.launch": "round.loop",
          "round.signal": "round.loop", "round.epilogue": "map.pass",
          "rescue.read": "round.epilogue", "rescue.search": "rescue.read",
          "rescue.drain": "map.pass"}

# name, overlap, profiler options (None: no profiler), read batches
RUNS = (("inline", False, None, 2), ("overlap", True, None, 2),
        ("profiled", False, {}, 1),
        ("all_threads", True, dict(experimental_config=_ExperimentalConfig(
            profile_all_threads=True)), 1))
NAMES = [n for n, *_ in RUNS]


@dataclass
class Pass:
    records: list
    stamps: dict          # the mapper's last_pass
    entered: list         # names record_function was entered with
    trace: list | None    # the exported trace's user_annotation events


@pytest.fixture(scope="module")
def passes(mixed_workload, tmp_path_factory):
    cfg, idx, _, signals = mixed_workload
    mapper = port.TurboMapper(idx, cfg, port.TurboParams(**PARAMS),
                              device="cpu")
    real = torch.profiler.record_function
    out = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            for name, overlap, options, batches in RUNS:
                part = signals[:batches * cfg.runtime.read_batch]
                entered = []

                def record_function(n, *a, entered=entered, **k):
                    entered.append(n)
                    return real(n, *a, **k)

                mp.setattr(torch.profiler, "record_function", record_function)
                mapper._overlap_batches = overlap
                trace = None
                if options is None:
                    records = mapper.streaming_map(part)
                else:
                    with profile(activities=[ProfilerActivity.CPU],
                                 **options) as prof:
                        records = mapper.streaming_map(part)
                    path = tmp_path_factory.mktemp("trace") / f"{name}.json"
                    prof.export_chrome_trace(str(path))
                    trace = [e for e in json.loads(path.read_text())[
                        "traceEvents"] if e.get("cat") == "user_annotation"]
                out[name] = Pass(records, mapper.last_pass, entered, trace)
    finally:
        mapper.close()
    return out


def _named(stamps, name):
    return [s for s in stamps["spans"] if s.name == name]


def test_passes_count_and_rescue(passes):
    """The passes are the mapper's 0th to 3rd, and each rescued reads (the
    rescue spans below are not vacuous)."""
    assert [passes[n].stamps["pass_id"] for n in NAMES] == [0, 1, 2, 3]
    assert all(p.stamps["rescued"] for p in passes.values())


@pytest.mark.parametrize("run", NAMES)
def test_every_span_of_the_table_appears_once_a_batch(passes, run):
    """Every span named in spans.py appears with the pass's pass_id, on its
    thread: per batch its head, round loop and epilogue (and, with the
    overlap, the caller's wait for it), per round a launch and a signal,
    per rescued read one rescue.read and at least one rescue.search (one a
    chunk searched), and once map.pass and rescue.drain; no other span, so
    none per read but the rescued ones."""
    p = passes[run]
    stamps = p.stamps
    _, overlap, _, n_batches = RUNS[NAMES.index(run)]
    n_rounds = len(stamps["round_host"])
    assert len(stamps["rounds"]) == n_batches and n_rounds >= n_batches
    want = {"map.pass": 1, "rescue.drain": 1,
            **{n: n_batches for n in PER_BATCH},
            "round.launch": n_rounds, "round.signal": n_rounds,
            "rescue.read": len(stamps["rescued"])}
    reads = _named(stamps, "rescue.read")
    searched = collections.Counter(
        s.parent for s in _named(stamps, "rescue.search"))
    assert set(searched) == {r.index for r in reads}
    want["rescue.search"] = sum(searched.values())
    if overlap:
        want["head.wait"] = n_batches
    got = collections.Counter(s.name for s in stamps["spans"])
    assert got == want
    assert stamps["spans"][sp.PASS].name == "map.pass"
    assert all(s.pass_id == stamps["pass_id"] for s in stamps["spans"])
    assert [s.index for s in stamps["spans"]] == list(
        range(len(stamps["spans"])))
    for name in (*PER_BATCH, *(("head.wait",) if overlap else ())):
        assert [s.batch for s in _named(stamps, name)] == list(
            range(n_batches)), name
    for s in stamps["spans"]:
        if s.name in ("rescue.read", "rescue.search"):
            assert s.thread.startswith(RESCUE_THREAD)
        elif s.name in HEAD and overlap:
            assert s.thread.startswith(PREPARE_THREAD)
        else:
            assert s.thread == CALLER, (s.name, s.thread)


@pytest.mark.parametrize("run", NAMES)
def test_children_lie_inside_their_parents(passes, run):
    """Each span's parent is the one of spans.py's table and the child lies
    inside it; a rescued read starts after the epilogue of its own batch
    that submitted it did, and ends before the pass's drain does."""
    stamps = passes[run].stamps
    spans = stamps["spans"]
    (whole,), (drain,) = (_named(stamps, n)
                          for n in ("map.pass", "rescue.drain"))
    assert whole.parent is None
    for s in spans:
        assert s.t0 <= s.t1
        if s is whole:
            continue
        parent = spans[s.parent]
        assert parent.name == PARENT[s.name], s.name
        assert parent.t0 <= s.t0, s.name
        if s.name == "rescue.read":
            assert s.t1 <= drain.t1
        else:
            assert s.t1 <= parent.t1, s.name
        if parent.batch is not None:
            assert s.batch == parent.batch


@pytest.mark.parametrize("run", NAMES)
def test_rescue_read_spans_carry_their_cpu_time(passes, run):
    """One rescue.read a rescued read, its thread's CPU time within its
    wall time; its rescue.search spans carry where each chunk was searched
    (the k-d tree: the CPU mapper has no card search), its seeds, its
    matches and its queries whose answer holds per_cap matches (none at
    this size: the cap is 5,000)."""
    stamps = passes[run].stamps
    reads = _named(stamps, "rescue.read")
    assert len(reads) == len(stamps["rescued"]) > 0
    for s in reads:
        assert set(s.numbers) == {"cpu_s"}
        assert 0 <= s.numbers["cpu_s"] <= s.s
    for s in _named(stamps, "rescue.search"):
        assert s.numbers.keys() == {"device", "seeds", "matches",
                                    "past_cap"}
        assert s.numbers["device"] == 0 and s.numbers["seeds"] > 0
        assert s.numbers["past_cap"] == 0
    assert not any(s.numbers for s in stamps["spans"]
                   if s.name not in ("rescue.read", "rescue.search"))


@pytest.mark.parametrize("run", NAMES)
def test_legacy_stamps_are_the_spans_clock_reads(passes, run):
    """start, rounds, round_host and rescues equal what the spans give,
    exactly: a batch's rounds are its round loop's start to its epilogue's
    end (so the readers of the legacy stamps, head_wait_share,
    round_loop_share, round_return_ms and rescue_wait_share, read the
    spans' values), a round's host pair its launch and its launch's start
    to its signal's end, the rescue wait the drain."""
    stamps = passes[run].stamps
    loops, epilogues, launches, signals = (
        _named(stamps, n) for n in ("round.loop", "round.epilogue",
                                    "round.launch", "round.signal"))
    (whole,), (drain,) = (_named(stamps, n)
                          for n in ("map.pass", "rescue.drain"))
    assert stamps["start"] == whole.t0
    assert stamps["rounds"] == [(lo.t0, ep.t1)
                                for lo, ep in zip(loops, epilogues)]
    assert stamps["round_host"] == [(la.t1 - la.t0, si.t1 - la.t0)
                                    for la, si in zip(launches, signals)]
    assert all(si.t0 == la.t1 for la, si in zip(launches, signals))
    assert all(ep.t0 == lo.t1 for lo, ep in zip(loops, epilogues))
    assert stamps["rescues"] == (drain.t0, drain.t1)


def test_records_unchanged_by_the_spans_and_the_profiler(passes):
    """Every pass, overlapped or not, profiled or not, gives the same
    records apart from mt: (those of the first batch for the one-batch
    passes)."""
    first = _without_mt(passes["inline"].records)
    assert len(first) == 2 * MIXED_BATCH
    for name, _, _, batches in RUNS[1:]:
        got = _without_mt(passes[name].records)
        assert got == first[:MIXED_BATCH * batches], name


@pytest.mark.parametrize("run", ["inline", "overlap"])
def test_no_record_function_without_a_profiler(passes, run):
    """With no profiler running, no span enters record_function."""
    p = passes[run]
    assert p.stamps["mirror"] is False
    assert p.entered == []


def test_profiler_trace_holds_the_callers_spans(passes):
    """Under torch.profiler.profile(activities=[CPU]) every span enters
    record_function, and the exported trace holds a user_annotation event
    of each name of the caller's spans."""
    p = passes["profiled"]
    assert p.stamps["mirror"] is True
    assert sorted(p.entered) == sorted(s.name for s in p.stamps["spans"])
    caller = {s.name for s in p.stamps["spans"] if s.thread == CALLER}
    assert {*HEAD, "map.pass", "round.loop", "round.launch",
            "round.signal", "round.epilogue", "rescue.drain"} <= caller
    assert caller <= {e["name"] for e in p.trace}


def test_all_threads_profiler_holds_prepare_and_rescue_spans(passes):
    """A profiler that records every thread also holds the prepare
    thread's head spans and the rescue threads' rescue.read, each on a
    thread other than the caller's."""
    p = passes["all_threads"]
    assert p.stamps["mirror"] is True
    assert sorted(p.entered) == sorted(s.name for s in p.stamps["spans"])
    (caller_tid,) = {e["tid"] for e in p.trace if e["name"] == "map.pass"}
    for name in (*HEAD, "rescue.read", "head.wait"):
        tids = {e["tid"] for e in p.trace if e["name"] == name}
        assert tids, name
        assert (tids == {caller_tid}) is (name == "head.wait"), name


def test_span_outside_a_pass_and_on_error():
    """A span of no pass is kept nowhere; a span whose body raises is
    closed and kept, and the error reaches the caller."""
    with sp.span(None, "x") as s:
        pass
    assert s.index == -1 and s.t1 >= s.t0
    stamps = sp.new_pass(7)
    with pytest.raises(ValueError, match="boom"):
        with sp.span(stamps, "map.pass", None):
            with sp.span(stamps, "round.loop", batch=0):
                raise ValueError("boom")
    whole, loop = stamps["spans"]
    assert (whole.index, loop.index, loop.parent) == (0, 1, sp.PASS)
    assert whole.t0 <= loop.t0 <= loop.t1 <= whole.t1
    assert {whole.pass_id, loop.pass_id} == {7}
