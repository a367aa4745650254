"""Spans and counters of the render path, and where a profiler trace's
device time and idle fall among them.

    from gpcr_tpu_torch.utils import trace

    with trace.recording() as rec:
        renderer.render(...)
    rec.spans      # [Span], in the order they opened
    rec.counters   # {request: {name: total}}; request None: outside one

Off (the default), ``span`` returns one shared no-op object: it reads no
clock, allocates nothing and enters no ``record_function``; ``count``
returns after one test. On, a span records its name, its host interval on
the ``time.perf_counter_ns`` clock, its parent and its request (the
ordinal of the enclosing ``gpcr.render`` span, so every span of one
request shares it), and, while a ``torch.profiler`` records, enters
``torch.profiler.record_function(name)``, so a Chrome trace from
``utils.debug.trace`` shows it too. Nothing here waits for the device;
the counters take values the host already holds.

``Recorder.attribute(prof)`` reads a finished ``torch.profiler.profile``
taken while recording: each device activity goes to the innermost span
whose host interval holds its launch (the runtime record of the same
correlation id), and each stretch of device idle to the innermost span the
host was in meanwhile.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import threading
import time
import typing as T

import torch

ROOT = "gpcr.render"
OUTSIDE = "(no span)"

_REC: T.Optional["Recorder"] = None  # the recording in force, if any


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


@dataclasses.dataclass(slots=True)
class Span:
    name: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: int = -1  # -1 while open
    parent: int = -1  # index in Recorder.spans; -1 for a root
    request: T.Optional[int] = None  # ordinal of the enclosing gpcr.render


class _Open:
    """An open span; ``device`` (a CUDA device) also counts the caching
    allocator's ``cudaMalloc`` calls over it as ``device_allocs``, read
    outside the span's clock (a read takes 17-29 us on an H100's host)."""

    __slots__ = ("rec", "name", "device", "index", "rf", "allocs")

    def __init__(self, rec, name, device=None):
        self.rec, self.name, self.device = rec, name, device

    def __enter__(self):
        if self.device is not None:
            self.allocs = _device_allocs(self.device)
        self.index = self.rec._open(self.name)
        # a range costs ~10 us: entered only while a profiler records
        self.rf = None
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return self.rec.spans[self.index]

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.rec._close(self.index)
        if self.device is not None:
            self.rec._count("device_allocs",
                            _device_allocs(self.device) - self.allocs,
                            self.rec.spans[self.index].request)
        return False


def _device_allocs(device) -> int:
    return torch.cuda.memory_stats_as_nested_dict(device)["num_device_alloc"]


class Recorder:
    """What one ``recording()`` saw. Spans nest per thread; a span opened
    on another thread than its parent's is a root."""

    def __init__(self):
        self.spans: T.List[Span] = []
        self.counters: T.Dict[T.Optional[int], T.Dict[str, int]] = {}
        self.requests = 0
        self._local = threading.local()
        self._lock = threading.Lock()
        # the profiler stamps its events on the wall clock
        self._wall_minus_perf = time.time_ns() - time.perf_counter_ns()

    def _stack(self) -> list:
        return self._local.__dict__.setdefault("stack", [])

    def _open(self, name: str) -> int:
        stack = self._stack()
        parent = stack[-1] if stack else -1
        request = self.spans[parent].request if stack else None
        with self._lock:
            if name == ROOT and request is None:
                request = self.requests
                self.requests += 1
            self.spans.append(Span(name, time.perf_counter_ns(),
                                   parent=parent, request=request))
            index = len(self.spans) - 1
        stack.append(index)
        return index

    def _close(self, index: int) -> None:
        self.spans[index].end_ns = time.perf_counter_ns()
        self._stack().pop()

    def add(self, name: str, n) -> None:
        """Add ``n`` to counter ``name`` of the request this thread is in
        (None outside one)."""
        stack = self._stack()
        self._count(name, n, self.spans[stack[-1]].request if stack else None)

    def _count(self, name: str, n, request: T.Optional[int]) -> None:
        with self._lock:
            per = self.counters.setdefault(request, {})
            per[name] = per.get(name, 0) + int(n)

    def trace_shift_ns(self, prof) -> int:
        """What to add to a span's ``perf_counter_ns`` time to get the
        time base of ``prof``'s events (``FunctionEvent.time_range``, us
        after ``kineto_results.trace_start_ns()``), in ns. The profiler
        stamps its events on the wall clock and its start,
        ``profiling_start_time_ns``, on the ``perf_counter`` clock: the
        recorder's wall-clock offset maps one onto the other, which is
        checked on the profiler's start."""
        base = prof.profiler.kineto_results.trace_start_ns()
        start = prof.profiler.profiling_start_time_ns
        miss = start + self._wall_minus_perf - base
        if abs(miss) > 10**9:
            raise ValueError(
                f"the profiler's start maps {miss / 1e9:.3f} s from its "
                "trace's start: its clocks are not the wall clock and "
                "time.perf_counter_ns")
        return self._wall_minus_perf - base

    def attribute(self, prof) -> dict:
        """Host, device and device-idle time per span name over a
        finished profile taken while recording (``by_span``'s result),
        plus ``launch_records``: how many device activities had a launch
        record to place them by."""
        shift = self.trace_shift_ns(prof)
        open_ = [s.name for s in self.spans if s.end_ns < 0]
        if open_:
            raise ValueError(f"spans still open: {open_}")
        spans = [(s.name, (s.start_ns + shift) / 1e3,
                  (s.end_ns + shift) / 1e3, s.parent) for s in self.spans]
        device, launches = profiler_activities(prof)
        out = by_span(spans, device)
        out["launch_records"] = launches
        return out


def span(name: str):
    """A context that records ``name`` while a recording is on."""
    rec = _REC
    if rec is None:
        return NO_SPAN
    return _Open(rec, name)


def request(device):
    """``gpcr.render``, the root span of one request; on a CUDA device it
    also counts ``device_allocs`` (the allocator's ``num_device_alloc``
    over the span, read only while recording)."""
    rec = _REC
    if rec is None:
        return NO_SPAN
    dev = torch.device(device)
    return _Open(rec, ROOT, dev if dev.type == "cuda" else None)


def count(name: str, n) -> None:
    """Add ``n`` (a number the host holds) to the current request's
    counter ``name`` while a recording is on."""
    rec = _REC
    if rec is None:
        return
    rec.add(name, n)


@contextlib.contextmanager
def recording():
    """Record spans and counters inside the block; yields the Recorder.
    An inner recording takes over from an outer one until it ends."""
    global _REC
    rec = Recorder()
    kept, _REC = _REC, rec
    try:
        yield rec
    finally:
        _REC = kept


# --------------------------------------------------------------------------
# attribution (pure arithmetic on intervals of one clock)
# --------------------------------------------------------------------------


def _runtime_call(e) -> bool:
    """A CUDA runtime or driver API record (``cudaLaunchKernel``,
    ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...), by its name."""
    return e.name().startswith("cu")


def profiler_activities(prof):
    """The device activities of a finished profile: ([(start, end,
    launch)], number with a launch record), in us of the profile's time
    base; ``launch`` is the host start of the runtime call of the same
    correlation id, None without one. The device copies of
    ``record_function`` ranges (user annotations) are not activities."""
    kr = prof.profiler.kineto_results
    base = kr.trace_start_ns()
    host, dev = {}, []
    for e in kr.events():
        if e.device_type().name == "CPU":
            if _runtime_call(e):
                host[e.correlation_id()] = (e.start_ns() - base) / 1e3
        elif not e.is_user_annotation():
            dev.append(((e.start_ns() - base) / 1e3,
                        (e.end_ns() - base) / 1e3, e.correlation_id()))
    out = [(s, t, host.get(c)) for s, t, c in dev]
    return out, sum(h is not None for _, _, h in out)


def innermost(spans) -> T.List[T.Tuple[float, float, int]]:
    """Cut the time from the first start of ``spans`` ((name, start, end,
    parent), nested: a child lies inside its parent) to the last end into
    (start, end, index) segments, index naming the innermost span open over
    the segment, -1 where none is."""
    order = sorted(range(len(spans)),
                   key=lambda i: (spans[i][1], -spans[i][2], i))
    segs, stack, at = [], [], None
    for i in order:
        s = spans[i][1]
        while stack and spans[stack[-1]][2] <= s:
            j = stack.pop()
            segs.append((at, spans[j][2], j))
            at = spans[j][2]
        if stack:
            segs.append((at, s, stack[-1]))
        elif at is not None:
            segs.append((at, s, -1))
        stack.append(i)
        at = s
    while stack:
        j = stack.pop()
        segs.append((at, spans[j][2], j))
        at = spans[j][2]
    return [g for g in segs if g[1] > g[0]]


def _busy_gaps(device, start: float, stop: float):
    """The stretches of [start, stop] with no device activity."""
    out, at = [], start
    for s, e, _ in sorted(device, key=lambda d: d[:2]):
        if s > at:
            out.append((at, min(s, stop)))
        at = max(at, e)
        if at >= stop:
            break
    if at < stop:
        out.append((at, stop))
    return [g for g in out if g[1] > g[0]]


def by_span(spans, device) -> dict:
    """Per span name, over ``spans`` ((name, start, end, parent), nested,
    a parent listed before its children) and ``device`` activities
    ((start, end, launch)), all in us of one clock:

    - ``count``, ``host_ms``: the spans and their summed host time;
    - ``device_ms``: device time launched while the host was inside the
      span (its children included);
    - ``idle_ms``: device idle while the host was inside it, children
      included; ``self_idle_ms``: while it was the innermost span.

    Idle is read between the first span's start and the last one's end.
    Totals: ``device_ms`` (all activity), ``placed_ms`` (launched inside
    some span), ``idle_ms`` (all idle), ``idle_in_root_ms`` (idle inside a
    root span) and ``idle_under_child_ms`` (of it, under a child span).
    Activity launched, or idle spent, outside every span is listed under
    ``(no span)``."""
    segs = innermost(spans)
    seg_starts = [g[0] for g in segs]

    def at(t):
        k = bisect.bisect_right(seg_starts, t) - 1
        return segs[k][2] if k >= 0 and t < segs[k][1] else -1

    n = len(spans)
    self_dev = [0.0] * (n + 1)  # [-1]: outside every span
    self_idle = [0.0] * (n + 1)
    total_dev = 0.0
    for s, e, launch in device:
        total_dev += e - s
        self_dev[at(launch) if launch is not None else -1] += e - s
    if spans:
        lo = min(sp[1] for sp in spans)
        hi = max(sp[2] for sp in spans)
        gaps = _busy_gaps(device, lo, hi)
    else:
        gaps = []
    total_idle = sum(b - a for a, b in gaps)
    # cut each gap at the segment boundaries inside it
    for a, b in gaps:
        k = max(bisect.bisect_right(seg_starts, a) - 1, 0)
        while k < len(segs) and segs[k][0] < b:
            lo_k, hi_k = max(a, segs[k][0]), min(b, segs[k][1])
            if hi_k > lo_k:
                self_idle[segs[k][2]] += hi_k - lo_k
            k += 1

    inc_dev, inc_idle = self_dev[:n], self_idle[:n]
    for i in reversed(range(n)):  # a parent comes before its children
        p = spans[i][3]
        if p >= 0:
            inc_dev[p] += inc_dev[i]
            inc_idle[p] += inc_idle[i]
    names: dict = {}
    for i, (name, s, e, p) in enumerate(spans):
        row = names.setdefault(name, dict(count=0, host_ms=0.0, device_ms=0.0,
                                          idle_ms=0.0, self_idle_ms=0.0))
        row["count"] += 1
        row["host_ms"] += (e - s) / 1e3
        row["device_ms"] += inc_dev[i] / 1e3
        row["idle_ms"] += inc_idle[i] / 1e3
        row["self_idle_ms"] += self_idle[i] / 1e3
    if self_dev[-1] or self_idle[-1]:
        names[OUTSIDE] = dict(count=0, host_ms=0.0,
                              device_ms=self_dev[-1] / 1e3,
                              idle_ms=self_idle[-1] / 1e3,
                              self_idle_ms=self_idle[-1] / 1e3)
    roots = [i for i in range(n) if spans[i][3] < 0]
    idle_in_root = sum(inc_idle[i] for i in roots)
    return {
        "spans": names,
        "device_ms": total_dev / 1e3,
        "placed_ms": (total_dev - self_dev[-1]) / 1e3,
        "idle_ms": total_idle / 1e3,
        "idle_in_root_ms": idle_in_root / 1e3,
        "idle_under_child_ms": (idle_in_root
                                - sum(self_idle[i] for i in roots)) / 1e3,
    }

