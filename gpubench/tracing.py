"""What the traced run (`--trace 1`) reads, and how.

* `Mirror`, a tracer installed in the program's place
  (`repro_torch.obs.set_tracer`): it records the program's spans as the
  program's own tracer does, opens a `torch.profiler.record_function`
  range of the same name around each, so the spans sit in the device
  trace beside the kernels they launched, and starts and stops the
  profiler at `executor.dispatch` boundaries: bounded stretches of whole
  dispatches, spread over the window, since a whole query launches
  about a million kernels.
* `K1Entries` wraps K1's three entries in `repro_torch.kernels.ops`
  (`level_expand_rows`, `level_expand_compact`, `level_expand`) in a
  range `gpubench.k1.<entry>`: whatever runs beneath the entry is K1's
  time.  With `bounds` set it also reckons each call's bound from its
  arguments (`bounds.py`), which syncs, so it runs in a second pass over
  the profiled dispatches, never inside a profiled stretch.
* `reduce` turns the stretches' events into the device's busy time,
  K1's and the rest's device time, the idle gaps by what the host was
  doing, and the device operations that took most time.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

K1_PREFIX = "gpubench.k1."
DISPATCH = "executor.dispatch"
EXECUTE = "engine.execute"


# ----------------------------------------------------------- K1 entries
class K1Entries:
    """Context manager: K1's entries in `ops` run inside a named range;
    with `bounds` (a list) each call's `bounds.Bound` is appended."""

    NAMES = ("level_expand_rows", "level_expand_compact", "level_expand")

    def __init__(self, ops, bounds: list | None = None):
        self.ops = ops
        self.bounds = bounds
        self.real = {}

    def _wrap(self, name, fn):
        import inspect

        from torch.profiler import record_function

        from . import bounds as B

        label = K1_PREFIX + name
        keep = self.bounds
        sig = inspect.signature(fn)

        def entry(*args, **kw):
            if keep is None:
                with record_function(label):
                    return fn(*args, **kw)
            a = sig.bind(*args, **kw)
            a.apply_defaults()
            a = a.arguments
            off0 = int(a["offset"]) if name == "level_expand_compact" else 0
            with record_function(label):
                out = fn(*args, **kw)
            if name == "level_expand":
                keep.append(B.bound_of(a["cand"], a["starts"], a["lens"],
                                       a["extra"], a["cand_valid"],
                                       a["count"], a["window"]))
                return out
            written = None
            if name == "level_expand_compact":
                total = int(a["offset"]) - off0
                cap = a["parent"].shape[0] - 1
                written = max(min(total, cap - off0), 0)
            keep.append(B.rows_bound_of(
                a["csrc"], a["cstart"], a["clen"], a["flat"], a["starts"],
                a["lens"], a["own"], a["extra"], a.get("neg"),
                dirs=tuple(a["dirs"]), width=a["width"], window=a["window"],
                written=written))
            return out

        return entry

    def __enter__(self):
        for name in self.NAMES:
            self.real[name] = getattr(self.ops, name)
            setattr(self.ops, name, self._wrap(name, self.real[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.ops, name, fn)
        return False


# --------------------------------------------------------------- mirror
def _profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def warm_profiler(device) -> None:
    """Start and stop the profiler once, so the device tracer's own
    start-up cost falls in set-up and not in the first stretch."""
    with _profiler():
        torch.ones(1, device=device).sum().item()


@dataclass
class Stretch:
    """One profiled stretch: its profile, the dispatches it holds
    ((canon_key, v0_start, v0_end, capacity) each) and its host wall."""

    prof: object
    dispatches: list = field(default_factory=list)
    wall_s: float = 0.0


class _MirrorSpan:
    __slots__ = ("mirror", "span", "rf")

    def __init__(self, mirror, span):
        self.mirror = mirror
        self.span = span
        self.rf = None

    def set(self, **attrs):
        self.span.set(**attrs)
        return self

    def __enter__(self):
        from torch.profiler import record_function

        name = self.span.name
        if name == DISPATCH:
            self.mirror._dispatch_open()
        elif name == EXECUTE:
            self.mirror.key = self.span.attrs.get("canon_key")
        self.span.__enter__()
        self.rf = record_function(name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        self.span.__exit__(*exc)
        if self.span.name == DISPATCH:
            self.mirror._dispatch_close(self.span.attrs)
        return False


def make_mirror(starts: list[float], dispatches: int):
    """A tracer (a subclass of the program's `Tracer`) that profiles one
    stretch from each of `starts` (seconds after `begin`): from the
    first dispatch that opens after it, for `dispatches` whole
    dispatches.  A window repeats its queries, so a stretch of one
    query's dispatches holds each of them once, wherever it starts."""
    from repro_torch.obs.trace import Tracer

    class Mirror(Tracer):
        def __init__(self):
            super().__init__(enabled=True)
            self.starts = sorted(starts)
            self.dispatches = dispatches
            self.stretches: list[Stretch] = []
            self.key = None
            self._on = None
            self._t0 = 0.0
            self._begin = None

        def begin(self, t0: float) -> None:
            """The window opened at `t0` (`time.perf_counter()`)."""
            self._begin = t0

        def span(self, name, **attrs):
            return _MirrorSpan(self, super().span(name, **attrs))

        def _dispatch_open(self):
            if self._on is not None or self._begin is None \
                    or not self.starts:
                return
            now = time.perf_counter() - self._begin
            if now < self.starts[0]:
                return
            while self.starts and self.starts[0] <= now:
                self.starts.pop(0)
            prof = _profiler()
            prof.__enter__()
            self._on = Stretch(prof)
            self._t0 = time.perf_counter()

        def _dispatch_close(self, attrs):
            on = self._on
            if on is None:
                return
            on.dispatches.append((self.key, attrs.get("v0_start"),
                                  attrs.get("v0_end"), attrs.get("capacity")))
            if len(on.dispatches) >= self.dispatches:
                self.close()

        def close(self):
            """Stop the open stretch, if any."""
            if self._on is not None:
                self._on.wall_s = time.perf_counter() - self._t0
                self._on.prof.__exit__(None, None, None)
                self.stretches.append(self._on)
                self._on = None

    return Mirror()


@contextlib.contextmanager
def installed(mirror):
    """`mirror` as the program's tracer; on exit the stretch left open
    is stopped and the tracer before it restored."""
    from repro_torch.obs.trace import get_tracer, set_tracer

    old = get_tracer()
    set_tracer(mirror)
    try:
        yield mirror
    finally:
        mirror.close()
        set_tracer(old)


def replay_bounds(engine, stretches, chunk: int, sync) -> list | None:
    """K1's bound for every call of the profiled dispatches: each
    dispatch run again alone (`CountState` of its one span, through the
    cache entry that ran it) with the bounds reckoned, the tracer off.
    None where a dispatch's entry cannot be told apart."""
    from repro_torch.core.executor import CountState
    from repro_torch.kernels import ops
    from repro_torch.obs.trace import Tracer, get_tracer, set_tracer

    entries = defaultdict(list)
    for e in engine.cache.entries():
        entries[e.canon_key].append(e)
    out: list = []
    old = get_tracer()
    set_tracer(Tracer(enabled=False))
    try:
        with K1Entries(ops, bounds=out):
            for st in stretches:
                for key, s, e, cap in st.dispatches:
                    if len(entries.get(key, ())) != 1 or s is None:
                        return None
                    state = CountState(spans=[(s, e, cap)], chunk=chunk)
                    entries[key][0].count_partial(state, max_dispatches=1)
        sync()
    finally:
        set_tracer(old)
    return out


# ------------------------------------------------------------ reduction
@dataclass
class Ev:
    """One profiler event: on the host (`dev` False) or the device."""

    name: str
    t0: int            # ns
    t1: int
    dev: bool
    tid: int = 0
    corr: int = 0
    linked: int = 0
    ann: bool = False             # a record_function range (host or device)


def events_of(prof) -> list[Ev]:
    """The profile's events from the profiler's own results."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        t0 = e.start_ns()
        out.append(Ev(e.name(), t0, t0 + e.duration_ns(),
                      e.device_type() != DeviceType.CPU, e.start_thread_id(),
                      e.correlation_id(), e.linked_correlation_id(),
                      bool(getattr(e, "is_user_annotation", bool)())))
    return out


def _union(iv):
    """Sorted disjoint union of (t0, t1) intervals."""
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _is_span(e) -> bool:
    return ("." in e.name and "::" not in e.name
            and not e.name.startswith(K1_PREFIX))


def _labels(host, tid, times):
    """For each time in `times` (ascending): what the host thread `tid`
    was in, as "<innermost program span> / <innermost operation in it>",
    by one sweep over its events."""
    evs = sorted((e for e in host if e.tid == tid),
                 key=lambda e: (e.t0, -e.t1))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(evs) and evs[i].t0 <= t:
            stack = [s for s in stack if s.t1 > evs[i].t0]
            stack.append(evs[i])
            i += 1
        open_ = [s for s in stack if s.t1 > t]
        span = next((s for s in reversed(open_) if _is_span(s)), None)
        op = next((s for s in reversed(open_) if not _is_span(s)), None)
        out.append(" / ".join(p.name for p in (span, op) if p is not None)
                   or "executor.count, between dispatches")
    return out


@dataclass
class Reading:
    window_ns: int = 0
    busy_ns: int = 0
    device_ns: int = 0
    k1_ns: int = 0
    ops: dict = field(default_factory=lambda: defaultdict(int))
    gaps: dict = field(default_factory=lambda: defaultdict(int))


def reduce(stretches_events: list[list[Ev]]) -> Reading:
    """Sum the stretches.  A stretch's window runs from its first
    dispatch range's start to its last one's end (the profiler's clock).
    The device's own copies of the host's ranges (what the profiler puts
    on the device's timeline for a `record_function`) are not
    operations.  An operation belongs to K1 where it ran inside the
    device's copy of a `gpubench.k1.` range (one stream runs them in
    launch order), or, where the profiler gives no such copy, where the
    host launched it inside the range."""
    r = Reading()
    for evs in stretches_events:
        host = [e for e in evs if not e.dev]
        disp = [e for e in host if e.name == DISPATCH]
        if not disp:
            continue
        w0, w1 = min(e.t0 for e in disp), max(e.t1 for e in disp)
        tid = disp[0].tid
        r.window_ns += w1 - w0
        ranges = {e.name for e in host if e.ann
                  or e.name.startswith(K1_PREFIX) or e.name == DISPATCH}
        dev = [e for e in evs if e.dev and e.t1 > w0 and e.t0 < w1]
        marks = [e for e in dev if e.ann or e.name in ranges]
        dev = [e for e in dev if not (e.ann or e.name in ranges)]
        k1_dev = sorted((e.t0, e.t1) for e in marks
                        if e.name.startswith(K1_PREFIX))
        if k1_dev:
            k1, key = k1_dev, None
        else:
            k1 = sorted((e.t0, e.t1) for e in host
                        if e.name.startswith(K1_PREFIX) and e.tid == tid)
            runtime = {e.corr: e for e in host if e.linked > 0}
            frontend = {e.corr: e for e in host if e.linked == 0}

            def key(e):
                launch = runtime.get(e.corr) or frontend.get(e.linked)
                return None if launch is None or launch.tid != tid \
                    else launch.t0
        k1_t0 = [a for a, _ in k1]
        for e in dev:
            dur = e.t1 - e.t0
            r.device_ns += dur
            r.ops[e.name] += dur
            t = e.t0 if key is None else key(e)
            if t is None:
                continue
            j = bisect.bisect_right(k1_t0, t) - 1
            if j >= 0 and t < k1[j][1]:
                r.k1_ns += dur
        busy = _union([(max(e.t0, w0), min(e.t1, w1)) for e in dev])
        r.busy_ns += sum(b - a for a, b in busy)
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        names = _labels(host, tid, [(a + b) // 2 for a, b in gaps])
        for (a, b), name in zip(gaps, names):
            r.gaps[name] += b - a
    return r


def top(d: dict, n: int = 10) -> list:
    """The n largest entries of {name: ns} as [[name, seconds], ...]."""
    rows = sorted(d.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], ns / 1e9] for name, ns in rows]
