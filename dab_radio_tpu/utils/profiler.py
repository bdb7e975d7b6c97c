"""Tracing profiler: per-thread stack-scoped microsecond spans.

Analog of the reference's header-only instrumentor
(src/ofdm/profiler.h): RAII-style scopes record {name, stack depth, start,
end} per thread, unique call-tree shapes are hashed and counted, and a
per-stage timing table is a first-class artifact (the reference renders it
in an ImGui tab; here it prints/serialises). Device-side stages additionally
wrap jax.profiler.TraceAnnotation so traces line up in XProf captures.
"""

import contextlib
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List

try:
    import jax
    _HAVE_JAX = True
except Exception:                                  # pragma: no cover
    _HAVE_JAX = False


@dataclass
class Span:
    name: str
    depth: int
    start_us: float
    end_us: float = 0.0


@dataclass
class _ThreadState:
    spans: List[Span] = field(default_factory=list)
    stack: List[Span] = field(default_factory=list)
    label: str = ""


class Profiler:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._threads: Dict[int, _ThreadState] = {}
        self._lock = threading.Lock()
        self._trace_counts: Dict[int, int] = defaultdict(int)

    def _state(self) -> _ThreadState:
        tid = threading.get_ident()
        st = self._threads.get(tid)
        if st is None:
            with self._lock:
                st = self._threads.setdefault(tid, _ThreadState())
        return st

    def tag_thread(self, label: str):
        self._state().label = label

    @contextlib.contextmanager
    def scope(self, name: str):
        if not self.enabled:
            yield
            return
        st = self._state()
        span = Span(name, len(st.stack), time.perf_counter() * 1e6)
        st.stack.append(span)
        if _HAVE_JAX:
            ctx = jax.profiler.TraceAnnotation(name)
            ctx.__enter__()
        try:
            yield
        finally:
            if _HAVE_JAX:
                ctx.__exit__(None, None, None)
            span.end_us = time.perf_counter() * 1e6
            st.stack.pop()
            st.spans.append(span)
            if not st.stack:
                # completed top-level trace: hash its shape and count it
                shape = hash(tuple((s.name, s.depth) for s in st.spans))
                self._trace_counts[shape] += 1
                if len(st.spans) > 100000:
                    st.spans = st.spans[-10000:]

    # ---- reporting ----

    def table(self) -> Dict[str, Dict[str, float]]:
        """Aggregate per-stage stats: {name: {count, total_us, mean_us, max_us}}."""
        agg: Dict[str, Dict[str, float]] = {}
        with self._lock:
            threads = list(self._threads.values())
        for st in threads:
            for s in st.spans:
                d = agg.setdefault(s.name, {"count": 0, "total_us": 0.0,
                                            "max_us": 0.0})
                dur = s.end_us - s.start_us
                d["count"] += 1
                d["total_us"] += dur
                d["max_us"] = max(d["max_us"], dur)
        for d in agg.values():
            d["mean_us"] = d["total_us"] / max(d["count"], 1)
        return agg

    def report(self) -> str:
        rows = sorted(self.table().items(), key=lambda kv: -kv[1]["total_us"])
        lines = [f"{'stage':40s} {'count':>8s} {'total ms':>10s} "
                 f"{'mean us':>10s} {'max us':>10s}"]
        for name, d in rows:
            lines.append(f"{name:40s} {int(d['count']):8d} "
                         f"{d['total_us'] / 1e3:10.2f} {d['mean_us']:10.1f} "
                         f"{d['max_us']:10.1f}")
        lines.append(f"unique trace shapes: {len(self._trace_counts)}")
        return "\n".join(lines)

    def dump_chrome_trace(self, path: str):
        """Write every recorded span as a Chrome trace (chrome://tracing /
        Perfetto) — the open-format analog of the reference GUI's trace
        viewer tab (examples/gui/ofdm/render_profiler.cpp:16-70)."""
        import json
        events = []
        with self._lock:
            threads = list(self._threads.items())
        for tid, st in threads:
            if st.label:
                events.append({"ph": "M", "pid": 1, "tid": tid,
                               "name": "thread_name",
                               "args": {"name": st.label}})
            for s in st.spans:
                events.append({"ph": "X", "pid": 1, "tid": tid,
                               "name": s.name, "ts": s.start_us,
                               "dur": max(s.end_us - s.start_us, 0.0)})
        with open(path, "w") as f:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms"}, f)

    def reset(self):
        with self._lock:
            self._threads.clear()
            self._trace_counts.clear()


_GLOBAL = Profiler(enabled=False)


def get_profiler() -> Profiler:
    return _GLOBAL


def profile_scope(name: str):
    return _GLOBAL.scope(name)
