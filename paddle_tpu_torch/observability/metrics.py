"""Metrics registry: the port's counters behind one scrapeable wire.

Counterpart of ``paddle_tpu/observability/metrics.py``:

- ``Counter`` / ``Gauge`` / ``Histogram``: push-style instruments (labels
  supported, lock-guarded);
- pull collectors: existing counters register as callbacks sampled at
  scrape time (``register_collector``). The built-in collectors cover the
  serving engines, the gateways and the step-capture tier WITHOUT
  importing them: a subsystem absent from ``sys.modules`` contributes
  nothing, so a scrape never pulls a subsystem in. The comms and
  supervisor collectors find no module of the port to read yet and return
  nothing;
- ``metrics_snapshot()``: every sample as one dict; ``render_prometheus()``:
  the text exposition format, rendered deterministically (sorted names and
  labels), so a wire scrape compares byte for byte with an in-process
  render taken at the same quiet moment.

Naming: ``pt_<subsystem>_<what>`` with labels for the instance dimension
(``engine="0"``).
"""
from __future__ import annotations

import sys
import threading
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "register_collector",
           "unregister_collector", "metrics_snapshot", "render_prometheus",
           "metrics_clear"]


def _label_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    """Base: name, help text, per-labelset values under one lock."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):  # noqa: A002 — prom idiom
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._values: Dict[tuple, float] = {}
        existing = _REGISTRY.register(self)
        if existing is not self:
            # same name re-created (a subsystem constructing at import and
            # at reload): this instance becomes a facade over the
            # registered instrument's storage, so updates through either
            # handle land in the one scraped series
            self._lock = existing._lock
            self._values = existing._values
            if hasattr(existing, "buckets"):
                self.buckets = existing.buckets  # first registration wins

    def samples(self) -> List[tuple]:
        """-> [(name, labels_tuple, value)] for the render."""
        with self._lock:
            return [(self.name, k, v) for k, v in sorted(self._values.items())]

    def _set(self, labels: dict, value: float) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def _add(self, labels: dict, delta: float) -> None:
        k = _label_key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + float(delta)


class Counter(_Metric):
    """Monotone count: ``c.inc()``, ``c.inc(5, engine="0")``."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        self._add(labels, value)


class Gauge(_Metric):
    """Point-in-time value: ``g.set(0.93, engine="0")``."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._set(labels, value)

    def inc(self, value: float = 1.0, **labels) -> None:
        self._add(labels, value)

    def dec(self, value: float = 1.0, **labels) -> None:
        self._add(labels, -value)


class Histogram(_Metric):
    """Cumulative-bucket histogram (the Prometheus layout): ``observe(v)``
    counts v into every bucket with ``le >= v`` plus ``_sum``/``_count``."""

    kind = "histogram"
    DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0)

    def __init__(self, name: str, help: str = "",  # noqa: A002
                 buckets: Optional[Tuple[float, ...]] = None):
        self.buckets = tuple(sorted(buckets or self.DEFAULT_BUCKETS))
        super().__init__(name, help)

    def observe(self, value: float, **labels) -> None:
        k = _label_key(labels)
        v = float(value)
        with self._lock:
            st = self._values.setdefault(
                k, {"buckets": [0] * len(self.buckets),   # type: ignore[arg-type]
                    "sum": 0.0, "count": 0})
            for i, le in enumerate(self.buckets):
                if v <= le:
                    st["buckets"][i] += 1
            st["sum"] += v
            st["count"] += 1

    def samples(self) -> List[tuple]:
        out = []
        with self._lock:
            for k, st in sorted(self._values.items()):
                for le, n in zip(self.buckets, st["buckets"]):
                    out.append((f"{self.name}_bucket",
                                k + (("le", f"{le:g}"),), n))
                out.append((f"{self.name}_bucket", k + (("le", "+Inf"),),
                            st["count"]))
                out.append((f"{self.name}_sum", k, st["sum"]))
                out.append((f"{self.name}_count", k, st["count"]))
        return out


class _Registry:
    """Named metrics + pull collectors, lock-guarded (the audited-container
    idiom). Re-creating a metric with the same name returns the existing
    instrument — subsystems construct at import and at reload."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self._collectors: Dict[str, Callable[[], list]] = {}

    def register(self, metric: _Metric) -> "_Metric":
        """Register (or resolve) one instrument; returns the canonical
        instance for the name — the caller adopts its storage when an
        instrument with this name already exists."""
        with self._lock:
            cur = self._metrics.get(metric.name)
            if cur is None:
                self._metrics[metric.name] = metric
                return metric
            if type(cur) is not type(metric):
                raise ValueError(
                    f"metric {metric.name!r} already registered as "
                    f"{cur.kind}")
            return cur

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def register_collector(self, name: str, fn: Callable[[], list]) -> None:
        with self._lock:
            self._collectors[name] = fn

    def unregister_collector(self, name: str) -> None:
        with self._lock:
            self._collectors.pop(name, None)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return sorted(self._metrics.values(), key=lambda m: m.name)

    def collectors(self) -> List[Tuple[str, Callable[[], list]]]:
        with self._lock:
            return sorted(self._collectors.items())

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()
            self._collectors.clear()


_REGISTRY = _Registry()


def register_collector(name: str, fn: Callable[[], list]) -> None:
    """Register a pull collector: ``fn()`` -> iterable of
    ``(metric_name, kind, help, labels_dict, value)`` sampled at every
    scrape. The route for existing ad-hoc counter dicts — no double
    bookkeeping on the hot path, the scrape reads what info() reads."""
    _REGISTRY.register_collector(name, fn)


def unregister_collector(name: str) -> None:
    _REGISTRY.unregister_collector(name)


def metrics_clear() -> None:
    """Drop every metric and collector (tests)."""
    _REGISTRY.clear()


# ---------------------------------------------------------------------------
# built-in collectors over the live subsystems (never force an import)
# ---------------------------------------------------------------------------

def loaded_module(name: str):
    """The subsystem module if already imported: a scrape must never be
    the thing that pulls a subsystem in."""
    return sys.modules.get(name)


_mod = loaded_module


def _num(x) -> Optional[float]:
    try:
        return float(x)
    except (TypeError, ValueError):
        return None


def _flat_counters(prefix: str, kind: str, info: dict, labels: dict,
                   help_of: str, gauges: frozenset = frozenset()) -> list:
    """Numeric info() fields as samples; names in ``gauges`` override the
    default kind (counter semantics require monotonicity — a ratio or a
    config knob exported as a counter turns rate() into garbage)."""
    out = []
    for k, v in info.items():
        val = _num(v)
        if val is None or isinstance(v, bool):
            continue
        out.append((f"{prefix}_{k}", "gauge" if k in gauges else kind,
                    f"{help_of}: {k}", labels, val))
    return out


# serving/gateway info() fields that can move BOTH ways (ratios, live
# occupancy, queue depths) or are static config — gauges, not counters
_SERVING_GAUGES = frozenset({
    "avg_occupancy", "tokens_per_sec", "active", "queued", "max_batch",
    "max_seq_len", "prefill_chunk"})
_GATEWAY_GAUGES = frozenset({"open_connections", "read_timeout", "port"})
# the overload degradation ladder: level / pause flags / config move both
# ways (gauges); shed + trim counts only grow (counters)
_PRESSURE_GAUGES = frozenset({
    "level", "max_queue", "spec_paused", "prefix_paused"})
# the capture tier's live graph count and pool size move both ways
_CAPTURE_GAUGES = frozenset({"graphs", "pool_mib"})


def _collect_serving() -> list:
    serving = _mod("paddle_tpu_torch.inference.serving")
    if serving is None:
        return []
    out = []
    for i, e in enumerate(serving.serving_info()):
        labels = {"engine": str(i)}
        skip = {"pool", "step", "prefix", "window", "spec",
                "prefill_buckets", "pressure"}
        out += _flat_counters(
            "pt_serving", "counter",
            {k: v for k, v in e.items() if k not in skip},
            labels, "serving engine funnel", gauges=_SERVING_GAUGES)
        out += _flat_counters("pt_serving_pool", "gauge", e["pool"], labels,
                              "KV page pool")
        out += _flat_counters(
            "pt_serving_pressure", "counter", e.get("pressure", {}),
            labels, "overload degradation ladder",
            gauges=_PRESSURE_GAUGES)
        if e.get("step"):
            out += _flat_counters("pt_serving_step", "counter", e["step"],
                                  labels, "decode step-capture cache")
    return out


def _collect_gateway() -> list:
    gw = _mod("paddle_tpu_torch.inference.serving.gateway")
    if gw is None:
        return []
    out = []
    for i, g in enumerate(gw.gateway_info()):
        labels = {"gateway": str(i), "port": str(g["port"])}
        skip = {"status_counts", "host"}
        out += _flat_counters(
            "pt_gateway", "counter",
            {k: v for k, v in g.items() if k not in skip},
            labels, "gateway wire funnel", gauges=_GATEWAY_GAUGES)
        for code, n in sorted(g["status_counts"].items()):
            out.append(("pt_gateway_status_total", "counter",
                        "responses by PTSG status code",
                        {**labels, "status": str(code)}, float(n)))
    return out


def _collect_comms() -> list:
    comms = _mod("paddle_tpu_torch.distributed.comms")
    if comms is None:
        return []
    info = comms.comm_info()
    out = [("pt_comm_collectives_total", "counter",
            "collectives recorded", {}, float(info["collectives"])),
           ("pt_comm_bytes_logical_total", "counter",
            "logical collective bytes", {}, float(info["total_logical"])),
           ("pt_comm_bytes_wire_total", "counter",
            "wire collective bytes", {}, float(info["total_wire"]))]
    for site, s in info["sites"].items():
        labels = {"site": site}
        out.append(("pt_comm_site_collectives_total", "counter",
                    "collectives at site", labels, float(s["count"])))
        out.append(("pt_comm_site_bytes_wire_total", "counter",
                    "wire bytes at site", labels, float(s["bytes_wire"])))
    return out


def _collect_supervisor() -> list:
    sup = _mod("paddle_tpu_torch.distributed.supervisor")
    if sup is None:
        return []
    events = sup.supervisor_events()
    out = [("pt_supervisor_scale_events_total", "counter",
            "supervised scale events", {}, float(len(events)))]
    if events:
        last = events[-1]
        out.append(("pt_supervisor_epoch", "gauge",
                    "latest supervision epoch", {}, float(last["epoch"])))
        out.append(("pt_supervisor_last_downtime_seconds", "gauge",
                    "downtime of the latest scale event", {},
                    float(last["downtime_s"])))
    return out


def _collect_caches() -> list:
    capture = _mod("paddle_tpu_torch.jit.capture")
    if capture is None:
        return []
    info = capture.capture_info()
    return _flat_counters(
        "pt_step_capture", "counter",
        {k: v for k, v in info.items() if k != "last_bailout"}, {},
        "whole-step capture tier", gauges=_CAPTURE_GAUGES)


def _collect_trace() -> list:
    from . import trace
    info = trace.trace_info()
    return [("pt_trace_records", "gauge", "trace ring occupancy", {},
             float(info["records"])),
            ("pt_trace_dropped_total", "counter",
             "records dropped from the full ring", {},
             float(info["dropped"])),
            ("pt_trace_incidents_total", "counter",
             "flight-recorder incidents captured", {},
             float(info["incidents"]))]


_BUILTIN = (("serving", _collect_serving), ("gateway", _collect_gateway),
            ("comms", _collect_comms), ("supervisor", _collect_supervisor),
            ("caches", _collect_caches), ("trace", _collect_trace))


# ---------------------------------------------------------------------------
# snapshot + render
# ---------------------------------------------------------------------------

def _all_samples() -> List[tuple]:
    """-> [(name, kind, help, labels_tuple, value)], deterministic order."""
    rows: List[tuple] = []
    for m in _REGISTRY.metrics():
        for name, labels, value in m.samples():
            rows.append((name, m.kind, m.help, labels, value))
    for _cname, fn in list(_BUILTIN) + _REGISTRY.collectors():
        try:
            samples = fn()
        except Exception:  # noqa: BLE001 — one broken collector must not
            continue       # take down the whole scrape
        for name, kind, help_, labels, value in samples:
            rows.append((name, kind, help_, _label_key(labels), value))
    rows.sort(key=lambda r: (r[0], _label_sort_key(r[3])))
    return rows


def _label_sort_key(labels: tuple) -> tuple:
    """Deterministic label ordering that keeps histogram buckets NUMERIC:
    a lexicographic sort would emit le="+Inf" before le="0.001" ('+' <
    '0') and le="10" before le="5" — exposition-format bucket order is
    ascending with +Inf last, which OpenMetrics parsers require."""
    out = []
    for k, v in labels:
        if k == "le":
            try:
                out.append((k, float("inf") if v == "+Inf" else float(v),
                            ""))
                continue
            except ValueError:
                pass
        out.append((k, float("-inf"), v))
    return tuple(out)


def metrics_snapshot() -> Dict[str, dict]:
    """Every sample as ``{metric: {"kind", "help", "values": {labels: v}}}``
    — the programmatic twin of the Prometheus render (same sample set,
    same instant semantics)."""
    out: Dict[str, dict] = {}
    for name, kind, help_, labels, value in _all_samples():
        m = out.setdefault(name, {"kind": kind, "help": help_, "values": {}})
        m["values"][",".join(f"{k}={v}" for k, v in labels)] = value
    return out


def _fmt_value(v: float) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def render_prometheus() -> str:
    """The text exposition format. Deterministic: sorted metric names,
    sorted label sets, integers rendered without a trailing ``.0`` — so
    two renders over unchanged counters are byte-identical (the wire
    round-trip test's contract)."""
    lines: List[str] = []
    last_name = None
    for name, kind, help_, labels, value in _all_samples():
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix):
                base = name[:-len(suffix)]
        if base != last_name:
            if help_:
                lines.append(f"# HELP {base} {help_}")
            lines.append(f"# TYPE {base} {kind}")
            last_name = base
        label_s = ",".join(f'{k}="{v}"' for k, v in labels)
        lines.append(f"{name}{{{label_s}}} {_fmt_value(value)}"
                     if label_s else f"{name} {_fmt_value(value)}")
    return "\n".join(lines) + "\n"
