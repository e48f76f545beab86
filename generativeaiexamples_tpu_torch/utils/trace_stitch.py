"""Fleet-wide trace stitching: merge per-process flight-recorder
timelines that share one W3C trace id into a single end-to-end story.

Counterpart of generativeaiexamples_tpu/utils/trace_stitch.py, copied:
the port's servers use ``normalize_trace_id``, and the port's router
(router/app.py) ``merge_timelines`` as well.

Before this module the only place that joined a request's router hop
with its replica-side engine phases was the loadgen telemetry scraper —
client-side, per run, and only for the richest record per trace. This
extracts that logic so it is shared by:

- the servers' ``GET /internal/requests?trace=<id>`` filter (one
  process's records for a trace, full timelines);
- the router's ``GET /internal/trace/{trace_id}`` fan-out, which pulls
  its own hop record plus every replica's ``?trace=`` records and
  returns ONE merged, time-ordered timeline (``merge_timelines``);
- the loadgen's :class:`~tools.loadgen.telemetry.FleetScraper`, whose
  richest-record-wins collision rule is :func:`pick_richest`.

Merging across processes aligns events on wall clocks: each record
carries its ``started_at`` (``time.time()`` at open) and events carry
offsets relative to it, so an event's absolute time is
``started_at + t_s``. Processes on one host (the compose fleet, tests)
agree to well under a hop's duration; across hosts, NTP-grade skew can
reorder events that are closer together than the skew — the merged
document carries each source's ``started_at`` so an operator can see
the alignment basis.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "normalize_trace_id",
    "merge_timelines",
    "pick_richest",
]

_HEX = set("0123456789abcdef")


def normalize_trace_id(raw: Optional[str]) -> Optional[str]:
    """Canonical 32-hex-lowercase trace id, or None when ``raw`` is not
    a valid W3C trace id (wrong length, non-hex, or the all-zero id the
    spec forbids). Endpoints answer 400 on None rather than running a
    ring scan that can only miss."""
    if not raw:
        return None
    tid = raw.strip().lower()
    if len(tid) != 32 or not set(tid) <= _HEX or tid == "0" * 32:
        return None
    return tid


def _source_summary(label: str, tl: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "source": label,
        "request_id": tl.get("request_id"),
        "started_at": tl.get("started_at"),
        "events": len(tl.get("timeline") or []),
        "outcome": tl.get("outcome"),
        "ttft_s": tl.get("ttft_s"),
        "total_s": tl.get("total_s"),
        "done": tl.get("done"),
    }


def merge_timelines(
    sources: Sequence[Tuple[str, Dict[str, Any]]],
) -> Optional[Dict[str, Any]]:
    """ONE merged end-to-end timeline from ``(source_label, timeline)``
    pairs (full-timeline dicts as the flight recorder serves them).

    Events from every source interleave ordered by absolute wall time
    (``started_at + t_s``); each merged entry carries its ``source``
    label and a ``t_s`` re-based to the EARLIEST source's start, so the
    router hop's placement decision, the replica's queue/prefill/decode
    phases, and the router's first-byte forward read as one story.
    Returns None when no source has a timeline.
    """
    entries: List[Tuple[float, str, Dict[str, Any]]] = []
    trace_id = None
    bases: List[float] = []
    kept: List[Tuple[str, Dict[str, Any]]] = []
    for label, tl in sources:
        if not tl or not isinstance(tl, dict):
            continue
        trace_id = trace_id or tl.get("trace_id")
        base = float(tl.get("started_at") or 0.0)
        kept.append((label, tl))
        bases.append(base)
        for ev in tl.get("timeline") or []:
            entries.append((base + float(ev.get("t_s", 0.0)), label, ev))
    if not entries and not kept:
        return None
    t0 = min(bases) if bases else 0.0
    entries.sort(key=lambda e: e[0])
    return {
        "trace_id": trace_id,
        "sources": [_source_summary(label, tl) for label, tl in kept],
        "events": len(entries),
        "timeline": [
            {
                "t_s": round(t_abs - t0, 6),
                "source": label,
                **{k: v for k, v in ev.items() if k != "t_s"},
            }
            for t_abs, label, ev in entries
        ],
    }


def richness(tl: Dict[str, Any]) -> int:
    """How many events a timeline holds — the ``timeline`` list when
    present, else the summary's integer ``events`` count. (The fleet
    scraper's inlined predecessor called ``len()`` on the integer
    count, a latent TypeError on any real trace collision.)"""
    events = tl.get("timeline")
    if isinstance(events, list):
        return len(events)
    count = tl.get("events")
    return int(count) if isinstance(count, (int, float)) else 0


def pick_richest(
    candidates: Iterable[Dict[str, Any]],
) -> Optional[Dict[str, Any]]:
    """The trace-collision rule the fleet scraper applies when two
    replicas hold records for one trace id (failover/shed remnants vs
    the replica that actually served): the timeline with more events —
    the one that reached the engine — wins."""
    best: Optional[Dict[str, Any]] = None
    for tl in candidates:
        if best is None or richness(tl) > richness(best):
            best = tl
    return best
