"""Chrome trace-event export of the flight recorder's spans — the part of
``kubeflow_tpu/tracing/export.py`` that ``core.flush`` writes with.

Operates on span dicts (core.Span.to_dict):

  {"name", "trace", "span", "parent", "ts" (s), "dur" (s), "pid", "tid",
   "attrs": {...}}
"""

from __future__ import annotations

import json


def to_chrome_trace(spans: list[dict], service: str = "kftpu") -> dict:
    """Chrome trace-event JSON object: one complete ("X") event per span,
    ts/dur in microseconds of wall-clock, args carrying the span identity
    (trace/span/parent ids) plus every attribute."""
    events = []
    pids = {}
    for s in spans:
        pid = s.get("pid", 0)
        if pid not in pids:
            pids[pid] = True
            events.append({
                "ph": "M", "name": "process_name", "pid": pid,
                "args": {"name": f"{service}-{pid}" if pid else service},
            })
        events.append({
            "name": s["name"],
            "cat": "kftpu",
            "ph": "X",
            "ts": round(s["ts"] * 1e6, 3),
            # Perfetto drops 0-width slices; events get a 1us sliver
            "dur": max(round(s["dur"] * 1e6, 3), 1.0),
            "pid": pid,
            "tid": s.get("tid", 0),
            "args": {
                "trace_id": s["trace"],
                "span_id": s["span"],
                "parent_id": s.get("parent", ""),
                **s.get("attrs", {}),
            },
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, spans: list[dict],
                       service: str = "kftpu") -> str:
    with open(path, "w") as fh:
        json.dump(to_chrome_trace(spans, service=service), fh)
    return path
