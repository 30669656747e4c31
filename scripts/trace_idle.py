"""Device busy and idle share of a JAX profiler trace.

    python scripts/trace_idle.py TRACE_DIR

Reads the newest .xplane.pb under TRACE_DIR (written by
jax.profiler.start_trace, e.g. through CFDTPU_PROFILE=TRACE_DIR on
main.py simulate) and prints one JSON line per GPU: the window from its
first to its last kernel, its busy time (the union of the kernel
intervals on its stream lines) and its idle share, 1 - busy / window.
Each device plane's line names and event counts go to stderr, for
checking by hand which lines were counted.
"""

import glob
import json
import os
import sys


def union_ns(intervals) -> int:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_share(intervals) -> dict:
    iv = list(intervals)
    start = min(s for s, _ in iv)
    end = max(e for _, e in iv)
    busy = union_ns(iv)
    return {"window_ns": end - start, "busy_ns": busy,
            "idle_share": 1.0 - busy / (end - start), "events": len(iv)}


def device_shares(path: str) -> list[dict]:
    from jax.profiler import ProfileData

    out = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        intervals = []
        for line in plane.lines:
            events = [(e.start_ns, e.start_ns + e.duration_ns)
                      for e in line.events]
            print(f"{plane.name} | {line.name}: {len(events)} events",
                  file=sys.stderr)
            if line.name.startswith("Stream"):
                intervals += events
        if intervals:
            out.append({"device": plane.name, **idle_share(intervals)})
    return out


def main():
    files = glob.glob(os.path.join(sys.argv[1], "**", "*.xplane.pb"),
                      recursive=True)
    if not files:
        raise SystemExit(f"no .xplane.pb under {sys.argv[1]}")
    path = max(files, key=os.path.getmtime)
    shares = device_shares(path)
    if not shares:
        raise SystemExit(f"no GPU kernel events in {path}")
    for rec in shares:
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
