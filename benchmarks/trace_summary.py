"""Top device operations of ``jax.profiler`` traces.

Usage: ``python benchmarks/trace_summary.py TRACE_DIR [TOP]``

Reads every ``.xplane.pb`` under ``TRACE_DIR`` (e.g. one per config of
``benchmarks/suite.py --trace``). For each GPU device plane it prints the
window (first kernel start to last kernel end), the busy time (union of the
kernel intervals on the plane's stream lines), the idle share, and the TOP
kernels by summed device time with their share of the busy time.
"""

import collections
import glob
import os
import sys


def _merge(intervals):
    """Total length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
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


def summarize(path, top=12):
    """Per device plane: ``(plane, window_ns, busy_ns, [(name, ns, n)],
    line_names)``."""
    from jax.profiler import ProfileData

    out = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        per_name = collections.defaultdict(lambda: [0.0, 0])
        intervals = []
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                per_name[ev.name][0] += ev.duration_ns
                per_name[ev.name][1] += 1
                intervals.append((ev.start_ns, ev.end_ns))
        if not intervals:
            continue
        window = max(e for _, e in intervals) - min(s for s, _ in intervals)
        ranked = sorted(((n, t, c) for n, (t, c) in per_name.items()),
                        key=lambda r: -r[1])[:top]
        out.append((plane.name, window, _merge(intervals), ranked,
                    sorted({line.name for line in plane.lines})))
    return out


def main():
    root = sys.argv[1]
    top = int(sys.argv[2]) if len(sys.argv) > 2 else 12
    for path in sorted(glob.glob(os.path.join(root, "**", "*.xplane.pb"),
                                 recursive=True)):
        print("== %s" % os.path.relpath(path, root))
        for plane, window, busy, ranked, lines in summarize(path, top):
            print("%s window %.3f ms busy %.3f ms idle %.1f %% (lines: %s)"
                  % (plane, window / 1e6, busy / 1e6,
                     100.0 * (1 - busy / window) if window else 0.0,
                     ", ".join(lines)))
            for name, t, count in ranked:
                print("  %8.3f ms %5.1f %% x%-6d %s"
                      % (t / 1e6, 100.0 * t / busy, count, name[:110]))


if __name__ == "__main__":
    main()
