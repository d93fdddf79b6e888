"""Overlap coverage (counterpart: ``fabric_tpu/observe/overlap.py``): is
``device_wait`` hidden by the neighbours' host work?

The depth-N commit pipeline rests on block k's device time being
covered by host work of its neighbours: prefetch(k+1) parsing,
commit(k-1) writing the ledger, launch(k+1) staging.  From finished
span trees (``observe/tracer.py``):

    coverage(k) = |device_wait(k) ∩ ⋃ host-spans(j), 0 < |j-k| <= w|
                  ─────────────────────────────────────────────────
                                |device_wait(k)|

A span counts as host work unless it is a pure wait or a container
that holds device time (``NON_HOST``): commit(k-1) on the committer
thread and host_parse(k+1) on the prefetch thread count, commit_wait,
prefetch_wait and finish (which nests the device sync) do not.
Intervals are unioned, so nested spans never count twice.

Three input forms, one per export of the tracer: live ``Span`` roots
(``Tracer.recent_roots()``, absolute ``perf_counter`` seconds), the JSON
trees of ``Tracer.blocks()`` (per-block ``start_ms`` anchored by
``t0_s``), and Chrome trace events (``Tracer.chrome_events()``,
microseconds, the block number in ``args``).
"""

from __future__ import annotations

#: span names that are NOT host work: the root container, pure
#: blocking waits, the device sync itself, and the finish container
#: (it nests device_wait).  Everything else — prefetch, launch,
#: commit, ledger_commit, fsync, the validator's stage spans, pool
#: worker tasks, verify_chunk staging — counts toward coverage.
NON_HOST = {
    "block", "finish", "device_wait", "commit_wait", "prefetch_wait",
    "queue_wait",
}

#: default neighbor window (blocks either side): ±2 matches depth-3
#: pipelining (k−2 fsyncing, k−1 committing, k+1 prefetching, k+2
#: staged); pass ``window=depth−1`` to match a configured depth.
DEFAULT_WINDOW = 2


def spans_from_root(root):
    """One finished Span tree → ``(block, name, t0, t1)`` rows in
    absolute seconds (the live-tracer input form)."""
    block = root.attrs.get("block")
    out = []

    def walk(sp):
        if sp.t1 is not None:
            out.append((block, sp.name, sp.t0, sp.t1))
        for c in sp.children:
            walk(c)

    walk(root)
    return out


def spans_from_tree_dict(d: dict):
    """One ``/trace`` block tree (``Tracer.blocks()`` output) →
    ``(block, name, t0, t1)`` rows, or None when the dump predates the
    ``t0_s`` anchor (per-block-relative times cannot be compared
    across blocks without it)."""
    base = d.get("t0_s")
    if base is None:
        return None
    block = d.get("block")
    out = []

    def walk(sp):
        t0 = base + float(sp.get("start_ms", 0.0)) / 1000.0
        out.append((block, sp.get("name", "?"), t0,
                    t0 + float(sp.get("dur_ms", 0.0)) / 1000.0))
        for c in sp.get("children", ()):
            walk(c)

    walk(d)
    return out


def spans_from_chrome(events) -> list:
    """Chrome trace-event list → ``(block, name, t0, t1)`` rows
    (absolute seconds; only complete "X" events carry duration)."""
    out = []
    for e in events:
        if e.get("ph") != "X":
            continue
        block = (e.get("args") or {}).get("block")
        t0 = float(e.get("ts", 0.0)) / 1e6
        out.append((block, e.get("name", "?"), t0,
                    t0 + float(e.get("dur", 0.0)) / 1e6))
    return out


def _union(ivals: list) -> list:
    """Sorted disjoint union of [t0, t1) intervals."""
    ivals = sorted(i for i in ivals if i[1] > i[0])
    out: list = []
    for t0, t1 in ivals:
        if out and t0 <= out[-1][1]:
            if t1 > out[-1][1]:
                out[-1] = (out[-1][0], t1)
        else:
            out.append((t0, t1))
    return out


def _overlap_len(a: list, b: list) -> float:
    """Total length of the intersection of two DISJOINT-sorted
    interval lists (linear sweep)."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def coverage_from_spans(rows, window: int = DEFAULT_WINDOW) -> dict:
    """``(block, name, t0, t1)`` rows → the coverage report.

    Returns ``{"window", "blocks_measured", "mean", "p50", "min",
    "per_block": [{"block", "device_wait_ms", "covered_ms",
    "coverage"}, ...]}`` — ``blocks_measured`` counts blocks that have
    any ``device_wait`` at all AND at least one in-window neighbor on
    either side (edge blocks of a short trace have nothing to hide
    behind and would read as spurious misses)."""
    dev: dict = {}    # block → [intervals]
    host: dict = {}   # block → [intervals]
    for block, name, t0, t1 in rows:
        if block is None or t1 <= t0:
            continue
        if name == "device_wait":
            dev.setdefault(block, []).append((t0, t1))
        elif name not in NON_HOST:
            host.setdefault(block, []).append((t0, t1))
    known = sorted(set(dev) | set(host))
    per_block = []
    for k in sorted(dev):
        neighbors = [j for j in known
                     if j != k and abs(j - k) <= window]
        if not neighbors:
            continue  # nothing in the window to hide behind
        dk = _union(dev[k])
        cover = _union([iv for j in neighbors
                        for iv in host.get(j, ())])
        total = sum(t1 - t0 for t0, t1 in dk)
        covered = _overlap_len(dk, cover)
        per_block.append({
            "block": k,
            "device_wait_ms": round(total * 1000.0, 3),
            "covered_ms": round(covered * 1000.0, 3),
            "coverage": round(covered / total, 4) if total > 0 else 1.0,
        })
    fracs = sorted(b["coverage"] for b in per_block)
    n = len(fracs)
    return {
        "window": int(window),
        "blocks_measured": n,
        "mean": round(sum(fracs) / n, 4) if n else None,
        "p50": fracs[n // 2] if n else None,
        "min": fracs[0] if n else None,
        "per_block": per_block,
    }


def coverage_from_roots(roots, window: int = DEFAULT_WINDOW) -> dict:
    """Live Span roots (``Tracer.recent_roots()``) → coverage report."""
    rows: list = []
    for r in roots:
        rows.extend(spans_from_root(r))
    return coverage_from_spans(rows, window=window)


def coverage_from_trace_dump(data, window: int = DEFAULT_WINDOW):
    """A ``/trace`` index payload (or list of block trees) → coverage
    report, or None when the dump carries no ``t0_s`` anchors."""
    if isinstance(data, dict):
        trees = {b.get("block"): b for b in data.get("recent_blocks", ())}
        for b in data.get("slow_blocks", ()):
            trees.setdefault(b.get("block"), b)
        trees = list(trees.values())
    else:
        trees = list(data)
    rows: list = []
    anchored = False
    for t in trees:
        got = spans_from_tree_dict(t)
        if got is not None:
            anchored = True
            rows.extend(got)
    if not anchored:
        return None
    return coverage_from_spans(rows, window=window)
