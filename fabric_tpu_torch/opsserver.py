"""Operations HTTP server: /metrics, /healthz, /logspec, /version,
/trace, /slo, /autopilot, /vitals, /launches, /txflow, /debug
(counterpart: ``fabric_tpu/opsserver.py``).

Every peer and orderer process runs one (the reference's
core/operations/system.go).  Health checkers register by name and are
polled on /healthz; /logspec GET/PUT reads and sets logging levels
(FABRIC_LOGGING_SPEC syntax, the root being ``fabric_tpu_torch``).
/metrics renders the port's ``ops_metrics`` registry; /trace, /launches
and /txflow read the port's tracer, launch ledger and flow journal
(``observe/``); /slo the SLO engine's report (``observe/slo.py``, the
global engine unless ``slo=`` is given); /autopilot the traffic
autopilot's (``control/autopilot.py``); /vitals the metrics sampler's
summaries and the black box's incident index
(``observe/{timeseries,blackbox}.py``), ``?metric=`` one metric's
series, ``?incident=`` one bundle.  ``autopilot``, ``vitals`` and
``blackbox`` given as None resolve the process-global ones per request,
and unarmed the routes answer as the reference's: no objectives,
``{"enabled": false, "configured": false}``, an unarmed recorder with
no incidents.
"""

from __future__ import annotations

import asyncio
import json
import logging

from fabric_tpu_torch.ops_metrics import Registry, global_registry

VERSION = "fabric-tpu 0.3.0"


class HealthRegistry:
    def __init__(self):
        self._checkers: dict[str, object] = {}

    def register(self, name: str, checker) -> None:
        """checker: zero-arg callable → None/True if healthy, raises or
        returns a failure reason string otherwise."""
        self._checkers[name] = checker

    def check(self) -> tuple[bool, dict]:
        failures = {}
        for name, fn in self._checkers.items():
            try:
                res = fn()
                if res not in (None, True):
                    failures[name] = str(res)
            except Exception as e:
                failures[name] = f"{type(e).__name__}: {e}"
        return (not failures), failures


class OperationsServer:
    """Minimal asyncio HTTP/1.1 server (stdlib-only on purpose: the
    control plane must not drag in web frameworks)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 registry: Registry | None = None,
                 health: HealthRegistry | None = None,
                 tracer=None, slo=None, autopilot=None, vitals=None, blackbox=None,
                 launches=None, txflow=None):
        self.host, self.port = host, port
        self.registry = registry or global_registry()
        self.health = health or HealthRegistry()
        if tracer is None:
            from fabric_tpu_torch.observe import global_tracer

            tracer = global_tracer()
        self.tracer = tracer  # /trace: the block-commit flight recorder
        if slo is None:
            from fabric_tpu_torch.observe.slo import global_engine

            slo = global_engine()
        self.slo = slo  # /slo: the burn-rate engine
        # /autopilot and /vitals: None = the process-global controller,
        # sampler and black box, resolved per request
        self.autopilot = autopilot
        self.vitals = vitals
        self.blackbox = blackbox
        # /launches and /txflow: None = the process-global launch ledger
        # / flow journal, resolved per request
        self.launches = launches
        self.txflow = txflow
        self._server: asyncio.AbstractServer | None = None

    async def start(self):
        self._server = await asyncio.start_server(
            self._on_conn, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop(self):
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def _on_conn(self, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter):
        try:
            req = await reader.readline()
            parts = req.decode("latin1").split()
            if len(parts) < 2:
                return
            method, path = parts[0], parts[1]
            headers = {}
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                k, _, v = line.decode("latin1").partition(":")
                headers[k.strip().lower()] = v.strip()
            body = b""
            n = int(headers.get("content-length", "0") or "0")
            if n:
                body = await reader.readexactly(n)
            routed = self._route(method, path, body)
            if callable(routed):  # async route (live profiling window)
                try:
                    text = await routed()
                    status, ctype, payload = 200, "text/plain", text.encode()
                except Exception as e:
                    status, ctype, payload = (
                        500, "application/json",
                        json.dumps({"error": str(e)}).encode(),
                    )
            else:
                status, ctype, payload = routed
            writer.write(
                b"HTTP/1.1 %d %s\r\nContent-Type: %s\r\n"
                b"Content-Length: %d\r\nConnection: close\r\n\r\n"
                % (status, b"OK" if status == 200 else b"ERR",
                   ctype.encode(), len(payload))
            )
            writer.write(payload)
            await writer.drain()
        except (ConnectionError, OSError, RuntimeError):
            pass  # client disconnected mid-response
        finally:
            writer.close()

    def _route(self, method: str, path: str, body: bytes):
        if path == "/metrics":
            return 200, "text/plain; version=0.0.4", self.registry.render().encode()
        if path == "/healthz":
            ok, failures = self.health.check()
            payload = json.dumps(
                {"status": "OK" if ok else "Service Unavailable",
                 "failed_checks": [
                     {"component": k, "reason": v} for k, v in failures.items()
                 ]}
            ).encode()
            return (200 if ok else 503), "application/json", payload
        if path == "/version":
            return 200, "application/json", json.dumps(
                {"Version": VERSION}
            ).encode()
        if path == "/logspec":
            if method == "GET":
                root = logging.getLogger("fabric_tpu_torch")
                return 200, "application/json", json.dumps(
                    {"spec": logging.getLevelName(
                        root.level or logging.WARNING)}
                ).encode()
            if method == "PUT":
                try:
                    spec = json.loads(body)["spec"]
                    apply_logspec(spec)
                    return 204, "application/json", b""
                except Exception as e:
                    return 400, "application/json", json.dumps(
                        {"error": str(e)}
                    ).encode()
        if path == "/trace" or path.startswith("/trace?"):
            return self._route_trace(path)
        if path == "/slo" or path.startswith("/slo?"):
            return 200, "application/json", json.dumps(self.slo.report()).encode()
        if path == "/autopilot" or path.startswith("/autopilot?"):
            ap = self.autopilot
            if ap is None:
                from fabric_tpu_torch.control import global_autopilot

                ap = global_autopilot()
            if ap is None:
                return 200, "application/json", json.dumps(
                    {"enabled": False, "configured": False}
                ).encode()
            return 200, "application/json", json.dumps(
                {"configured": True, **ap.report()}
            ).encode()
        if path == "/vitals" or path.startswith("/vitals?"):
            return self._route_vitals(path)
        if path == "/launches" or path.startswith("/launches?"):
            return self._route_launches(path)
        if path == "/txflow" or path.startswith("/txflow?"):
            return self._route_txflow(path)
        if path.startswith("/debug/"):
            return self._route_debug(path)
        return 404, "application/json", b'{"error": "not found"}'

    #: histograms the /trace summary reads (through the locked
    #: snapshot accessors) next to the span trees
    TRACE_SUMMARY_METRICS = (
        "commit_pipeline_stage_seconds",
        "commit_pipeline_overlap_ratio",
        "validator_stage_seconds",
        "host_stage_pool_seconds",
        "sidecar_request_seconds",
        "sidecar_queue_age_seconds",
    )

    def _route_trace(self, path: str):
        """Flight-recorder surface (fabric_tpu_torch.observe): ``/trace``
        serves recent slow blocks (plus the most recent trees and an
        aggregate-stage summary); ``/trace?block=N`` serves one block's
        full span tree.  ``ns=`` selects a non-default ring — a
        colocated sidecar's request trees live under ``ns=sidecar``
        (``/trace?ns=sidecar&block=7`` is request 7), so they never
        shadow peer block numbers."""
        from urllib.parse import parse_qs, urlparse

        q = parse_qs(urlparse(path).query)
        ns = q.get("ns", [""])[0]
        if "block" in q:
            try:
                num = int(q["block"][0])
            except ValueError:
                return 400, "application/json", b'{"error": "bad block"}'
            tree = self.tracer.block(num, ns=ns)
            if tree is None:
                return 404, "application/json", json.dumps(
                    {"error": f"block {num} not in the flight recorder"
                              + (f" (ns={ns})" if ns else "")}
                ).encode()
            return 200, "application/json", json.dumps(tree).encode()

        summary = {}
        for name in self.TRACE_SUMMARY_METRICS:
            m = self.registry.metric(name)
            if m is None or not hasattr(m, "snapshot"):
                continue
            summary[name] = {
                ",".join(f"{k}={v}" for k, v in key) or "_": {
                    "count": s["count"],
                    "sum_s": round(s["sum"], 6),
                }
                for key, s in sorted(m.snapshot().items())
            }
        ring = self.tracer.blocks(ns=ns)
        # pipeline overlap coverage over the whole ring: what fraction
        # of each block's device_wait the k±window neighbors' host
        # stages actually hid (observe/overlap.py; the deep-pipelining
        # acceptance number).  ?overlap_window=N matches depth N+1.
        from fabric_tpu_torch.observe import overlap as _overlap

        try:
            window = int(q.get("overlap_window", ["2"])[0])
        except ValueError:
            window = 2
        cov = _overlap.coverage_from_roots(
            self.tracer.recent_roots(ns=ns), window=window
        )
        cov.pop("per_block", None)  # the index stays an index
        payload = {
            "enabled": self.tracer.enabled,
            "ring_blocks": self.tracer.ring_blocks,
            "slow_factor": self.tracer.slow_factor,
            "slow_blocks": self.tracer.slow_blocks(),
            "recent_blocks": ring[-4:],
            "blocks_in_ring": [b.get("block") for b in ring],
            "namespaces": self.tracer.namespaces(),
            "pipeline_overlap_coverage": cov,
            "summary": summary,
        }
        if ns:
            payload["ns"] = ns
        return 200, "application/json", json.dumps(payload).encode()

    def _route_vitals(self, path: str):
        """The flight-data recorder's surface: ``/vitals`` serves the
        sampler's summaries beside the black box's incident index;
        ``?metric=NAME`` (and ``&label=k=v``) one metric's trailing
        series with its trace exemplars; ``?incident=K`` one bundle in
        full.  Unarmed it answers enabled false, no incidents."""
        from urllib.parse import parse_qs, urlparse

        sampler = self.vitals
        if sampler is None:
            from fabric_tpu_torch.observe import timeseries

            sampler = timeseries.global_sampler()
        bb = self.blackbox
        if bb is None:
            from fabric_tpu_torch.observe import blackbox as _blackbox

            bb = _blackbox.global_blackbox()
        q = parse_qs(urlparse(path).query)
        if "incident" in q:
            try:
                seq = int(q["incident"][0])
            except ValueError:
                return 400, "application/json", b'{"error": "bad incident"}'
            bundle = bb.bundle(seq) if bb is not None else None
            if bundle is None:
                return 404, "application/json", json.dumps(
                    {"error": f"incident {seq} not in the black box"}
                ).encode()
            return 200, "application/json", json.dumps(bundle).encode()
        if "metric" in q:
            name = q["metric"][0]
            series = sampler.series(metric=name) if sampler is not None else {}
            if not series:
                return 404, "application/json", json.dumps(
                    {"error": f"no recorded series for metric {name!r}"}
                ).encode()
            variants = series[name]
            label = q.get("label", [None])[0]
            if label is not None:
                variants = {ls: v for ls, v in variants.items()
                            if ls == label or label in ls.split(",")}
                if not variants:
                    return 404, "application/json", json.dumps(
                        {"error": f"no series for metric {name!r} with "
                                  f"label {label!r}"}
                    ).encode()
            payload = {"metric": name, "series": variants}
            from fabric_tpu_torch.ops_metrics import exemplars_report

            ex = exemplars_report(self.registry, metric=name).get(name)
            if ex:
                if label is not None:
                    ex = {ls: v for ls, v in ex.items()
                          if ls == label or label in ls.split(",")}
                if ex:
                    payload["exemplars"] = ex
            return 200, "application/json", json.dumps(payload).encode()
        payload: dict = {"enabled": sampler is not None}
        if sampler is not None:
            payload.update(sampler.report())
        payload["incidents"] = bb.bundles() if bb is not None else []
        return 200, "application/json", json.dumps(payload).encode()

    def _route_launches(self, path: str):
        """Device-time attribution surface (fabric_tpu_torch.observe.ledger):
        per-kernel compile/queue/execute percentiles, program-cache
        hit rates, HBM owner watermarks + a live
        ``torch.cuda.memory_allocated`` sample, the last-N raw launch
        rows, and (the port's addition) ``kernel_launches``: this
        process's kernel wrappers' launch counts by kernel.  ``?n=K`` bounds the
        rows, ``?kernel=NAME`` filters them.  Unarmed answers
        honestly: enabled false, no rows."""
        from urllib.parse import parse_qs, urlparse

        led = self.launches
        if led is None:
            from fabric_tpu_torch.observe import ledger as _ledger

            led = _ledger.global_ledger()
        if led is None:
            return 200, "application/json", json.dumps(
                {"enabled": False}
            ).encode()
        q = parse_qs(urlparse(path).query)
        try:
            # <= 0 means no raw rows (rows() pins this — a raw slice
            # would invert the bound via rows[-0:])
            n = int(q.get("n", ["16"])[0])
        except ValueError:
            return 400, "application/json", b'{"error": "bad n"}'
        kernel = q.get("kernel", [None])[0]
        payload = {"enabled": True,
                   **led.report(rows=n, kernel=kernel)}
        # the kernel wrappers' launch counts of this process, by kernel
        from fabric_tpu_torch import kernels as _kernels

        payload["kernel_launches"] = dict(_kernels.launches)
        from fabric_tpu_torch.observe.ledger import live_device_bytes

        live = live_device_bytes()
        if live is not None:
            payload["live_device_bytes"] = live
        return 200, "application/json", json.dumps(payload).encode()

    def _route_txflow(self, path: str):
        """Per-transaction flow attribution surface
        (fabric_tpu_torch.observe.txflow): stage p50/p99/max, e2e by
        validation outcome, visibility lag (apply-visible minus
        durable-append) and the last-N completed flows.  ``?n=K``
        bounds the rows, ``?tx=TXID`` returns ONE flow's full
        milestone record (completed or still in flight).  Unarmed
        answers honestly: enabled false, no rows."""
        from urllib.parse import parse_qs, urlparse

        j = self.txflow
        if j is None:
            from fabric_tpu_torch.observe import txflow as _txflow

            j = _txflow.global_journal()
        if j is None:
            return 200, "application/json", json.dumps(
                {"enabled": False}
            ).encode()
        q = parse_qs(urlparse(path).query)
        tx = q.get("tx", [None])[0]
        if tx is not None:
            flow = j.lookup(tx)
            if flow is None:
                return 404, "application/json", json.dumps(
                    {"enabled": True, "error": f"no flow for {tx}"}
                ).encode()
            return 200, "application/json", json.dumps(
                {"enabled": True, "flow": flow}
            ).encode()
        try:
            # <= 0 means no raw rows (rows() pins this — a raw slice
            # would invert the bound via rows[-0:])
            n = int(q.get("n", ["16"])[0])
        except ValueError:
            return 400, "application/json", b'{"error": "bad n"}'
        payload = {"enabled": True, **j.report(rows=n)}
        return 200, "application/json", json.dumps(payload).encode()

    def _route_debug(self, path: str):
        """Live profiling surface (the reference's peer.profile pprof
        server, internal/peer/node/start.go:861-876, translated to the
        Python runtime): /debug/stacks dumps every thread's stack;
        /debug/profile?seconds=N runs a wall-clock statistical sampler
        over every live thread and returns a samples/self table."""
        import sys
        import traceback
        from urllib.parse import parse_qs, urlparse

        parsed = urlparse(path)
        if parsed.path == "/debug/stacks":
            import threading

            names = {t.ident: t.name for t in threading.enumerate()}
            out = []
            for tid, frame in sys._current_frames().items():
                out.append(f"--- thread {names.get(tid, tid)} ({tid}) ---")
                out.extend(
                    line.rstrip()
                    for line in traceback.format_stack(frame)
                )
            return 200, "text/plain", "\n".join(out).encode()
        if parsed.path == "/debug/profile":
            # NOTE: blocks THIS request for the sampling window; other
            # connections keep being served (per-connection tasks).
            # A STATISTICAL sampler over sys._current_frames(), not
            # cProfile: the commit/validate hot path runs in
            # ThreadPoolExecutor workers, and a tracing profiler
            # enabled on the event-loop thread would systematically
            # miss it — the wall-clock sampler sees every thread.
            import threading

            try:
                seconds = float(
                    parse_qs(parsed.query).get("seconds", ["5"])[0]
                )
            except ValueError:
                return 400, "application/json", b'{"error": "bad seconds"}'
            seconds = max(0.1, min(seconds, 60.0))

            async def run():
                interval = 0.005
                counts: dict[tuple, int] = {}
                nsamples = 0
                names = {}
                deadline = asyncio.get_event_loop().time() + seconds
                while asyncio.get_event_loop().time() < deadline:
                    names = {
                        t.ident: t.name for t in threading.enumerate()
                    }
                    for tid, frame in sys._current_frames().items():
                        nsamples += 1
                        # dedupe per stack: a recursive function counts
                        # ONCE per sample, not once per stack level
                        stack_keys = set()
                        f = frame
                        while f is not None:
                            co = f.f_code
                            stack_keys.add(
                                (names.get(tid, str(tid)),
                                 co.co_filename, co.co_name, f is frame)
                            )
                            f = f.f_back
                        for key in stack_keys:
                            counts[key] = counts.get(key, 0) + 1
                    await asyncio.sleep(interval)
                lines = [
                    f"wall-clock samples over {seconds}s "
                    f"({nsamples} thread-samples, {interval * 1000:.0f}ms "
                    "interval); 'self' = frame was on top",
                    f"{'samples':>8} {'self':>6}  location",
                ]
                agg: dict[tuple, list] = {}
                for (tname, fn, func, is_top), cnt in counts.items():
                    row = agg.setdefault((tname, fn, func), [0, 0])
                    row[0] += cnt
                    if is_top:
                        row[1] += cnt
                for (tname, fn, func), (tot, self_cnt) in sorted(
                    agg.items(), key=lambda kv: -kv[1][0]
                )[:80]:
                    short = fn.rsplit("/", 1)[-1]
                    lines.append(
                        f"{tot:>8} {self_cnt:>6}  "
                        f"[{tname}] {short}:{func}"
                    )
                return "\n".join(lines) + "\n"

            return run  # the connection handler awaits coroutine routes
        return 404, "application/json", b'{"error": "not found"}'


def apply_logspec(spec: str) -> None:
    """FABRIC_LOGGING_SPEC-style: 'info' or
    'warning:fabric_tpu_torch.peer=debug:fabric_tpu_torch.orderer=error'."""
    parts = [p for p in spec.split(":") if p]
    for p in parts:
        if "=" in p:
            name, _, level = p.partition("=")
            logging.getLogger(name).setLevel(level.upper())
        else:
            logging.getLogger("fabric_tpu_torch").setLevel(p.upper())
