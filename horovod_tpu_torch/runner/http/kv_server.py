"""Rendezvous key-value server over HTTP: the elastic control plane.

The rendezvous core of ``horovod_tpu/runner/http/kv_server.py``
(``_KVHandler`` :229, ``RendezvousServer`` :1227, ``KVClient`` :1639,
``env_generation`` :213), its ``peerstate`` scope (:455-510) and its
driver-epoch fence (:112, :346-364, ``RendezvousServer.seed`` :1301), the
analog of upstream's launcher-side KV store
(``horovod/runner/http/http_server.py``). The elastic driver owns one; its
workers read their world assignment, publish heartbeats, poll the world
generation and the coordinated-abort record, and exchange rank 0's TCP
store endpoint through it. The data plane needs none of it: collectives
run over NCCL or gloo.

Protocol: ``PUT /scope/key`` (body = value bytes), ``GET /scope/key``
(200 + bytes, or 404), ``DELETE /scope`` (drop a scope),
``GET /_scope/scope`` (list keys, newline separated), ``GET /_version``
(the world generation) and ``GET /_epoch`` (the driver epoch: 0 unless
the driver keeps durable control-plane state,
``runner/elastic/driver_state.py``).
Scopes may contain slashes (``world/3``); the key is the last component.

World generation & coordinated abort: the epoch ``version`` doubles as the
monotonic world generation.

- **Abort records** (``abort/<generation>``): the driver posts one
  (:meth:`RendezvousServer.post_abort`) when it reaps an unclean worker
  exit or kills a hung one, and a worker may post one
  (``horovod_tpu_torch.abort.post``). Workers poll the record of their
  generation and turn a wedged collective into ``HorovodInternalError``.
- **Generation fencing**: a write (PUT/DELETE) carrying
  ``X-Hvd-Generation`` older than the current generation is rejected with
  409 and counted (``fenced_writes``), so a zombie worker from a pre-abort
  world corrupts nothing. Writes without the header are not fenced.
- **Driver-epoch fencing**: a write carrying ``X-Hvd-Driver-Epoch`` older
  than the serving driver's epoch comes from a driver that a successor
  has superseded (or a worker still loyal to it) and is rejected with 409
  too; headerless writes are not fenced.

Peer replicas (``PUT /peerstate/<rank>``, ``horovod_tpu_torch.peercheck``):
a record longer than ``peercheck.max_record_bytes()`` is read, discarded
and answered 413; one that fails ``peercheck.verify_wire`` is answered
422 before anything is installed; a fenced one 409. An accepted record is
rotated in with ``checkpoint.rotate_slots`` (``<rank>`` and
``<rank>.prev``), so the previous good commit stays until the new one is
in, and ``GET /_scope/peerstate`` lists both slots. The scope outlives the
world's epochs: generation g's records are what generation g+1's peer
rung assembles.

Observability (``:267-283``, ``:553-854``, ``:1051-1226``): workers put
sampled step traces to ``PUT /trace/<worker>`` (the ``trace`` scope,
at most 1 MiB a payload, replaced per worker) and piggyback their metrics
snapshots, comms-model payloads and memory payloads on their heartbeats.
Six read-only routes are exempt from the HMAC (a Prometheus scraper or
Perfetto cannot sign):

- ``GET /metrics``: Prometheus text of the driver's gauges (generation,
  world size, blacklisted hosts, fenced writes, heartbeat ages, driver
  epoch and driver-lost counts, worker steps and commits) and every
  worker's snapshot with ``rank`` and ``host`` labels, plus the skew
  gauges from the traces; each scrape also folds new sampled steps into
  the server's regression sentinel;
- ``GET /timeline``: the merged Chrome/Perfetto trace, one track per rank
  on the server's timebase (each rank's clock offset applied);
  ``?steps=N`` / ``?rank=R`` bound it, and an unbounded body past
  ``HOROVOD_TIMELINE_MAX_EVENTS`` spans answers 413;
- ``GET /criticalpath``: the per-step attribution
  (``attribution.analyze_cluster``) with the sentinel's state;
- ``GET /stragglers``: the arrival-skew attribution
  (``tracing.compute_skew``);
- ``GET /comms``: the cluster-merged alpha-beta link cost model
  (``comms_model.merge_payloads`` over the ``comms`` section of each
  worker's heartbeat);
- ``GET /memory``: the cluster-merged device-memory breakdown
  (``memory.merge_payloads`` over the heartbeats' ``memory`` sections).
  Both bodies carry the world generation.

- ``GET /integrity``: the integrity fingerprints the workers' heartbeats
  carry (``"integrity"``, keyed by the record's rank), the newest
  complete group's vote (``integrity.vote_latest``, cached per heartbeat
  mutation and world size), the quarantine map and the divergence counts;
  ``no_records`` while nothing fingerprinted.

The robustness plane (``:127``, ``:293``, ``:366-440``, ``:921-1000``,
``:1381-1480``): a warm spare registers at ``PUT /spare/<worker>`` and
an external agent announces a host's reclaim at ``PUT /preempt/<host>``
(the driver reads and clears both). The driver marks a generation it is
about to replace at ``closing/<g>`` (its aborts and drains), which a worker
re-joining reads before it joins that generation. The driver quarantines a rank the
vote named (:meth:`RendezvousServer.quarantine_rank`): its ``peerstate``
PUTs are answered 409 until one comes from a strictly newer generation
(the entry then stays as a tombstone whose condemned range still filters
assembly), and its current record is evicted, its ``.prev`` kept. Before
the driver's tick lands, the live-vote fence answers 409 to a PUT from
the named outlier of the cached complete, unambiguous divergent vote
(nothing is parsed until a heartbeat has carried a fingerprint). The
scrape's policy, spare and integrity families count what the driver
reports (``record_policy_action``, ``set_cluster_info(spares=...)``,
``record_integrity_divergence``, the quarantine map);
:meth:`RendezvousServer.regression_suspects` serves the attribution
sentinel's suspects to the policy's ``step_regression`` channel.

Not ported yet: the ``modelstate`` scope and ``GET /model`` (with
``serving.py``).

Authentication: with ``HOROVOD_SECRET_KEY`` set (the launcher makes one per
job), every request carries ``X-Hvd-Auth: HMAC-SHA256(method\\npath\\n
body)`` and the server answers a missing or wrong tag with 403.

Heartbeats (``PUT /heartbeat/<worker>``) are stamped with the server's
receive time (its monotonic clock: worker clocks never enter the liveness
decision), and their reply carries the server's wall clock
(``{"t_server": ...}``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable
from urllib.error import HTTPError
from urllib.parse import parse_qs, urlsplit
from urllib.request import Request, urlopen

from ... import attribution as _attribution
from ... import comms_model as _comms_model
from ... import faults
from ... import integrity as _integrity
from ... import memory as _memory
from ... import metrics as _metrics
from ... import peercheck as _peercheck
from ... import tracing as _tracing
from ...checkpoint import rotate_slots
from ...utils.env import get_float, get_int
from ...utils.retry import call_with_retries
from .. import secret as _secret

AUTH_HEADER = "X-Hvd-Auth"
GENERATION_HEADER = "X-Hvd-Generation"
DRIVER_EPOCH_HEADER = "X-Hvd-Driver-Epoch"

# Liveness scope: workers PUT /heartbeat/<worker>; the server records the
# RECEIVE time.
HEARTBEAT_SCOPE = "heartbeat"

# Coordinated-abort scope: one record per world generation.
ABORT_SCOPE = "abort"

# Completion scope: an elastic worker whose training function RETURNED
# announces it here (``PUT /done/<worker>``) before exiting 0. A driver
# that adopted the worker across a takeover cannot read its exit code,
# and learns its completion from this record.
DONE_SCOPE = "done"

# Peer-replica scope (see the module docstring).
PEERSTATE_SCOPE = _peercheck.PEERSTATE_SCOPE

# Closing generations: the driver marks a generation it is about to
# replace (``closing/<g>``, ``RendezvousServer.close_generation``).
CLOSING_SCOPE = "closing"

# Warm-spare registration scope: a spare worker (launched with
# HOROVOD_SPARE=1, waiting for an assignment) puts /spare/<worker> once its
# imports are done; the driver counts it warm while it also heartbeats.
SPARE_SCOPE = "spare"

# Preemption-notice scope: an external agent puts /preempt/<host> to
# announce that the host is about to be reclaimed; the driver drains it
# through the SIGTERM final-commit path and clears the notice.
PREEMPT_SCOPE = "preempt"

# Tracing scope: workers PUT /trace/<worker> with sampled step spans and
# their measured clock offset; one payload per worker (replaced each ship).
TRACE_SCOPE = _tracing.TRACE_SCOPE

#: The self-healing policy's action vocabulary (the ``action`` label values
#: of hvd_policy_decisions_total; every one rendered on every scrape).
POLICY_ACTIONS = ("drain", "promote", "preempt")

# Payload bound for /trace PUTs: the worker caps spans/steps at the
# source; this is the server-side backstop against a misbehaving client.
_TRACE_MAX_BYTES = 1 << 20


def timeline_max_events() -> int:
    """Span-event cap for UNFILTERED ``GET /timeline`` bodies
    (``HOROVOD_TIMELINE_MAX_EVENTS``, default 200000; 0 disables): a
    large world's full merge can run to hundreds of MB, so past the cap
    the server answers **413** and the caller must bound the request
    with ``?steps=N`` / ``?rank=R``. Filtered requests are never capped
    (the caller already bounded them), and ``/criticalpath`` is never
    capped (its body is the small per-group analysis, not the raw
    spans). Documented in docs/timeline.md."""
    return get_int("HOROVOD_TIMELINE_MAX_EVENTS", 200000)


def _trace_query(query: str) -> tuple[int | None, str | None] | None:
    """Parse the shared ``?steps=N&rank=R`` trace-route filters.
    Returns (steps, rank), or None when a value is malformed (400)."""
    try:
        q = parse_qs(query, keep_blank_values=False)
    except ValueError:
        return None
    steps = None
    rank = None
    if "steps" in q:
        try:
            steps = int(q["steps"][-1])
        except (ValueError, IndexError):
            return None
        if steps <= 0:
            return None
    if "rank" in q:
        rank = q["rank"][-1]
    unknown = set(q) - {"steps", "rank"}
    if unknown:
        return None
    return steps, rank




def env_generation() -> int | None:
    """The launcher-written world generation, or None outside elastic
    worlds (static/manual launches are never fenced)."""
    raw = os.environ.get("HOROVOD_WORLD_VERSION", "")
    try:
        return int(raw)
    except ValueError:
        return None


def _auth_payload(method: str, path: str, body: bytes) -> bytes:
    return method.encode() + b"\n" + path.encode() + b"\n" + body


class _KVHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    # Silence per-request stderr logging (the launcher multiplexes worker
    # output; interleaved request logs would corrupt it).
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    def _serve_fault(self) -> bool:
        """The ``kv.serve`` injection point: firing (drop semantics)
        closes the connection without answering — to the client a
        transport failure, like a driver dying mid-request."""
        if faults.fire(faults.KV_SERVE):
            self.close_connection = True
            return True
        return False

    def _authenticate(self, body: bytes = b"") -> bool:
        tag = self.headers.get(AUTH_HEADER, "")
        key = self.server.secret  # type: ignore[attr-defined]
        if _secret.verify(_auth_payload(self.command, self.path, body), tag,
                          key=key):
            return True
        self._reply(403, b"bad auth tag")
        return False

    def _split(self):
        # Key = last path component; scope = everything before it.
        path = self.path.strip("/")
        if path.startswith("_scope/"):
            return "_scope", path[len("_scope/"):]
        if "/" not in path:
            return path, None
        scope, key = path.rsplit("/", 1)
        return scope, key

    def do_GET(self):  # noqa: N802
        if self._serve_fault():
            return
        route = urlsplit(self.path)
        if self.path == "/metrics":
            # Unauthenticated by design: Prometheus scrapers can't HMAC.
            return self._serve_metrics()
        if route.path in ("/timeline", "/criticalpath"):
            # Same exemption: Perfetto/curl can't sign; read-only.
            return self._serve_trace_route(route.path, route.query)
        if self.path == "/stragglers":
            return self._serve_json(
                lambda httpd: _compute_cluster_skew(httpd)[0],
                "application/json")
        if self.path == "/comms":
            # Same exemption as /metrics: read-only operational
            # telemetry (the cluster-merged alpha-beta link cost model).
            return self._serve_json(_render_comms, "application/json")
        if self.path == "/memory":
            # Same exemption: the cluster-merged device-memory breakdown
            # (per-rank resident bytes by kind, phase watermarks,
            # headroom, model drift).
            return self._serve_json(_render_memory, "application/json")
        if self.path == "/integrity":
            # Same exemption: the collected fingerprints, the live vote
            # and the quarantine map.
            return self._serve_json(_render_integrity, "application/json")
        if not self._authenticate():
            return
        store = self.server.store  # type: ignore[attr-defined]
        scope, key = self._split()
        if scope == "_version":
            body = str(self.server.version).encode()  # type: ignore[attr-defined]
            return self._reply(200, body)
        if scope == "_epoch":
            body = str(self.server.driver_epoch).encode()  # type: ignore[attr-defined]
            return self._reply(200, body)
        if scope == "_scope":
            with self.server.lock:  # type: ignore[attr-defined]
                keys = sorted(store.get(key or "", {}).keys())
            return self._reply(200, ("\n".join(keys)).encode())
        with self.server.lock:  # type: ignore[attr-defined]
            val = store.get(scope, {}).get(key)
        if val is None:
            return self._reply(404, b"")
        self._reply(200, val)

    def _fence_check_locked(self) -> bytes | None:
        """Generation fence (call under the server lock): a write stamped
        with a generation older than the current world generation is a
        zombie from a pre-abort world. Returns the 409 body, or None to
        proceed. Writes without the header are unfenced."""
        raw = self.headers.get(GENERATION_HEADER)
        if raw is None:
            # Epoch-only writes (``abort.post``) are fenced on the epoch.
            return self._epoch_fence_locked()
        try:
            gen = int(raw)
        except ValueError:
            return b"bad generation header"
        current = self.server.version  # type: ignore[attr-defined]
        if gen < current:
            self.server.fenced += 1  # type: ignore[attr-defined]
            return (f"stale generation {gen} rejected "
                    f"(world at generation {current})").encode()
        return self._epoch_fence_locked()

    def _epoch_fence_locked(self) -> bytes | None:
        """Driver-epoch fence (under the server lock): a write stamped with
        an epoch older than the serving driver's is answered 409, so a
        driver that was stopped through its successor's takeover cannot
        change the successor's world. Headerless writes are unfenced."""
        raw = self.headers.get(DRIVER_EPOCH_HEADER)
        if raw is None:
            return None
        try:
            epoch = int(raw)
        except ValueError:
            return b"bad driver-epoch header"
        current = self.server.driver_epoch  # type: ignore[attr-defined]
        if epoch < current:
            self.server.fenced += 1  # type: ignore[attr-defined]
            return (f"stale driver epoch {epoch} rejected "
                    f"(world owned by driver epoch {current})").encode()
        return None

    def _integrity_quarantine_locked(self, key: str) -> bytes | None:
        """The integrity fence of the ``peerstate`` scope (under the
        server lock): a rank the vote named has its replica PUTs answered
        409 until one arrives from a STRICTLY newer generation (the
        re-formed world gives the rank id to a healthy worker), so a
        corrupt shard never displaces a good replica. Headerless writes
        from a quarantined rank are refused too."""
        base = key
        while base.endswith(_peercheck.PREV_SUFFIX):
            base = base[:-len(_peercheck.PREV_SUFFIX)]
        raw = self.headers.get(GENERATION_HEADER)
        try:
            gen = int(raw) if raw is not None else None
        except ValueError:
            gen = None
        entry = self.server.integrity_quarantine.get(base)  # type: ignore[attr-defined]
        if entry is not None:
            if entry.get("lifted"):
                # A tombstone: the PUT fence is down (the condemned range
                # still filters assembly), the live-vote fence is not.
                return self._live_vote_fence_locked(base, gen)
            if gen is not None and gen > int(entry.get("generation", 0)):
                # The new world owns the rank id: lift the fence, keep the
                # entry, whose condemned range still filters the peer
                # rung until the new generation's replica set completes.
                entry["lifted"] = True
                return None
            self.server.fenced += 1  # type: ignore[attr-defined]
            return (f"integrity quarantine: rank {base} was voted "
                    f"divergent at generation {entry.get('generation')} "
                    f"step {entry.get('step')} (host "
                    f"{entry.get('host')}); replica PUTs are fenced "
                    "until a newer generation").encode()
        return self._live_vote_fence_locked(base, gen)

    def _live_vote_fence_locked(self, base: str, gen: int | None
                                ) -> bytes | None:
        """The quarantine lands on the driver's next tick, which a corrupt
        rank's next commit can race, rotating the last good ``.prev``
        away. The server holds every rank's fingerprint already, so it
        votes inline: a replica PUT from the named outlier of a complete,
        unambiguous divergent vote is refused unless it comes from a
        strictly newer generation. Until a heartbeat has carried a
        fingerprint (``integrity_seen``) nothing is parsed; after, the
        vote is cached per heartbeat mutation."""
        if not self.server.integrity_seen:  # type: ignore[attr-defined]
            return None
        _records, voted = _cached_integrity_vote(self.server, locked=True)
        if voted is None:
            return None
        (vgen, vstep), verdict = voted
        if not verdict.get("divergent") or verdict.get("ambiguous"):
            return None
        try:
            outlier = int(verdict["outlier_rank"])
        except (KeyError, TypeError, ValueError):
            return None
        if str(outlier) != base or (gen is not None and gen > vgen):
            return None
        self.server.fenced += 1  # type: ignore[attr-defined]
        return (f"integrity live-vote fence: rank {base} is the outlier "
                f"of a divergent vote at generation {vgen} step {vstep}; "
                "replica PUT rejected pending driver quarantine").encode()

    def _drain_and_413(self, length: int, reason: bytes):
        """Refuse an oversize body without holding it: read it in small
        chunks and drop them (so the client reads a clean 413, not a reset
        connection mid-upload)."""
        remaining = length
        while remaining > 0:
            chunk = self.rfile.read(min(remaining, 1 << 16))
            if not chunk:
                break
            remaining -= len(chunk)
        return self._reply(413, reason)

    def do_PUT(self):  # noqa: N802
        if self._serve_fault():
            return
        scope, key = self._split()
        if key is None:
            return self._reply(400, b"missing key")
        length = int(self.headers.get("Content-Length", 0))
        if (scope == PEERSTATE_SCOPE
                and length > _peercheck.max_record_bytes()):
            return self._drain_and_413(length, b"replica record too large")
        if scope == TRACE_SCOPE and length > _TRACE_MAX_BYTES:
            return self._drain_and_413(length, b"trace payload too large")
        body = self.rfile.read(length)
        if not self._authenticate(body):
            return
        if scope == PEERSTATE_SCOPE:
            # Install-time gate: a torn (a sender killed mid-PUT) or
            # corrupt record is refused before it touches the store; the
            # previous good record and its .prev stay.
            why = _peercheck.verify_wire(body)
            if why is not None:
                return self._reply(422, why.encode())
        with self.server.lock:  # type: ignore[attr-defined]
            rejected = self._fence_check_locked()
            if rejected is None and scope == PEERSTATE_SCOPE:
                rejected = self._integrity_quarantine_locked(key)
            if rejected is None:
                if scope == PEERSTATE_SCOPE:
                    rotate_slots(
                        self.server.store.setdefault(scope, {}),  # type: ignore[attr-defined]
                        key, body, prev_suffix=_peercheck.PREV_SUFFIX,
                        depth=_peercheck.retention_depth())
                else:
                    self.server.store.setdefault(scope, {})[key] = body  # type: ignore[attr-defined]
                if scope == TRACE_SCOPE:
                    # The attribution cache's key: /criticalpath and the
                    # sentinel re-analyze when new spans arrive.
                    self.server.trace_version += 1  # type: ignore[attr-defined]
                if scope == HEARTBEAT_SCOPE:
                    self.server.hb_times[key] = time.monotonic()  # type: ignore[attr-defined]
                    # The vote cache's key, and the live-vote fence's
                    # latch (a substring scan, no parse).
                    self.server.hb_version += 1  # type: ignore[attr-defined]
                    if (not self.server.integrity_seen  # type: ignore[attr-defined]
                            and b'"integrity"' in body):
                        self.server.integrity_seen = True  # type: ignore[attr-defined]
        if rejected is not None:
            return self._reply(409, rejected)
        if scope == HEARTBEAT_SCOPE:
            return self._reply(
                200, json.dumps({"t_server": time.time()}).encode())
        self._reply(200, b"")

    def do_DELETE(self):  # noqa: N802
        if self._serve_fault():
            return
        if not self._authenticate():
            return
        scope = self.path.strip("/")
        with self.server.lock:  # type: ignore[attr-defined]
            rejected = self._fence_check_locked()
            if rejected is None:
                self.server.store.pop(scope, None)  # type: ignore[attr-defined]
        if rejected is not None:
            return self._reply(409, rejected)
        self._reply(200, b"")

    def _reply(self, code: int, body: bytes):
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _serve_trace_route(self, path: str, query: str):
        parsed = _trace_query(query)
        if parsed is None:
            return self._reply(
                400, b"bad query: use ?steps=N (positive int) "
                     b"and/or ?rank=R")
        steps, rank = parsed
        if path == "/timeline" and steps is None and rank is None:
            # The cap guards /timeline only: its body scales with the
            # raw span count. /criticalpath serves the small per-group
            # analysis (computed cached on every scrape regardless), so
            # capping it would deny the route while protecting nothing.
            cap = timeline_max_events()
            if cap > 0:
                count = _timeline_span_count(self.server)
                if count > cap:
                    return self._reply(
                        413,
                        (f"merged trace holds {count} span events > cap "
                         f"{cap} (HOROVOD_TIMELINE_MAX_EVENTS); bound "
                         f"the request with ?steps=N and/or ?rank=R"
                         ).encode())
        if path == "/criticalpath":
            render = (lambda httpd:
                      _render_criticalpath(httpd, steps=steps, rank=rank))
        else:
            render = (lambda httpd:
                      _render_timeline(httpd, steps=steps, rank=rank))
        return self._serve_json(render, "application/json")

    def _serve_metrics(self):
        try:
            body = _render_cluster_metrics(self.server).encode()
        except Exception as e:  # noqa: BLE001 — scrape must not kill the KV
            return self._reply(500, f"metrics render failed: {e}".encode())
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _serve_json(self, render, content_type: str):
        try:
            body = json.dumps(render(self.server)).encode()
        except Exception as e:  # noqa: BLE001 — must not kill the KV
            return self._reply(500, f"render failed: {e}".encode())
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def _trace_payloads(httpd) -> dict[str, dict]:
    """Parsed ``PUT /trace`` payloads by host (malformed ones dropped —
    a broken worker must not break the merge for everyone else)."""
    with httpd.lock:
        raw = dict(httpd.store.get(TRACE_SCOPE, {}))
    out: dict[str, dict] = {}
    for host, body in raw.items():
        try:
            payload = json.loads(body)
        except (ValueError, UnicodeDecodeError):
            continue
        if isinstance(payload, dict):
            out[host] = payload
    return out


def _timeline_span_count(httpd) -> int:
    """Span events an unfiltered /timeline body would carry (the 413
    cap's cheap estimate — no JSON re-render)."""
    total = 0
    for payload in _trace_payloads(httpd).values():
        for steprec in payload.get("steps", ()) or ():
            if isinstance(steprec, dict):
                total += len(steprec.get("spans", ()) or ())
    return total


def _render_timeline(httpd, steps: int | None = None,
                     rank: str | None = None) -> dict:
    """The merged cross-rank trace: every shipped payload's spans on one
    server timebase (each rank's measured clock offset applied), one
    Chrome-trace process track per rank. Loadable directly in Perfetto /
    chrome://tracing. ``steps`` keeps only each rank's last N buffered
    steps; ``rank`` keeps one rank's track — the ``?steps=N`` /
    ``?rank=R`` query filters that keep large-world scrapes bounded."""
    payloads = _trace_payloads(httpd)
    events: list[dict] = []
    for host, payload in sorted(payloads.items()):
        if rank is not None and str(payload.get("rank", "?")) != str(rank):
            continue
        try:
            pid = int(payload.get("rank", 0))
        except (TypeError, ValueError):
            pid = 0
        try:
            offset = float(payload.get("clock_offset_s", 0.0) or 0.0)
        except (TypeError, ValueError):
            offset = 0.0
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": f"rank {pid} ({host})"}})
        events.append({"name": "process_sort_index", "ph": "M", "pid": pid,
                       "args": {"sort_index": pid}})
        steprecs = list(payload.get("steps", ()) or ())
        if steps is not None and steps > 0:
            steprecs = steprecs[-steps:]  # ring order: oldest first
        for steprec in steprecs:
            if not isinstance(steprec, dict):
                continue
            for sp in steprec.get("spans", ()) or ():
                if not isinstance(sp, dict):
                    continue
                try:
                    ts_us = (float(sp["t"]) + offset) * 1e6
                    dur_us = max(float(sp.get("dur", 0.0)), 0.0) * 1e6
                except (KeyError, TypeError, ValueError):
                    continue
                events.append({
                    "name": str(sp.get("name", "?")),
                    "cat": str(sp.get("cat", "phase")),
                    "ph": "X",
                    "ts": ts_us,
                    "dur": dur_us,
                    "pid": pid,
                    "tid": 0,
                    "args": {
                        "step": steprec.get("step"),
                        "host": host,
                        **(sp.get("args") or {}),
                    },
                })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {
            "timebase": "rendezvous-server wall clock (offsets applied)",
            "ranks": sorted(
                str(p.get("rank", "?")) for p in payloads.values()),
        },
    }


def _compute_cluster_skew(httpd) -> tuple[dict, dict[str, dict]]:
    """Arrival-skew attribution over the shipped payloads, plus the
    payloads themselves (so /metrics renders offsets without re-parsing).
    Journals a throttled ``straggler_detected`` event when the worst
    matched instance crosses ``HOROVOD_STRAGGLER_WARN_SKEW``."""
    payloads = _trace_payloads(httpd)
    skew = _tracing.compute_skew(payloads)
    worst = skew.get("worst")
    # Threshold on skew MINUS the combined clock-error bound: congested
    # heartbeats widen each rank's offset uncertainty (up to ~RTT/2), and
    # that uncertainty must never journal a healthy host as a straggler.
    if worst and (worst["skew_s"] - worst.get("err_s", 0.0)
                  >= _tracing.straggler_warn_skew()):
        with httpd.lock:
            version = httpd.version
            logged = httpd.straggler_logged
            key = (version, worst["last_rank"])
            fresh = key not in logged
            logged.add(key)
        if fresh:
            _metrics.event(
                "straggler_detected", generation=version,
                rank=worst["last_rank"], host=worst["last_host"],
                skew_s=worst["skew_s"], collective=worst["name"],
                step=worst["step"])
    return skew, payloads


def _cluster_attribution(httpd) -> dict:
    """The full-cluster step attribution (``attribution.analyze_cluster``
    over the shipped payloads), cached per trace-store mutation
    (``trace_version``) so repeated scrapes and replica polls cost one
    integer compare. A cache MISS additionally folds any new
    (generation, step) groups into the server's regression sentinel —
    the one place the sentinel ticks, so it advances exactly once per
    new sampled step no matter how many routes render it."""
    with httpd.lock:
        version = httpd.trace_version
        cached = httpd.attrib_cache
    if cached is not None and cached[0] == version:
        return cached[1]
    analysis = _attribution.analyze_cluster(_trace_payloads(httpd))
    _sentinel_fold(httpd, analysis)
    with httpd.lock:
        httpd.attrib_cache = (version, analysis)
    return analysis


def _sentinel_fold(httpd, analysis: dict) -> None:
    """Feed NEW (generation, step) groups into the server's regression
    sentinel (EWMA baseline per phase over the cluster-mean
    decomposition), journal a ``step_regression`` event for each phase
    that newly crosses the drift threshold — naming the suspect rank the
    group's critical path gated on — and refresh the advisory
    ``regression_suspects`` map ({host: excess seconds}) the self-healing
    policy may consult (``HOROVOD_POLICY_STEP_REGRESSION``)."""
    sentinel = httpd.attrib_sentinel
    with httpd.lock:
        folded = httpd.attrib_folded
        new = [g for g in analysis.get("groups", ())
               if (g["generation"], g["step"]) not in folded]
        folded.update((g["generation"], g["step"]) for g in new)
        if len(folded) > 4096:
            # Evict the OLDEST keys only: the per-rank ring advances
            # monotonically, so a low (generation, step) can never
            # reappear in the payloads — while an arbitrary set.pop()
            # could evict a still-buffered group and double-fold it
            # into the sentinel on the next mutation.
            for key in sorted(folded)[:len(folded) - 2048]:
                folded.discard(key)
    suspects: dict[str, float] = {}
    for g in new:
        ranks = g.get("ranks") or {}
        if not ranks:
            continue
        phases = {
            p: sum(d["phases"].get(p, 0.0) for d in ranks.values())
            / len(ranks)
            for p in _attribution.STEP_PHASES
        }
        verdict = sentinel.observe(phases, wall=g.get("wall_s"))
        alarmed = sorted(sentinel.snapshot()["alarmed"])
        if verdict["alarms"]:
            _metrics.event(
                "step_regression",
                generation=g["generation"], step=g["step"],
                phases=verdict["alarms"],
                scores={p: verdict["scores"].get(p)
                        for p in verdict["alarms"]},
                excess_s={p: verdict["excess_s"].get(p)
                          for p in verdict["alarms"]},
                suspect_rank=g.get("suspect_rank"),
                suspect_host=g.get("suspect_host"))
        # Advisory policy channel: while ANY phase is in alarm, the
        # latest group's critical-path suspect carries the worst
        # alarmed excess (seconds — directly comparable to the skew
        # and comms-residual lateness channels). No alarm = empty map.
        if alarmed and g.get("suspect_host"):
            suspects = {
                str(g["suspect_host"]): max(
                    (verdict["excess_s"].get(p, 0.0) for p in alarmed),
                    default=0.0)
            }
        elif not alarmed:
            suspects = {}
    if new:
        with httpd.lock:
            httpd.regression_suspects = suspects


def _render_criticalpath(httpd, steps: int | None = None,
                         rank: str | None = None) -> dict:
    """``GET /criticalpath``: the merged per-step attribution — per-rank
    phase decomposition (phases sum to each rank's step wall time), the
    cluster critical path with a named gating rank per collective
    barrier, per-rank MFU where the model declared its FLOPs, and the
    regression sentinel's state. A world with no synced samples yet
    (cold start, ``HOROVOD_TRACE_SAMPLE=0``) serves an explicit
    ``insufficient_samples`` body — never a 500. ``steps``/``rank`` are
    the bounding query filters (applied to the cached full analysis)."""
    analysis = _cluster_attribution(httpd)
    groups = list(analysis.get("groups", ()))
    if steps is not None and steps > 0:
        groups = groups[-steps:]
    if rank is not None:
        groups = [
            dict(g, ranks={r: d for r, d in g.get("ranks", {}).items()
                           if r == str(rank)})
            for g in groups
        ]
        groups = [g for g in groups if g["ranks"]]
    with httpd.lock:
        generation = httpd.version
        sentinel = httpd.attrib_sentinel
        suspects = dict(httpd.regression_suspects)
    return {
        "status": "ok" if groups else "insufficient_samples",
        "generation": generation,
        "groups": groups,
        "regression": {
            "sentinel": (sentinel.snapshot()
                         if sentinel is not None else None),
            "suspects": suspects,
        },
    }


def _heartbeat_sections(httpd, key: str) -> dict[str, dict]:
    """The ``key`` section (``"comms"``, ``"memory"``) of each worker's
    last heartbeat body, by worker name. Malformed heartbeats are skipped,
    as the metrics piggyback's are."""
    with httpd.lock:
        raw = dict(httpd.store.get(HEARTBEAT_SCOPE, {}))
    out: dict[str, dict] = {}
    for host, body in raw.items():
        try:
            hb = json.loads(body)
        except (ValueError, UnicodeDecodeError):
            continue
        if not isinstance(hb, dict):
            continue
        section = hb.get(key)
        if isinstance(section, dict):
            out[host] = section
    return out


def _render_comms(httpd) -> dict:
    """``GET /comms``: the cluster-merged alpha-beta link cost model. A
    world where nothing fitted yet serves an explicit
    ``insufficient_samples`` body, never a 500
    (``comms_model.merge_payloads``). The body carries the world
    generation, so a reader can discard a merge across generations."""
    merged = _comms_model.merge_payloads(_heartbeat_sections(httpd, "comms"))
    with httpd.lock:
        merged["generation"] = httpd.version
    return merged


def _render_memory(httpd) -> dict:
    """``GET /memory``: the cluster-merged device-memory breakdown. A
    world where nothing was measured yet serves an explicit
    ``insufficient_samples`` body, never a 500
    (``memory.merge_payloads``); generation-stamped like ``/comms``."""
    merged = _memory.merge_payloads(_heartbeat_sections(httpd, "memory"))
    with httpd.lock:
        merged["generation"] = httpd.version
    return merged


def _integrity_records(httpd, locked: bool = False) -> dict[int, dict]:
    """The integrity fingerprints the heartbeats carry (their
    ``"integrity"`` section), keyed by each record's own rank; malformed
    heartbeats are skipped. ``locked=True`` from a caller holding
    ``httpd.lock`` (it is not reentrant)."""
    if locked:
        raw = dict(httpd.store.get(HEARTBEAT_SCOPE, {}))
    else:
        with httpd.lock:
            raw = dict(httpd.store.get(HEARTBEAT_SCOPE, {}))
    out: dict[int, dict] = {}
    for body in raw.values():
        try:
            hb = json.loads(body)
        except (ValueError, UnicodeDecodeError):
            continue
        if not isinstance(hb, dict):
            continue
        rec = hb.get("integrity")
        if not isinstance(rec, dict):
            continue
        try:
            rank = int(rec.get("rank", 0))
        except (TypeError, ValueError):
            continue
        # Colliding ranks: the freshest record wins, so a zombie's stale
        # payload cannot shadow the live rank's.
        held = out.get(rank)
        if held is None or rec.get("t", 0) >= held.get("t", 0):
            out[rank] = rec
    return out


def _vote_world(server) -> int:
    """The ranks a complete vote group needs: the world's slots as the
    driver set them (``set_cluster_info(ranks=...)``), else its hosts."""
    return server.world_ranks or server.world_np


def _cached_integrity_vote(server, locked: bool = False):
    """(records, voted) for the current heartbeats, cached per
    (``hb_version``, world size): replica PUTs and idle ``GET /integrity``
    polls cost one compare, not a parse of every heartbeat and a vote."""
    world = _vote_world(server)
    key = (server.hb_version, world)
    cached = server.integrity_vote_cache
    if cached is not None and cached[0] == key:
        return cached[1], cached[2]
    records = _integrity_records(server, locked=locked)
    voted = (_integrity.vote_latest(records, world or len(records))
             if records else None)
    server.integrity_vote_cache = (key, records, voted)
    return records, voted


def _render_integrity(httpd) -> dict:
    """``GET /integrity``: the collected fingerprints, the newest complete
    group's vote, the quarantine map and the divergence counts; a world
    where nothing fingerprinted yet serves ``no_records``, never a 500."""
    records, voted = _cached_integrity_vote(httpd)
    with httpd.lock:
        generation = httpd.version
        world = _vote_world(httpd)
        quarantined = {r: dict(e)
                       for r, e in httpd.integrity_quarantine.items()}
        divergence = dict(httpd.integrity_divergence)
    out = {
        "status": "ok" if records else "no_records",
        "generation": generation,
        "world_size": world,
        "records": {str(r): rec for r, rec in sorted(records.items())},
        "quarantined": quarantined,
        "divergence_counts": divergence,
        "vote": None,
    }
    if voted is not None:
        (gen, step), verdict = voted
        out["vote"] = {"group": [gen, step], **verdict}
    return out


def _render_cluster_metrics(httpd) -> str:
    """The driver's cluster-wide scrape: driver-plane gauges built from
    live server state, then every worker snapshot found piggybacked on a
    heartbeat payload, rendered with per-rank/host labels."""
    with httpd.lock:
        version = httpd.version
        fenced = httpd.fenced
        world_np = httpd.world_np
        blacklisted = httpd.blacklisted
        driver_epoch = httpd.driver_epoch
        driver_lost = dict(httpd.driver_lost)
        spares = httpd.spare_count
        policy_actions = dict(httpd.policy_actions)
        integrity_div = dict(httpd.integrity_divergence)
        quarantined = sum(1 for e in httpd.integrity_quarantine.values()
                          if not e.get("lifted"))
        now = time.monotonic()
        ages = {h: now - t for h, t in httpd.hb_times.items()}
        payloads = dict(httpd.store.get(HEARTBEAT_SCOPE, {}))
    driver_families = [
        _metrics.make_family(
            "hvd_world_generation", "gauge",
            "Monotonic world generation (the rendezvous epoch version).",
            [({}, version)]),
        _metrics.make_family(
            "hvd_world_size", "gauge",
            "Hosts in the current world epoch (0 before the first "
            "elastic publish).", [({}, world_np)]),
        _metrics.make_family(
            "hvd_blacklisted_hosts", "gauge",
            "Hosts currently blacklisted by the elastic driver.",
            [({}, blacklisted)]),
        _metrics.make_family(
            "hvd_fenced_writes_total", "counter",
            "Stale-generation writes rejected by the generation fence.",
            [({}, fenced)]),
        _metrics.make_family(
            "hvd_heartbeat_age_seconds", "gauge",
            "Seconds since each host's last heartbeat (server clock).",
            [({"host": h}, age) for h, age in sorted(ages.items())]),
        # Self-healing policy plane: every action label on every scrape,
        # at zero before the first decision.
        _metrics.make_family(
            "hvd_policy_spare_hosts", "gauge",
            "Warm spare hosts currently launched, heartbeating, and held "
            "out of the world by the elastic driver.",
            [({}, spares)]),
        _metrics.make_family(
            "hvd_policy_decisions_total", "counter",
            "Self-healing policy actions taken by the elastic driver "
            "(drain|promote|preempt).",
            [({"action": a}, policy_actions.get(a, 0))
             for a in POLICY_ACTIONS]),
        # Control-plane fault tolerance: the driver epoch (split-brain
        # fence identity; 0 = no driver-state plane) and per-host
        # EXIT_DRIVER_LOST reap counts. The unlabeled sample is the
        # job-wide total, zero-materialized so the scrape gate can
        # assert the instrument before any flap.
        _metrics.make_family(
            "hvd_driver_epoch", "gauge",
            "Monotonic driver epoch: bumped on every driver (re)start; "
            "stale-epoch writes are 409-fenced.",
            [({}, driver_epoch)]),
        _metrics.make_family(
            "hvd_driver_lost_total", "counter",
            "Workers reaped with EXIT_DRIVER_LOST (rendezvous KV "
            "unreachable past the deadline) — control-plane flaps, by "
            "host, plus the unlabeled job-wide total.",
            [({}, sum(driver_lost.values()))]
            + [({"host": h}, n) for h, n in sorted(driver_lost.items())]),
        # Integrity defense plane (driver-side vote outcomes): the
        # unlabeled sample is the job-wide total, zero-materialized so
        # the scrape gate can assert the instrument before any
        # corruption ever happens.
        _metrics.make_family(
            "hvd_integrity_divergence_total", "counter",
            "Cross-rank integrity votes that named a host's replica "
            "state divergent (silent data corruption evidence), by "
            "host, plus the unlabeled job-wide total.",
            [({}, sum(integrity_div.values()))]
            + [({"host": h}, n) for h, n in sorted(integrity_div.items())]),
        _metrics.make_family(
            "hvd_integrity_quarantined_ranks", "gauge",
            "Ranks whose peer-replica PUTs are currently fenced by an "
            "integrity-vote quarantine.", [({}, quarantined)]),
    ]
    # Multi-tenant pod: a driver serving one job of a shared pool
    # (HOROVOD_JOB_ID set per job process tree by the scheduler) stamps
    # every family on its scrape with the job dimension, so N per-job
    # scrape targets merge in PromQL without relabeling. Unset (every
    # single-job path) the scrape is bit-for-bit the HEAD body.
    job = os.environ.get("HOROVOD_JOB_ID") or ""
    job_labels = {"job": job} if job else {}
    groups: list = [(job_labels, driver_families)]
    steps_samples: list = []
    commit_samples: list = []
    for host, raw in sorted(payloads.items()):
        try:
            payload = json.loads(raw)
        except (ValueError, UnicodeDecodeError):
            continue
        if not isinstance(payload, dict):
            continue
        labels = {"host": host, **job_labels}
        rank = payload.get("rank")
        if rank is not None:
            labels["rank"] = str(rank)
        if isinstance(payload.get("steps"), (int, float)):
            steps_samples.append((labels, payload["steps"]))
        if isinstance(payload.get("commits"), (int, float)):
            commit_samples.append((labels, payload["commits"]))
        families = payload.get("metrics")
        if isinstance(families, list):
            families = [f for f in families
                        if isinstance(f, dict) and "name" in f]
            if families:
                groups.append((labels, families))
    driver_families.append(_metrics.make_family(
        "hvd_worker_steps_total", "counter",
        "Watched steps reported on each worker's last heartbeat.",
        steps_samples))
    driver_families.append(_metrics.make_family(
        "hvd_worker_commits_total", "counter",
        "State commits reported on each worker's last heartbeat.",
        commit_samples))
    # Tick the step-attribution plane on every scrape (cached per trace
    # mutation, so an idle poll costs one integer compare): the
    # regression sentinel must advance on the operator's regular
    # /metrics cadence even when nobody fetches /criticalpath.
    try:
        _cluster_attribution(httpd)
    except Exception:  # noqa: BLE001 — attribution must not kill the scrape
        pass
    # Straggler attribution from the tracing plane: per-rank arrival skew
    # against the earliest rank on matched collectives/steps (shipped
    # trace payloads, offset-corrected), and a per-host score the
    # autoscaler (ROADMAP item 3) can threshold on. Empty when no traces
    # have shipped (HOROVOD_TRACE_SAMPLE=0) — absent series, not zeros,
    # so dashboards can tell "no stragglers" from "not measuring".
    skew, payloads = _compute_cluster_skew(httpd)
    skew_samples = []
    host_lateness: dict[str, list[float]] = {}
    for rank, info in sorted(skew.get("ranks", {}).items()):
        labels = {"rank": rank, "host": info.get("host", "")}
        skew_samples.append((labels, info["max_lateness_s"]))
        host_lateness.setdefault(info.get("host", ""), []).append(
            info["mean_lateness_s"])
    if skew_samples:
        driver_families.append(_metrics.make_family(
            "hvd_collective_skew_seconds", "gauge",
            "Max arrival lateness of each rank behind the earliest rank "
            "on matched collectives (offset-corrected trace spans).",
            skew_samples))
        driver_families.append(_metrics.make_family(
            "hvd_straggler_score", "gauge",
            "Mean arrival lateness per host across its ranks' matched "
            "collectives — the straggler-replacement signal.",
            [({"host": h}, sum(ls) / len(ls))
             for h, ls in sorted(host_lateness.items())]))
    offset_samples = [
        ({"rank": str(p.get("rank", "?")), "host": h},
         float(p.get("clock_offset_s", 0.0) or 0.0))
        for h, p in sorted(payloads.items())
    ]
    if offset_samples:
        driver_families.append(_metrics.make_family(
            "hvd_trace_clock_offset_seconds", "gauge",
            "Each rank's measured wall-clock offset vs the rendezvous "
            "server (server - local), as shipped with its trace.",
            offset_samples))
    return _metrics.render_families(groups)


class RendezvousServer:
    """In-memory scoped KV over HTTP, owned by the launcher."""

    def __init__(self, host: str = "0.0.0.0"):
        self._httpd = ThreadingHTTPServer((host, 0), _KVHandler)
        self._httpd.daemon_threads = True
        self._httpd.store = {}  # type: ignore[attr-defined]
        self._httpd.lock = threading.Lock()  # type: ignore[attr-defined]
        self._httpd.version = 0  # type: ignore[attr-defined]
        self._httpd.fenced = 0  # type: ignore[attr-defined]
        self._httpd.hb_times = {}  # type: ignore[attr-defined]
        # 0 until a driver with durable control-plane state seeds its own.
        self._httpd.driver_epoch = 0  # type: ignore[attr-defined]
        # Driver-side scrape gauges (set_cluster_info, record_driver_lost).
        self._httpd.world_np = 0  # type: ignore[attr-defined]
        self._httpd.world_ranks = 0  # type: ignore[attr-defined]
        self._httpd.blacklisted = 0  # type: ignore[attr-defined]
        self._httpd.driver_lost = {}  # type: ignore[attr-defined]
        # The robustness plane: warm spares, policy actions, the vote's
        # divergence counts and quarantine map; the live-vote fence's
        # latch and the vote cache (keyed by the heartbeat mutation count).
        self._httpd.spare_count = 0  # type: ignore[attr-defined]
        self._httpd.policy_actions = {}  # type: ignore[attr-defined]
        self._httpd.integrity_divergence = {}  # type: ignore[attr-defined]
        self._httpd.integrity_quarantine = {}  # type: ignore[attr-defined]
        self._httpd.integrity_seen = False  # type: ignore[attr-defined]
        self._httpd.hb_version = 0  # type: ignore[attr-defined]
        self._httpd.integrity_vote_cache = None  # type: ignore[attr-defined]
        self._httpd.straggler_logged = set()  # type: ignore[attr-defined]
        # Step-attribution plane: the analysis cache (keyed by the trace
        # mutation counter), the regression sentinel, the (generation,
        # step) groups already folded into it, and the {host: excess
        # seconds} suspect map.
        self._httpd.trace_version = 0  # type: ignore[attr-defined]
        self._httpd.attrib_cache = None  # type: ignore[attr-defined]
        self._httpd.attrib_sentinel = (  # type: ignore[attr-defined]
            _attribution.RegressionSentinel())
        self._httpd.attrib_folded = set()  # type: ignore[attr-defined]
        self._httpd.regression_suspects = {}  # type: ignore[attr-defined]
        # Key snapshot at construction: the job's secret must not drift
        # under a live server.
        self._httpd.secret = _secret.current_key()  # type: ignore[attr-defined]
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def version(self) -> int:
        return self._httpd.version  # type: ignore[attr-defined]

    @property
    def generation(self) -> int:
        """The monotonic world generation (alias of the epoch version)."""
        return self._httpd.version  # type: ignore[attr-defined]

    @property
    def fenced_writes(self) -> int:
        """How many stale-generation writes the fence has rejected."""
        with self._httpd.lock:  # type: ignore[attr-defined]
            return self._httpd.fenced  # type: ignore[attr-defined]

    @property
    def driver_epoch(self) -> int:
        return self._httpd.driver_epoch  # type: ignore[attr-defined]

    def seed(self, generation: int | None = None,
             driver_epoch: int | None = None) -> None:
        """A restarted driver's takeover: start the fresh server at the
        snapshot's world generation (so the takeover world publishes at
        g+1 and the generation fence stays monotonic across the crash) and
        at the driver's own epoch (arming the epoch fence). Call before
        :meth:`start`."""
        with self._httpd.lock:  # type: ignore[attr-defined]
            if generation is not None:
                self._httpd.version = int(generation)  # type: ignore[attr-defined]
            if driver_epoch is not None:
                self._httpd.driver_epoch = int(driver_epoch)  # type: ignore[attr-defined]

    def seed_driver_lost(self, counts: dict) -> None:
        """Takeover resume: carry the predecessor's per-worker
        EXIT_DRIVER_LOST counts into the scrape's
        ``hvd_driver_lost_total``."""
        with self._httpd.lock:  # type: ignore[attr-defined]
            table = self._httpd.driver_lost  # type: ignore[attr-defined]
            for host, n in (counts or {}).items():
                table[str(host)] = max(table.get(str(host), 0), int(n))

    def record_driver_lost(self, host: str) -> None:
        """Count one EXIT_DRIVER_LOST reap into ``hvd_driver_lost_total``."""
        with self._httpd.lock:  # type: ignore[attr-defined]
            counts = self._httpd.driver_lost  # type: ignore[attr-defined]
            counts[host] = counts.get(host, 0) + 1

    def set_cluster_info(self, world_np: int | None = None,
                         blacklisted: int | None = None,
                         spares: int | None = None,
                         ranks: int | None = None) -> None:
        """Driver-side facts, which only the driver knows: the world's
        hosts, the blacklisted hosts and the warm spares (scrape gauges),
        and the world's ranks (the size of a complete vote group; the
        port runs a worker per slot, so a host may hold several)."""
        with self._httpd.lock:  # type: ignore[attr-defined]
            if world_np is not None:
                self._httpd.world_np = int(world_np)  # type: ignore[attr-defined]
            if blacklisted is not None:
                self._httpd.blacklisted = int(blacklisted)  # type: ignore[attr-defined]
            if spares is not None:
                self._httpd.spare_count = int(spares)  # type: ignore[attr-defined]
            if ranks is not None:
                self._httpd.world_ranks = int(ranks)  # type: ignore[attr-defined]

    def record_policy_action(self, action: str) -> None:
        """Count one self-healing action into the scrape's
        ``hvd_policy_decisions_total{action}``."""
        with self._httpd.lock:  # type: ignore[attr-defined]
            counts = self._httpd.policy_actions  # type: ignore[attr-defined]
            counts[action] = counts.get(action, 0) + 1

    # -- warm spares and preemption notices ----------------------------------

    def _scope_records(self, scope: str) -> dict[str, dict]:
        with self._httpd.lock:  # type: ignore[attr-defined]
            raw = dict(self._httpd.store.get(scope, {}))  # type: ignore[attr-defined]
        out: dict[str, dict] = {}
        for key, body in raw.items():
            try:
                rec = json.loads(body)
            except (ValueError, UnicodeDecodeError):
                rec = {}
            out[key] = rec if isinstance(rec, dict) else {}
        return out

    def spare_records(self) -> dict[str, dict]:
        """The warm spares that registered (``PUT /spare/<worker>``)."""
        return self._scope_records(SPARE_SCOPE)

    def clear_spare(self, name: str) -> None:
        """Drop a spare's registration (promotion, or its teardown)."""
        with self._httpd.lock:  # type: ignore[attr-defined]
            self._httpd.store.get(SPARE_SCOPE, {}).pop(name, None)  # type: ignore[attr-defined]

    def preempt_notices(self) -> dict[str, dict]:
        """Outstanding preemption notices by host (``PUT
        /preempt/<host>``)."""
        return self._scope_records(PREEMPT_SCOPE)

    def consume_preempt(self, host: str) -> None:
        """Drop a handled notice, so the drain fires once."""
        with self._httpd.lock:  # type: ignore[attr-defined]
            self._httpd.store.get(PREEMPT_SCOPE, {}).pop(host, None)  # type: ignore[attr-defined]

    # -- the integrity plane -------------------------------------------------

    def heartbeat_version(self) -> int:
        """The heartbeat store's mutation count (every heartbeat PUT and
        ``clear_heartbeat``): pollers skip a re-parse when it is
        unchanged."""
        return self._httpd.hb_version  # type: ignore[attr-defined]

    def integrity_records(self) -> dict[int, dict]:
        """The fingerprints the heartbeats carry, by rank."""
        return _integrity_records(self._httpd)

    def integrity_vote_cached(self):
        """(records, voted) through the cache shared with the live-vote
        fence and ``GET /integrity``."""
        return _cached_integrity_vote(self._httpd)

    def integrity_summary(self) -> dict:
        """What ``GET /integrity`` serves, rendered in-process."""
        return _render_integrity(self._httpd)

    def record_integrity_divergence(self, host: str) -> None:
        """Count one vote against ``host`` into the scrape's
        ``hvd_integrity_divergence_total{host}``."""
        with self._httpd.lock:  # type: ignore[attr-defined]
            counts = self._httpd.integrity_divergence  # type: ignore[attr-defined]
            counts[host] = counts.get(host, 0) + 1

    def quarantine_rank(self, rank, host: str, generation: int,
                        step: int, from_generation: int | None = None,
                        from_step: int | None = None) -> None:
        """Fence a divergent rank's replica PUTs and evict its current
        ``peerstate`` record (the corrupt shard); its ``.prev`` slots stay,
        so assembly falls back a commit. ``generation``/``step`` are the
        vote's group (the fence lifts on a write of a strictly newer
        generation); ``from_generation``/``from_step`` (default: the
        same) start the condemned range, earlier when the vote back-dated
        the corruption to the outlier's previous fingerprint."""
        with self._httpd.lock:  # type: ignore[attr-defined]
            self._httpd.integrity_quarantine[str(rank)] = {  # type: ignore[attr-defined]
                "host": str(host),
                "generation": int(generation),
                "step": int(step),
                "from_generation": int(generation if from_generation is None
                                       else from_generation),
                "from_step": int(step if from_step is None else from_step),
                "t": time.time(),
            }
            self._httpd.store.get(  # type: ignore[attr-defined]
                PEERSTATE_SCOPE, {}).pop(str(rank), None)

    def quarantine_export(self) -> dict:
        """The quarantine map (tombstones included) for the driver's
        snapshot, so a successor's server fences the same ranks."""
        with self._httpd.lock:  # type: ignore[attr-defined]
            return {r: dict(e) for r, e in
                    self._httpd.integrity_quarantine.items()}  # type: ignore[attr-defined]

    def restore_quarantine(self, entries) -> None:
        if not isinstance(entries, dict):
            return
        with self._httpd.lock:  # type: ignore[attr-defined]
            for r, e in entries.items():
                if isinstance(e, dict):
                    self._httpd.integrity_quarantine[str(r)] = dict(e)  # type: ignore[attr-defined]

    def regression_suspects(self) -> dict[str, float]:
        """The regression sentinel's {worker: excess seconds} suspects,
        non-empty only while a phase's baseline is in alarm: the policy's
        ``step_regression`` channel. Ticks the cached analysis first."""
        try:
            _cluster_attribution(self._httpd)
        except Exception:  # noqa: BLE001 — an advisory channel
            pass
        with self._httpd.lock:  # type: ignore[attr-defined]
            return dict(self._httpd.regression_suspects)  # type: ignore[attr-defined]

    def metrics_text(self) -> str:
        """The scrape body, rendered in-process (what ``GET /metrics``
        serves over HTTP)."""
        return _render_cluster_metrics(self._httpd)

    def timeline_json(self) -> dict:
        """The merged cross-rank Chrome trace (what ``GET /timeline``
        serves), rendered in-process."""
        return _render_timeline(self._httpd)

    def criticalpath_summary(self, steps: int | None = None,
                             rank: str | None = None) -> dict:
        """The merged step attribution (what ``GET /criticalpath``
        serves), rendered in-process."""
        return _render_criticalpath(self._httpd, steps=steps, rank=rank)

    def straggler_summary(self) -> dict:
        """The arrival-skew attribution (what ``GET /stragglers``
        serves), rendered in-process."""
        return _compute_cluster_skew(self._httpd)[0]

    def comms_summary(self) -> dict:
        """The cluster-merged alpha-beta link cost model (what ``GET
        /comms`` serves), rendered in-process. Its ``"residuals"`` map
        (host -> worst predicted-vs-observed residual seconds) is the
        reference's second straggler-evidence channel."""
        return _render_comms(self._httpd)

    def memory_summary(self) -> dict:
        """The cluster-merged device-memory breakdown (what ``GET
        /memory`` serves), rendered in-process: per-rank resident bytes by
        kind, phase watermark maxes, the minimum headroom ratio and the
        worst model drift."""
        return _render_memory(self._httpd)

    def trace_payload(self, host: str) -> dict | None:
        """The last trace payload a worker shipped, parsed, or None."""
        return _trace_payloads(self._httpd).get(host)

    def done_records(self) -> dict[str, dict]:
        """The completion records, by worker name."""
        with self._httpd.lock:  # type: ignore[attr-defined]
            raw = dict(self._httpd.store.get(DONE_SCOPE, {}))  # type: ignore[attr-defined]
        out = {}
        for name, body in raw.items():
            try:
                out[name] = json.loads(body)
            except ValueError:
                out[name] = {}
        return out

    def start(self) -> int:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="hvd-rendezvous", daemon=True
        )
        self._thread.start()
        return self.port

    def publish_epoch(self, scope_prefix: str, data: dict[str, bytes],
                      keep_epochs: int = 2) -> int:
        """Atomically publish a new epoch: write ``<scope_prefix>/<v+1>``
        first, THEN bump the version — in-flight readers of the previous
        epoch keep seeing their scope (the last ``keep_epochs`` are kept)."""
        with self._httpd.lock:  # type: ignore[attr-defined]
            version = self._httpd.version + 1  # type: ignore[attr-defined]
            store = self._httpd.store  # type: ignore[attr-defined]
            store[f"{scope_prefix}/{version}"] = dict(data)
            stale = version - keep_epochs
            if stale > 0:
                store.pop(f"{scope_prefix}/{stale}", None)
            self._httpd.version = version  # type: ignore[attr-defined]
            return version

    # -- coordinated abort plane --------------------------------------------

    def post_abort(self, reason: str, generation: int | None = None) -> int:
        """Post the abort record for a world generation (default: the
        current one), BEFORE the driver bumps the generation so survivors
        still at the dying generation see it. Returns the generation."""
        record = json.dumps({"reason": reason, "time": time.time()}).encode()
        with self._httpd.lock:  # type: ignore[attr-defined]
            gen = (self._httpd.version  # type: ignore[attr-defined]
                   if generation is None else generation)
            self._httpd.store.setdefault(  # type: ignore[attr-defined]
                ABORT_SCOPE, {})[str(gen)] = record
        return gen

    def close_generation(self, reason: str) -> int:
        """Mark the current generation as closing (``closing/<g>``): the
        driver is about to publish the next world (it drains a host, or
        aborts this world), and a worker re-joining waits for that one
        instead of forming a group of the closing generation with peers
        that are leaving it. Returns the generation."""
        record = json.dumps({"reason": reason, "time": time.time()}).encode()
        with self._httpd.lock:  # type: ignore[attr-defined]
            gen = self._httpd.version  # type: ignore[attr-defined]
            self._httpd.store.setdefault(  # type: ignore[attr-defined]
                CLOSING_SCOPE, {})[str(gen)] = record
        return gen

    def abort_record(self, generation: int) -> bytes | None:
        with self._httpd.lock:  # type: ignore[attr-defined]
            return self._httpd.store.get(  # type: ignore[attr-defined]
                ABORT_SCOPE, {}).get(str(generation))

    # -- heartbeat liveness plane -------------------------------------------

    def heartbeat_ages(self) -> dict[str, float]:
        """Seconds since each worker's last heartbeat (server clock)."""
        now = time.monotonic()
        with self._httpd.lock:  # type: ignore[attr-defined]
            return {h: now - t
                    for h, t in self._httpd.hb_times.items()}  # type: ignore[attr-defined]

    def heartbeat_age(self, name: str) -> float | None:
        """Seconds since ``name``'s last heartbeat, or None if never seen."""
        with self._httpd.lock:  # type: ignore[attr-defined]
            t = self._httpd.hb_times.get(name)  # type: ignore[attr-defined]
        return None if t is None else time.monotonic() - t

    def heartbeat_payload(self, name: str) -> bytes | None:
        """The worker's last heartbeat body (JSON: step/commit counters)."""
        with self._httpd.lock:  # type: ignore[attr-defined]
            return self._httpd.store.get(  # type: ignore[attr-defined]
                HEARTBEAT_SCOPE, {}).get(name)

    def clear_heartbeat(self, name: str) -> None:
        """Forget a worker's liveness record (relaunch/removal): a stale
        timestamp must neither mask a hung relaunch nor instantly condemn
        a fresh one. Its trace payload goes too: a departed rank's spans
        must not skew the merged timeline against the re-formed world."""
        with self._httpd.lock:  # type: ignore[attr-defined]
            self._httpd.hb_times.pop(name, None)  # type: ignore[attr-defined]
            self._httpd.store.get(  # type: ignore[attr-defined]
                HEARTBEAT_SCOPE, {}).pop(name, None)
            self._httpd.store.get(  # type: ignore[attr-defined]
                TRACE_SCOPE, {}).pop(name, None)
            self._httpd.trace_version += 1  # type: ignore[attr-defined]
            # Its fingerprint left the record set: no vote over it.
            self._httpd.hb_version += 1  # type: ignore[attr-defined]

    def stop(self) -> None:
        self._httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5)
        self._httpd.server_close()


class KVClient:
    """Worker-side client for the rendezvous KV server. Signs every
    request with the job secret when HOROVOD_SECRET_KEY is set.

    Every request retries transient transport failures with bounded
    exponential backoff + jitter (``HOROVOD_KV_RETRIES`` attempts, base
    ``HOROVOD_KV_RETRY_BACKOFF`` seconds); HTTP status answers (404 = no
    value, 403 = bad auth, 409 = fenced stale-generation write) are
    answers, not blips, and propagate at once.

    ``generation_fn`` (elastic workers pass their live world-generation
    view) stamps every write with ``X-Hvd-Generation`` so the server's
    fence can reject zombies from a pre-abort world; ``epoch_fn`` stamps
    ``X-Hvd-Driver-Epoch`` likewise. ``None`` (or a fn returning ``None``)
    leaves writes unfenced.
    """

    def __init__(self, addr: str, port: int, timeout: float = 10.0,
                 retries: int | None = None, backoff: float | None = None,
                 generation_fn: Callable[[], int | None] | None = None,
                 epoch_fn: Callable[[], int | None] | None = None):
        self._base = f"http://{addr}:{port}"
        self._timeout = timeout
        self._retries = (get_int("HOROVOD_KV_RETRIES", 3)
                         if retries is None else retries)
        self._backoff = (get_float("HOROVOD_KV_RETRY_BACKOFF", 0.1)
                         if backoff is None else backoff)
        self._generation_fn = generation_fn
        self._epoch_fn = epoch_fn

    def _request(self, method: str, path: str, body: bytes | None = None):
        def attempt():
            if faults.fire(faults.KV_REQUEST):
                # drop: the request never happened — to the caller that is
                # a transport failure, so surface it as one (and retry).
                raise faults.InjectedFault(f"kv request dropped: {path}")
            req = Request(f"{self._base}{path}", data=body, method=method)
            tag = _secret.sign(_auth_payload(method, path, body or b""))
            if tag:
                req.add_header(AUTH_HEADER, tag)
            if self._generation_fn is not None and method in ("PUT",
                                                              "DELETE"):
                gen = self._generation_fn()
                if gen is not None:
                    if faults.fire(faults.KV_FENCE):
                        # Chaos: impersonate a zombie from the pre-abort
                        # world — the server must 409 this write.
                        gen -= 1
                    req.add_header(GENERATION_HEADER, str(gen))
            if self._epoch_fn is not None and method in ("PUT", "DELETE"):
                epoch = self._epoch_fn()
                if epoch is not None:
                    req.add_header(DRIVER_EPOCH_HEADER, str(epoch))
            return urlopen(req, timeout=self._timeout)

        return call_with_retries(
            attempt,
            attempts=max(1, self._retries),
            base_delay=self._backoff,
            give_up_on=(HTTPError,),
        )

    def put(self, scope: str, key: str, value: bytes) -> bytes:
        """Write one key; returns the reply body (heartbeat PUTs carry
        the server's wall clock there)."""
        with self._request("PUT", f"/{scope}/{key}", value) as r:
            return r.read()

    def get(self, scope: str, key: str) -> bytes | None:
        try:
            with self._request("GET", f"/{scope}/{key}") as r:
                return r.read()
        except HTTPError as e:
            if e.code == 404:
                return None
            raise

    def integrity_view(self) -> dict:
        """``GET /integrity`` (no HMAC): the fingerprints, the live vote
        and the quarantine map, which peer-replica assembly reads so that
        a condemned rank's records leave its local pool too."""
        with self._request("GET", "/integrity") as r:
            return json.loads(r.read().decode())

    def keys(self, scope: str) -> list[str]:
        with self._request("GET", f"/_scope/{scope}") as r:
            body = r.read().decode()
        return [k for k in body.split("\n") if k]

    def delete_scope(self, scope: str) -> None:
        with self._request("DELETE", f"/{scope}"):
            pass

    def world_version(self) -> int:
        with self._request("GET", "/_version") as r:
            return int(r.read())

    def driver_epoch(self) -> int:
        """The serving driver's epoch (``GET /_epoch``; 0 when the driver
        keeps no control-plane state)."""
        with self._request("GET", "/_epoch") as r:
            return int(r.read())

    def abort_posted(self, generation: int) -> dict | None:
        """The abort record for a world generation, or None. Decoded JSON
        (``{"reason", "time", ...}``); raw text falls back to a dict."""
        raw = self.get(ABORT_SCOPE, str(generation))
        if raw is None:
            return None
        try:
            return json.loads(raw)
        except ValueError:
            return {"reason": raw.decode(errors="replace")}
