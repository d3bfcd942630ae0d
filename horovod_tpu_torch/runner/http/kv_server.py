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

Not ported yet: the ``modelstate`` scope (with ``serving.py``), the
integrity quarantine and the live-vote fence of ``peerstate`` writes
(with ``integrity.py``).

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
from urllib.request import Request, urlopen

from ... import faults
from ... import peercheck as _peercheck
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
            if rejected is None:
                if scope == PEERSTATE_SCOPE:
                    rotate_slots(
                        self.server.store.setdefault(scope, {}),  # type: ignore[attr-defined]
                        key, body, prev_suffix=_peercheck.PREV_SUFFIX,
                        depth=_peercheck.retention_depth())
                else:
                    self.server.store.setdefault(scope, {})[key] = body  # type: ignore[attr-defined]
                if scope == HEARTBEAT_SCOPE:
                    self.server.hb_times[key] = time.monotonic()  # type: ignore[attr-defined]
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

    def abort_record(self, generation: int) -> bytes | None:
        with self._httpd.lock:  # type: ignore[attr-defined]
            return self._httpd.store.get(  # type: ignore[attr-defined]
                ABORT_SCOPE, {}).get(str(generation))

    # -- heartbeat liveness plane -------------------------------------------

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
        a fresh one."""
        with self._httpd.lock:  # type: ignore[attr-defined]
            self._httpd.hb_times.pop(name, None)  # type: ignore[attr-defined]
            self._httpd.store.get(  # type: ignore[attr-defined]
                HEARTBEAT_SCOPE, {}).pop(name, None)

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
