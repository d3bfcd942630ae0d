"""Deterministic fault injection at named points of the control plane.

A copy of ``horovod_tpu/faults.py`` (``FaultSpec``, ``parse_spec``,
``_Registry``, ``fire``, ``flip_bits`` and the process helpers), cut to
the points the port's modules fire:

- ``kv.request``         — every rendezvous KV client request attempt
- ``kv.fence``           — every generation-fenced KV write; firing (drop
  semantics) makes the client send a STALE generation, impersonating a
  zombie worker from the pre-abort world
- ``kv.serve``           — every request the rendezvous KV server
  handles; firing (drop semantics) closes the connection unanswered
- ``discovery.poll``     — every ``HostManager.update_available_hosts`` poll
- ``worker.step``        — every stall-watched step or fetch
  (``stall.watch``); ``HOROVOD_FAULTS="worker.step=delay:1.5@1x999999"``
  makes a rank enter every watched step 1.5 s late: a straggler
- ``heartbeat.send``     — every worker heartbeat publish
- ``abort.poll``         — every coordinated-abort flag poll; drop/delay
  simulate delayed abort propagation
- ``checkpoint.save``    — every durable checkpoint write attempt
- ``checkpoint.restore`` — every durable checkpoint read/restore attempt
- ``peer.replicate``     — every peer-replica publish (``drop``/``raise``
  lose the replica; training goes on and the peer rung degrades)
- ``peer.verify``        — every replica checksum verification (firing
  fails it: the record is rejected as corrupt)
- ``peer.corrupt``       — the encoded replica blob on the wire
  (``corrupt`` flips bits after the digest is computed: the server's
  install-time verification must reject it)
- ``grad.corrupt``       — every elastic state commit's host snapshot
  (``corrupt[:nbits]`` flips seeded bits in the committed copy: a host
  that silently computed wrong answers, which only the cross-rank
  integrity vote of ``integrity.py`` can see)
- ``policy.decide``      — every self-healing policy evaluation of the
  elastic driver (``raise`` proves a broken policy cannot take the driver
  down; ``delay`` defers decisions)
- ``spare.promote``      — every warm-spare promotion into the world
  (``raise`` forces the cold-launch fallback)
- ``driver.snapshot``    — every control-plane snapshot save of the driver
- ``driver.takeover``    — a restarted driver's takeover from the snapshot
- ``comms.link``         — every comms-model observation of a measured
  collective (``delay`` inflates the observed latency: a degraded link)
- ``memory.pressure``    — every traced step's entry (``drop`` raises a
  synthetic out-of-memory error at the step boundary: the memory
  observatory's forensics dump it and re-raise)

Each point can be armed (via API or env) to **drop**, **delay**, **raise**,
or **hang** on the Nth hit, for a window of consecutive hits, so chaos
tests assert exact trajectories.

API::

    from horovod_tpu_torch import faults
    faults.inject("kv.request", "raise", at=3, count=2)  # 3rd+4th hit fail
    faults.fire("kv.request")   # called by the instrumented site

Env (reaches subprocess workers; parsed lazily on first ``fire``)::

    HOROVOD_FAULTS="kv.request=raise@3x2;heartbeat.send=drop@1x999"

Spec grammar: ``point=mode[:arg]@N[xC]`` — arm on the Nth hit (1-based,
default 1) for C consecutive hits (default 1); ``arg`` is seconds for
``delay``/``hang``, or the bit-flip count for ``corrupt`` (default 64).
Points are cheap no-ops when nothing is armed. ``corrupt`` acts only
through :func:`corrupt_payload`; at a plain :func:`fire` site it is a
no-op.

Process-level helpers (``suspend``/``resume``/``kill_process``/
``kill_driver``) wrap the signals subprocess chaos tests need: SIGSTOP
simulates a hung-but-alive host (invisible to ``popen.poll``), SIGKILL a
crashed one.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import signal
import threading
import time

ENV_SPEC = "HOROVOD_FAULTS"

# The injection-point names the port's call sites use.
KV_REQUEST = "kv.request"
KV_FENCE = "kv.fence"
KV_SERVE = "kv.serve"
DISCOVERY_POLL = "discovery.poll"
# Fired on every stall-watched step (``stall.watch``): ``delay`` makes one
# rank a straggler, ``hang`` wedges it.
WORKER_STEP = "worker.step"
HEARTBEAT_SEND = "heartbeat.send"
ABORT_POLL = "abort.poll"
CHECKPOINT_SAVE = "checkpoint.save"
CHECKPOINT_RESTORE = "checkpoint.restore"
PEER_REPLICATE = "peer.replicate"
PEER_VERIFY = "peer.verify"
PEER_CORRUPT = "peer.corrupt"
# The silent-data-corruption injector of the integrity plane: mutates a
# rank's committed state snapshot (its digests stay self-consistent, so
# only the cross-rank vote can see it).
GRAD_CORRUPT = "grad.corrupt"
# The elastic driver's self-healing policy evaluation and its warm-spare
# promotion.
POLICY_DECIDE = "policy.decide"
SPARE_PROMOTE = "spare.promote"
DRIVER_SNAPSHOT = "driver.snapshot"
DRIVER_TAKEOVER = "driver.takeover"
# Every comms-model observation of a measured collective
# (``comms_model.CommsModel.observe``): ``delay`` inflates the observed
# latency (a degraded link), ``drop`` loses the sample, never the op.
COMMS_LINK = "comms.link"
# Every traced step's entry (``parallel/data_parallel.py``): ``drop`` raises
# a synthetic out-of-memory error at the step boundary, which dumps the
# memory flight record and re-raises.
MEMORY_PRESSURE = "memory.pressure"

_MODES = ("drop", "delay", "raise", "hang", "corrupt")
_DEFAULT_HANG_S = 3600.0
_DEFAULT_DELAY_S = 0.1
_DEFAULT_CORRUPT_BITS = 64


class InjectedFault(OSError):
    """Raised by an armed ``raise`` fault.

    Subclasses OSError so every retry/backoff path treats it exactly like
    the transient I/O failure it impersonates.
    """


@dataclasses.dataclass
class FaultSpec:
    point: str
    mode: str                      # drop | delay | raise | hang | corrupt
    arg: float | None = None       # seconds for delay/hang, bits for corrupt
    at: int = 1                    # 1-based hit index the fault arms on
    count: int = 1                 # consecutive hits it stays armed for

    def armed_for(self, hit: int) -> bool:
        return self.at <= hit < self.at + self.count


def parse_spec(spec: str) -> list[FaultSpec]:
    """Parse the ``HOROVOD_FAULTS`` grammar; invalid entries raise."""
    out: list[FaultSpec] = []
    for entry in spec.replace(",", ";").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        point, _, rhs = entry.partition("=")
        if not rhs:
            raise ValueError(f"fault spec {entry!r}: missing '=mode'")
        mode_arg, _, window = rhs.partition("@")
        mode, _, arg = mode_arg.partition(":")
        if mode not in _MODES:
            raise ValueError(
                f"fault spec {entry!r}: unknown mode {mode!r} "
                f"(expected one of {_MODES})"
            )
        at, count = 1, 1
        if window:
            n, _, c = window.partition("x")
            at = int(n)
            count = int(c) if c else 1
        out.append(FaultSpec(
            point=point.strip(),
            mode=mode,
            arg=float(arg) if arg else None,
            at=at,
            count=count,
        ))
    return out


class _Registry:
    """Armed faults + per-point hit/fire counters (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._specs: dict[str, FaultSpec] = {}
        self._hits: dict[str, int] = {}
        self._fired: dict[str, int] = {}
        self._env_loaded = False

    def _load_env_locked(self) -> None:
        if self._env_loaded:
            return
        self._env_loaded = True
        spec = os.environ.get(ENV_SPEC, "")
        if not spec:
            return
        for s in parse_spec(spec):
            # API-armed faults win over the env (tests layer on top).
            self._specs.setdefault(s.point, s)

    def inject(self, point: str, mode: str, arg: float | None = None,
               at: int = 1, count: int = 1) -> None:
        if mode not in _MODES:
            raise ValueError(f"unknown fault mode {mode!r}")
        with self._lock:
            self._specs[point] = FaultSpec(point, mode, arg, at, count)
            self._hits.pop(point, None)
            self._fired.pop(point, None)

    def clear(self, point: str) -> None:
        with self._lock:
            self._specs.pop(point, None)

    def reset(self) -> None:
        """Drop every armed fault and counter; re-read env on next fire."""
        with self._lock:
            self._specs.clear()
            self._hits.clear()
            self._fired.clear()
            self._env_loaded = False

    def hits(self, point: str) -> int:
        with self._lock:
            return self._hits.get(point, 0)

    def fired(self, point: str) -> int:
        with self._lock:
            return self._fired.get(point, 0)

    def active(self) -> dict[str, FaultSpec]:
        with self._lock:
            self._load_env_locked()
            return dict(self._specs)

    def armed(self, point: str) -> bool:
        """Armed at all (any mode, any window); counts no hit."""
        with self._lock:
            self._load_env_locked()
            return point in self._specs

    def _take_hit(self, point: str) -> tuple[FaultSpec | None, int]:
        """Count one hit; return (armed spec or None, hit index)."""
        with self._lock:
            self._load_env_locked()
            hit = self._hits.get(point, 0) + 1
            self._hits[point] = hit  # counted even unarmed: tests assert
            spec = self._specs.get(point)  # exact attempt trajectories
            if spec is None or not spec.armed_for(hit):
                return None, hit
            self._fired[point] = self._fired.get(point, 0) + 1
            return spec, hit

    def fire(self, point: str) -> bool:
        """One hit at an injection point.

        Returns True when the caller must DROP the operation (skip it with
        that call site's drop semantics), False to proceed. ``delay``/
        ``hang`` sleep here then proceed; ``raise`` raises InjectedFault;
        ``corrupt`` is a no-op here (it only acts through
        :func:`corrupt_payload`).
        """
        spec, hit = self._take_hit(point)
        if spec is None:
            return False
        # Actions run OUTSIDE the lock (sleeps must not serialize peers).
        if spec.mode == "drop":
            return True
        if spec.mode == "corrupt":
            return False
        self._side_action(spec, point, hit)
        return False

    @staticmethod
    def _side_action(spec: FaultSpec, point: str, hit: int) -> None:
        """The delay/hang/raise action shared by :func:`fire` and
        :func:`corrupt_payload`; other modes are a no-op here."""
        if spec.mode == "delay":
            time.sleep(spec.arg if spec.arg is not None else _DEFAULT_DELAY_S)
        elif spec.mode == "hang":
            time.sleep(spec.arg if spec.arg is not None else _DEFAULT_HANG_S)
        elif spec.mode == "raise":
            raise InjectedFault(f"injected fault at {point!r} (hit {hit})")

    def corrupt_payload(self, point: str, data: bytes) -> bytes:
        """One hit at a payload-mutating injection point: with a
        ``corrupt`` spec armed for this hit, ``data`` with ``arg`` (default
        64) seeded bit flips; other armed modes keep their :func:`fire`
        semantics; unarmed, ``data`` untouched."""
        spec, hit = self._take_hit(point)
        if spec is None:
            return data
        if spec.mode != "corrupt":
            self._side_action(spec, point, hit)
            return data
        return flip_bits(
            data,
            nbits=(int(spec.arg) if spec.arg is not None
                   else _DEFAULT_CORRUPT_BITS),
            seed=f"{point}#{hit}")


def flip_bits(data: bytes, nbits: int, seed: str) -> bytes:
    """Flip ``nbits`` deterministically seeded bit positions of ``data``
    (with replacement: an even number of hits on one bit cancels). The
    positions come from sha256 of the seed, extended counter-mode, so the
    same (payload length, nbits, seed) flips the same bits everywhere."""
    if not data or nbits <= 0:
        return data
    buf = bytearray(data)
    total_bits = len(buf) * 8
    stream = b""
    counter = 0
    positions: list[int] = []
    while len(positions) < nbits:
        if len(stream) < 8:
            stream += hashlib.sha256(
                f"{seed}:{counter}".encode()).digest()
            counter += 1
        pos = int.from_bytes(stream[:8], "big") % total_bits
        stream = stream[8:]
        positions.append(pos)
    for pos in positions:
        buf[pos // 8] ^= 1 << (pos % 8)
    return bytes(buf)


_registry = _Registry()

# Module-level facade — what call sites and tests use.
inject = _registry.inject
clear = _registry.clear
reset = _registry.reset
hits = _registry.hits
fired = _registry.fired
active = _registry.active
fire = _registry.fire
armed = _registry.armed
corrupt_payload = _registry.corrupt_payload


# -- process-level chaos helpers (subprocess tests) --------------------------

def suspend(pid: int) -> None:
    """SIGSTOP a process: hung-but-alive, the hang ``popen.poll`` cannot
    see — only the heartbeat liveness plane catches it."""
    os.kill(pid, signal.SIGSTOP)


def resume(pid: int) -> None:
    os.kill(pid, signal.SIGCONT)


def kill_process(pid: int, sig: int = signal.SIGKILL) -> None:
    os.kill(pid, sig)


def self_suspend() -> None:
    """A worker SIGSTOPs itself: a hung host at an exact step."""
    os.kill(os.getpid(), signal.SIGSTOP)


def kill_driver(pid: int) -> None:
    """SIGKILL the elastic driver: its rendezvous server dies mid-request
    with no cleanup, and its workers, in sessions of their own, live on as
    orphans until a relaunched driver takes over from the durable snapshot
    (``runner/elastic/driver_state.py``). The signal is
    :func:`kill_process`'s; the name says what a test kills."""
    os.kill(pid, signal.SIGKILL)
