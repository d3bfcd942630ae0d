"""Pre-flight cluster probe: per-host NIC discovery + interface intersection.

Port of ``horovod_tpu/runner/driver_service.py`` (a copy: the JAX package's
module is stdlib-only, but importing it would import jax). Parity:
``horovod/runner/driver/driver_service.py`` (``_driver_fn`` — start a task
service on every host, collect each host's network interfaces, compute the
common routable set) + ``common/service/task_service.py``. The result picks
the address rank 0's TCP store advertises: on multi-NIC GPU hosts
(InfiniBand or a fast Ethernet beside a management network) the first
routable address is not always the mutually reachable one.

Task services speak HMAC-authenticated HTTP (``runner.secret``).
"""

from __future__ import annotations

import ipaddress
import json
import socket
import subprocess
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.request import Request, urlopen

from . import secret as _secret

AUTH_HEADER = "X-Hvd-Auth"


def list_interfaces() -> list[dict]:
    """This host's up, non-loopback IPv4 interfaces:
    ``[{name, address, prefixlen}]``. Prefers ``ip -j addr`` (iproute2);
    falls back to the resolver's single primary address."""
    try:
        out = subprocess.run(
            ["ip", "-j", "addr"], capture_output=True, timeout=5, check=True
        ).stdout
        result = []
        for link in json.loads(out):
            if "LOOPBACK" in link.get("flags", []):
                continue
            if link.get("operstate") not in ("UP", "UNKNOWN"):
                continue
            for addr in link.get("addr_info", []):
                if addr.get("family") != "inet":
                    continue
                result.append({
                    "name": link.get("ifname", "?"),
                    "address": addr["local"],
                    "prefixlen": int(addr.get("prefixlen", 32)),
                })
        if result:
            return result
    except Exception:
        pass
    try:
        addr = socket.gethostbyname(socket.gethostname())
        return [{"name": "default", "address": addr, "prefixlen": 24}]
    except OSError:
        return []


def common_routable_interfaces(
    per_host: dict[str, list[dict]],
) -> tuple[list[str], dict[str, str]]:
    """Intersect hosts' interface networks.

    Returns ``(common_network_cidrs, {host: address_on_first_common})`` —
    the networks present on EVERY host, and each host's address on the
    first (most specific) one. Raises when no common network exists.
    """
    nets_per_host: dict[str, dict] = {}
    for host, ifaces in per_host.items():
        nets = {}
        for i in ifaces:
            net = ipaddress.ip_network(
                f"{i['address']}/{i['prefixlen']}", strict=False
            )
            nets[str(net)] = i["address"]
        nets_per_host[host] = nets
    if not nets_per_host:
        raise ValueError("no hosts probed")
    common = set.intersection(*[set(n) for n in nets_per_host.values()])
    if not common:
        raise RuntimeError(
            "no common network across hosts; interfaces per host: "
            + json.dumps({h: sorted(n) for h, n in nets_per_host.items()})
        )
    ordered = sorted(
        common, key=lambda c: -ipaddress.ip_network(c).prefixlen
    )
    first = ordered[0]
    return ordered, {h: nets_per_host[h][first] for h in nets_per_host}


class _TaskHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: D102
        pass

    def do_GET(self):  # noqa: N802
        tag = self.headers.get(AUTH_HEADER, "")
        body_sig = b"GET\n" + self.path.encode() + b"\n"
        if not _secret.verify(body_sig, tag,
                              key=self.server.secret):  # type: ignore[attr-defined]
            return self._reply(403, b"bad auth tag")
        if self.path == "/interfaces":
            return self._reply(
                200, json.dumps(list_interfaces()).encode()
            )
        if self.path == "/ping":
            return self._reply(200, b"pong")
        self._reply(404, b"")

    def _reply(self, code: int, body: bytes):
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class TaskService:
    """Per-host probe responder (parity: HorovodRunTaskService)."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        self._httpd = ThreadingHTTPServer((host, port), _TaskHandler)
        self._httpd.secret = _secret.current_key()  # type: ignore[attr-defined]
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> int:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="hvd-task-svc", daemon=True
        )
        self._thread.start()
        return self.port

    def stop(self) -> None:
        self._httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5)
        self._httpd.server_close()


def _signed_get(base: str, path: str, timeout: float = 10.0) -> bytes:
    req = Request(f"{base}{path}")
    tag = _secret.sign(b"GET\n" + path.encode() + b"\n")
    if tag:
        req.add_header(AUTH_HEADER, tag)
    with urlopen(req, timeout=timeout) as r:
        return r.read()


def probe_host(addr: str, port: int, timeout: float = 10.0) -> list[dict]:
    """Ask one task service for its interfaces."""
    return json.loads(_signed_get(f"http://{addr}:{port}", "/interfaces",
                                  timeout))


def probe_cluster(
    endpoints: dict[str, tuple[str, int]], timeout: float = 10.0,
) -> tuple[list[str], dict[str, str]]:
    """Probe every host's task service and intersect.

    ``endpoints``: {hostname: (reachable_addr, task_service_port)}.
    Returns ``common_routable_interfaces`` of the collected views.
    """
    views = {
        host: probe_host(addr, port, timeout)
        for host, (addr, port) in endpoints.items()
    }
    return common_routable_interfaces(views)
