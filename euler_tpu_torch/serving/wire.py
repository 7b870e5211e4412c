"""Serving wire protocol (copy of euler_tpu/serving/wire.py; the port
imports nothing of euler_tpu, and tests/test_torch_serving.py pins
the frames and entry names to the original, byte for byte): the
framed-TCP conventions of the graph service (euler_tpu/core/cc/rpc.cc),
spoken from Python.

Frame layout is byte-identical to the C++ stack's —
``u32 'ETFR' | u32 msg_type | u64 body_len | body`` (rpc.h:17) — so a
serving replica and a graph shard are the same kind of network citizen
(same framing, same registry, same proxy/chaos tooling applies).
Serving claims msg_type >= 100; the graph service owns 0..5, so a
serving frame hitting a graph shard (or vice versa) fails loudly as an
unknown type instead of misparsing.

Payloads are little-endian packed structs + raw numpy buffers (the
serde.h ByteWriter conventions: u32-length-prefixed strings, no
alignment padding) — same assumption the C++ engine already makes.

The registry half speaks the RegistryServer protocol (kRegPut /
kRegList / kRegRemove) and the shared-directory registry directly, so
serving replicas register and clients discover through the SAME
registry the graph shards use. A ``tcp:`` registry is the native
C++ RegistryService (euler_tpu/gql.py), which the port does not start
yet (ROADMAP.md Queue A, 'Engine binding'); the client calls below
speak to one all the same, and ``dir:`` registries need nothing else.
Serving entries are named
``serve_<service>_<shard>_<replica>__<host>_<port>`` — index shards
and replicas-per-shard are discoverable exactly like graph shards.
The pre-fleet two-field form (``serve_<service>_<replica>__...``)
still parses as shard 0, so a mixed-version fleet stays discoverable
during a rollout (caveat: that back-compat form is ambiguous for
service names ending in a numeric component; new entries always carry
the explicit shard field). The C++ shard parser only accepts the
``shard_`` prefix, so serving entries are invisible to graph-shard
discovery (and shard entries to serving discovery) by construction.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "MAGIC", "HEADER", "MSG_EMBED", "MSG_KNN", "MSG_SCORE", "MSG_HEALTH",
    "MSG_INFO", "MSG_SWAP", "MSG_KNN_VEC", "STATUS_OK", "STATUS_SHED",
    "STATUS_ERROR", "WireError",
    "read_frame", "write_frame", "pack_str", "Reader",
    "registry_put", "registry_remove", "registry_list",
    "serve_entry_name", "parse_serve_entry", "discover_replicas",
    "discover_fleet",
]

MAGIC = 0x52465445                     # b'ETFR' little-endian
HEADER = struct.Struct("<IIQ")         # magic | msg_type | body_len

# graph service owns 0..5 (kExecute..kRegRemove); serving starts at 100
MSG_EMBED = 100
MSG_KNN = 101
MSG_SCORE = 102
MSG_HEALTH = 103
MSG_INFO = 104
MSG_SWAP = 105                         # admin: hot-swap the served bundle
MSG_KNN_VEC = 106                      # knn by query VECTORS (fleet fan-out)

# registry verbs (rpc.cc MsgType)
_REG_PUT = 3
_REG_LIST = 4
_REG_REMOVE = 5
_REG_LIST_VERSION = 2

STATUS_OK = 0
STATUS_SHED = 1                        # explicit load-shed, never silent
STATUS_ERROR = 2

# matches the C++ ReadFrame sanity cap (8 GiB); a corrupt header must
# not allocate the moon
_MAX_BODY = 1 << 33


class WireError(ConnectionError):
    """Framing/transport failure on a serving connection. Subclasses
    ConnectionError so retryable_error() classifies it as transport-
    shaped without any string matching."""


def _recv_all(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise WireError("connection closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def write_frame(sock: socket.socket, msg_type: int, body: bytes) -> None:
    sock.sendall(HEADER.pack(MAGIC, msg_type, len(body)) + body)


def read_frame(sock: socket.socket) -> Tuple[int, bytes]:
    hdr = _recv_all(sock, HEADER.size)
    magic, msg_type, n = HEADER.unpack(hdr)
    if magic != MAGIC:
        raise WireError(f"bad frame magic 0x{magic:08x}")
    if n > _MAX_BODY:
        raise WireError(f"frame body {n} exceeds sanity cap")
    return msg_type, _recv_all(sock, n) if n else b""


def pack_str(s: str) -> bytes:
    """serde.h PutStr: u32 length + raw bytes."""
    b = s.encode()
    return struct.pack("<I", len(b)) + b


class Reader:
    """Cursor over a packed body (serde.h ByteReader shape)."""

    __slots__ = ("_b", "_o")

    def __init__(self, body: bytes):
        self._b = body
        self._o = 0

    def u8(self) -> int:
        return self._unpack("<B", 1)

    def u32(self) -> int:
        return self._unpack("<I", 4)

    def i64(self) -> int:
        return self._unpack("<q", 8)

    def u64(self) -> int:
        return self._unpack("<Q", 8)

    def f32(self) -> float:
        return self._unpack("<f", 4)

    def _unpack(self, fmt: str, size: int):
        if self._o + size > len(self._b):
            raise WireError("truncated body")
        v = struct.unpack_from(fmt, self._b, self._o)[0]
        self._o += size
        return v

    def str_(self) -> str:
        n = self.u32()
        if self._o + n > len(self._b):
            raise WireError("truncated string")
        s = self._b[self._o:self._o + n].decode()
        self._o += n
        return s

    def array(self, dtype, count: int) -> np.ndarray:
        dt = np.dtype(dtype)
        nbytes = dt.itemsize * count
        if self._o + nbytes > len(self._b):
            raise WireError("truncated array")
        a = np.frombuffer(self._b, dtype=dt, count=count, offset=self._o)
        self._o += nbytes
        return a.copy()  # body buffer is reused; results must own memory

    def remaining(self) -> int:
        return len(self._b) - self._o


# ---------------------------------------------------------------------------
# Registry access (same registry the graph shards heartbeat into)
# ---------------------------------------------------------------------------
def _split_tcp_spec(spec: str) -> Optional[Tuple[str, int]]:
    if not spec.startswith("tcp:"):
        return None
    rest = spec[4:]
    host, _, port = rest.rpartition(":")
    return (host, int(port)) if host else None


def _dir_of_spec(spec: str) -> str:
    return spec[4:] if spec.startswith("dir:") else spec


def _registry_call(host: str, port: int, msg_type: int, body: bytes,
                   timeout_s: float = 3.0) -> bytes:
    with socket.create_connection((host, port), timeout=timeout_s) as s:
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        write_frame(s, msg_type, body)
        reply_type, reply = read_frame(s)
        if reply_type != msg_type:
            raise WireError(
                f"registry replied type {reply_type} to {msg_type}")
        return reply


def registry_put(spec: str, name: str) -> None:
    """Store/refresh `name` in the registry (tcp: server or shared
    directory) — the heartbeat verb serving replicas repeat."""
    tcp = _split_tcp_spec(spec)
    if tcp:
        _registry_call(tcp[0], tcp[1], _REG_PUT, name.encode())
        return
    d = _dir_of_spec(spec)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, name)
    with open(path, "w"):
        pass
    os.utime(path, None)  # refresh mtime: directory-registry heartbeat


def registry_remove(spec: str, name: str) -> None:
    """Best-effort clean-shutdown unregister (a crash just goes stale,
    exactly like a shard entry)."""
    tcp = _split_tcp_spec(spec)
    try:
        if tcp:
            _registry_call(tcp[0], tcp[1], _REG_REMOVE, name.encode())
        else:
            os.remove(os.path.join(_dir_of_spec(spec), name))
    except (OSError, WireError):
        pass


def registry_list(spec: str) -> Dict[str, int]:
    """Every live entry name → age_ms. Unlike gql.scan_registry (which
    parses only shard_ entries through the C API), this returns the raw
    namespace so serving entries are visible."""
    tcp = _split_tcp_spec(spec)
    if tcp:
        reply = _registry_call(tcp[0], tcp[1], _REG_LIST, b"")
        r = Reader(reply)
        ver = r.u32()
        if ver != _REG_LIST_VERSION:
            raise WireError(f"registry list version {ver} != "
                            f"{_REG_LIST_VERSION}")
        out = {}
        for _ in range(r.u32()):
            name = r.str_()
            age_ms = r.i64()
            r.u64()  # put-sequence: unused here
            out[name] = age_ms
        return out
    d = _dir_of_spec(spec)
    out = {}
    try:
        names = os.listdir(d)
    except OSError:
        return out
    now = time.time()
    for name in names:
        try:
            mtime = os.stat(os.path.join(d, name)).st_mtime
        except OSError:
            continue  # entry removed between listdir and stat
        out[name] = int(max(now - mtime, 0.0) * 1000)
    return out


def serve_entry_name(service: str, shard: int, replica: int, host: str,
                     port: int) -> str:
    if "__" in service:
        raise ValueError(f"service name must not contain '__': {service!r}")
    return f"serve_{service}_{int(shard)}_{int(replica)}__{host}_{port}"


def parse_serve_entry(name: str
                      ) -> Optional[Tuple[str, int, int, str, int]]:
    """(service, shard, replica, host, port), or None for foreign
    entries (shard_ heartbeats share the namespace). The pre-fleet
    two-field form parses as shard 0."""
    if not name.startswith("serve_"):
        return None
    left, sep, right = name.partition("__")
    if not sep:
        return None
    parts = left[len("serve_"):].split("_")
    if len(parts) >= 3 and parts[-1].isdigit() and parts[-2].isdigit():
        svc = "_".join(parts[:-2])
        shard, rep = int(parts[-2]), int(parts[-1])
    elif len(parts) >= 2 and parts[-1].isdigit():
        svc = "_".join(parts[:-1])
        shard, rep = 0, int(parts[-1])
    else:
        return None
    host, _, port = right.rpartition("_")
    if not (svc and host and port.lstrip("-").isdigit()):
        return None
    return svc, shard, rep, host, int(port)


def discover_fleet(spec: str, service: str, max_age_ms: int = 0
                   ) -> Dict[int, List[Tuple[str, int, int]]]:
    """{shard -> [(host, port, age_ms)] sorted by replica index} for
    the service's registered fleet. max_age_ms > 0 drops stale entries
    (crashed replicas whose heartbeat stopped)."""
    fleet: Dict[int, List[Tuple[int, str, int, int]]] = {}
    for name, age in registry_list(spec).items():
        parsed = parse_serve_entry(name)
        if parsed is None or parsed[0] != service:
            continue
        if max_age_ms > 0 and age > max_age_ms:
            continue
        _, shard, rep, host, port = parsed
        fleet.setdefault(shard, []).append((rep, host, port, age))
    return {s: [(h, p, a) for _, h, p, a in sorted(v)]
            for s, v in sorted(fleet.items())}


def discover_replicas(spec: str, service: str, max_age_ms: int = 0,
                      shard: Optional[int] = None
                      ) -> List[Tuple[str, int, int]]:
    """[(host, port, age_ms)] of the service's registered replicas,
    sorted by (shard, replica) — or a single shard's replicas when
    `shard` is given."""
    fleet = discover_fleet(spec, service, max_age_ms=max_age_ms)
    if shard is not None:
        return fleet.get(shard, [])
    out: List[Tuple[str, int, int]] = []
    for s in sorted(fleet):
        out.extend(fleet[s])
    return out
