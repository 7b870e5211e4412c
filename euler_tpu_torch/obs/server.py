"""Exposition endpoint: /metrics (Prometheus text) + /healthz (JSON)
on a stdlib http.server thread.

Copy of euler_tpu/obs/server.py (stdlib only); tests/test_torch_obs.py
pins it to the original.

The serving half of euler_tpu_torch.obs. `serve(port)` starts a daemon
ThreadingHTTPServer bound to localhost; `/metrics` renders the
registry's Prometheus text format (collectors run per scrape, so
engine-side gql/UDF-cache gauges are fresh), `/healthz` merges every
registered health provider — the existing `RemoteGraphEngine.health()`
/ `BaseEstimator.health()` dicts — into one JSON document.

Health providers register with `register_health(name, fn)`. Bound
methods are held via weakref.WeakMethod so registering an object's
health() does not keep the object alive; dead providers silently drop
off the next scrape.
"""

from __future__ import annotations

import json
import threading
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

__all__ = ["ObsServer", "register_health", "unregister_health",
           "health_snapshot"]

_health_mu = threading.Lock()
_health_providers: Dict[str, object] = {}


def register_health(name: str, fn: Callable[[], dict]) -> None:
    """Register `fn` (→ dict) under `name` on /healthz. Bound methods
    are weakly referenced; re-registering a name replaces it."""
    try:
        ref = weakref.WeakMethod(fn)
    except TypeError:  # plain function / lambda: hold it directly
        ref = None
    with _health_mu:
        _health_providers[name] = ref if ref is not None else fn


def unregister_health(name: str) -> None:
    with _health_mu:
        _health_providers.pop(name, None)


def health_snapshot() -> Dict[str, dict]:
    """{provider: health dict} for every live provider; a provider that
    raises reports {"error": ...} instead of failing the scrape."""
    with _health_mu:
        items = list(_health_providers.items())
    out, dead = {}, []
    for name, ref in items:
        fn = ref() if isinstance(ref, weakref.WeakMethod) else ref
        if fn is None:
            dead.append(name)
            continue
        try:
            out[name] = fn()
        except Exception as e:
            out[name] = {"error": f"{type(e).__name__}: {e}"}
    if dead:
        with _health_mu:
            for name in dead:
                if isinstance(_health_providers.get(name),
                              weakref.WeakMethod) \
                        and _health_providers[name]() is None:
                    _health_providers.pop(name, None)
    return out


class ObsServer:
    """The /metrics + /healthz endpoint. port=0 picks an ephemeral port
    (read it back from .port); close() shuts the thread down and frees
    the port — no leak, no port-in-use flake on restart."""

    def __init__(self, port: int = 0, registry=None,
                 addr: str = "127.0.0.1"):
        if registry is None:
            from euler_tpu_torch.obs import default_registry

            registry = default_registry()
        self.registry = registry

        srv = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = srv.registry.render_prometheus().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path == "/healthz":
                    body = json.dumps(
                        {"status": "ok",
                         "providers": health_snapshot()}).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404, "try /metrics or /healthz")
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # scrapes must not spam stderr
                pass

        self._httpd = ThreadingHTTPServer((addr, port), Handler)
        self._httpd.daemon_threads = True
        self.addr = addr
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            name=f"obs-serve-{self.port}", daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.addr}:{self.port}"

    def close(self) -> None:
        """Stop serving and release the port; joins the serve thread so
        a test can assert nothing leaked."""
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "ObsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
