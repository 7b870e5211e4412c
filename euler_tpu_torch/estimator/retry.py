"""Which input failures the train loop retries (copy of
euler_tpu/graph/remote.py:retryable_error, :93-102, and its transport
markers; the port imports nothing of euler_tpu).

The reference also retries an EngineError whose message carries one of
the transport markers below (a shard that dropped or refused a call).
The port has no graph engine yet, so no EngineError: the markers come
into use with the engine binding (ROADMAP.md Queue A, 'Engine
binding'). Until then the rule is the exception's type alone.
"""

from __future__ import annotations

# copy of euler_tpu/graph/remote.py:_TRANSPORT_MARKERS: error-text
# markers of transport-level faults (a dead or restarting shard, an
# injected chaos fault, a timed-out attempt, a deadline shed, a stale
# ownership map). Deliberately narrow: semantic errors never match.
TRANSPORT_MARKERS = (
    "failed after retries",
    "timeout",
    "timed out",
    "connection reset",
    "reset by peer",
    "connection refused",
    "broken pipe",
    "unavailable",
    "chaos:",
    "deadline shed",
    "stale ownership map",
)


def retryable_error(exc: BaseException) -> bool:
    """True when the failure is transport-shaped (worth retrying against
    the same or a re-resolved endpoint); False for semantic errors that
    would fail identically on every attempt."""
    return isinstance(exc, (ConnectionError, TimeoutError))
