"""Which failures are retried, and how (copy of euler_tpu/core/lib.py:252
`EngineError` and euler_tpu/graph/remote.py:93-102 `retryable_error` with
its transport markers, :370-412 `RetryDeadlineExceeded` and
`RetryPolicy`; the port imports nothing of euler_tpu).

Transport-shaped failures are worth another attempt: a ConnectionError
or TimeoutError, and an EngineError whose text carries one of the
transport markers below (a shard that dropped or refused a call, a
serving replica that shed). The train loop's input path and the serving
client (serving/client.py) both judge by this rule.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Optional


class EngineError(RuntimeError):
    """An error reported by a graph or serving engine."""


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
    if isinstance(exc, (ConnectionError, TimeoutError)):
        return True
    if not isinstance(exc, EngineError):
        return False
    msg = str(exc).lower()
    return any(m in msg for m in TRANSPORT_MARKERS)


class RetryDeadlineExceeded(EngineError):
    """A retryable call ran out of its deadline/attempt budget. Carries
    the last underlying error text."""


@dataclasses.dataclass
class RetryPolicy:
    """Backoff/deadline policy for remote calls.

    deadline_s: total per-call budget across retries (0 → one attempt).
    base_backoff_s / max_backoff_s: exponential backoff with FULL jitter —
      sleep ~ U(0, min(max_backoff_s, base_backoff_s * 2^(attempt-1))).
    call_timeout_s: per-attempt bound (the serving client's socket
      timeout); None/0 keeps blocking calls.
    max_attempts: hard attempt cap inside the deadline (0 → unlimited).
    """

    deadline_s: float = 30.0
    base_backoff_s: float = 0.05
    max_backoff_s: float = 2.0
    call_timeout_s: Optional[float] = None
    max_attempts: int = 0

    def backoff_s(self, attempt: int, rng: random.Random) -> float:
        """Full-jitter backoff for retry `attempt` (1-based)."""
        hi = min(self.max_backoff_s,
                 self.base_backoff_s * (2 ** max(attempt - 1, 0)))
        return rng.uniform(0.0, max(hi, 0.0))
