"""Shared retry/backoff policy — own copy of ``kubeflow_tpu/utils/retry.py``
(the parts the pod wire rides): exponential backoff, full jitter, deadline.

The jitter formula is AWS "full jitter" (sleep = U(0, min(cap, base *
mult^attempt))); `jitter` scales it continuously down to 0 for
deterministic schedules.

  - ``policy.delay_for(attempt, rng)``   — pure: compute the Nth delay
  - ``retry_call(fn, ...)``              — retry `fn` on listed exceptions
  - ``poll_until(fn, ...)``              — poll `fn` until it returns non-None
  - ``backoff_sleep(policy, attempt)``   — one jittered, deadline-clamped
                                           pause inside a hand-written loop
  - ``hinted_sleep(hint_s, ...)``        — honor a server's Retry-After hint
                                           within the caller's budget

Chaos drills pass a seeded ``random.Random`` as `rng` so injected-fault
schedules stay reproducible; production callers default to the
module-level generator.
"""

from __future__ import annotations

import math
import random
import time
from dataclasses import dataclass
from typing import Any, Callable


@dataclass(frozen=True)
class BackoffPolicy:
    """Exponential backoff with bounded full jitter and optional budgets.

    base_s / max_s / multiplier: classic exponential ramp, capped.
    jitter: 0.0 = deterministic cap, 1.0 = full jitter U(0, cap).
    max_attempts: total call budget for retry_call (None = unbounded).
    deadline_s: wall-clock budget from the first attempt (None = unbounded).
    """

    base_s: float = 0.02
    max_s: float = 1.0
    multiplier: float = 2.0
    jitter: float = 1.0
    max_attempts: int | None = None
    deadline_s: float | None = None

    def cap_for(self, attempt: int) -> float:
        """Un-jittered delay ceiling for the Nth retry (attempt 0 = first).

        The ramp saturates at max_s; the exponent is clamped BEFORE
        evaluation because `multiplier ** attempt` overflows a float for
        attempt ~1024 — and long-lived poll loops legitimately reach
        unbounded attempt counts."""
        if self.base_s <= 0.0:
            return 0.0  # degenerate no-wait policy (and log() needs base > 0)
        if self.base_s >= self.max_s:
            return self.max_s
        if self.multiplier > 1.0:
            # smallest n with base * m**n >= max: beyond it, the answer
            # is max_s without ever computing the power
            saturated = math.log(self.max_s / self.base_s, self.multiplier)
            if attempt >= saturated:
                return self.max_s
        return min(self.max_s, self.base_s * self.multiplier ** attempt)

    def delay_for(self, attempt: int,
                  rng: random.Random | None = None) -> float:
        cap = self.cap_for(attempt)
        if self.jitter <= 0.0:
            return cap
        r = rng if rng is not None else random
        return cap * (1.0 - self.jitter) + r.uniform(0.0, cap * self.jitter)


#: optimistic-concurrency writes: fast first retry, bounded total attempts
#: (a conflict storm must surface as an error, not an infinite spin)
CONFLICT_POLICY = BackoffPolicy(
    base_s=0.005, max_s=0.2, multiplier=2.0, jitter=1.0, max_attempts=12
)

#: status polling: starts responsive, backs off to a gentle steady-state
#: poll. Half jitter keeps a fleet of waiters from phase-locking.
POLL_POLICY = BackoffPolicy(
    base_s=0.02, max_s=0.25, multiplier=2.0, jitter=0.5
)


class Deadline:
    """Monotonic-clock deadline; `None` timeout means 'never expires'."""

    def __init__(self, timeout_s: float | None):
        self.timeout_s = timeout_s
        self._t0 = time.monotonic()

    def expired(self) -> bool:
        rem = self.remaining()
        return rem is not None and rem <= 0.0

    def remaining(self, floor: float | None = None) -> float | None:
        """Seconds left (clamped at `floor` if given); None = unbounded."""
        if self.timeout_s is None:
            return None
        rem = self.timeout_s - (time.monotonic() - self._t0)
        return rem if floor is None else max(floor, rem)


def retry_call(
    fn: Callable[[], Any],
    *,
    policy: BackoffPolicy = CONFLICT_POLICY,
    retry_on: tuple[type[BaseException], ...] = (Exception,),
    rng: random.Random | None = None,
) -> Any:
    """Call `fn` until it returns, retrying `retry_on` exceptions under
    `policy`. Exhausting max_attempts — or a deadline_s the next sleep
    would overshoot — re-raises the LAST exception: the retry layer must
    never replace the real failure."""
    deadline = Deadline(policy.deadline_s)
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on:
            if policy.max_attempts is not None \
                    and attempt + 1 >= policy.max_attempts:
                raise
            delay = policy.delay_for(attempt, rng)
            rem = deadline.remaining()
            if rem is not None and delay >= rem:
                raise
            time.sleep(delay)
            attempt += 1


def poll_until(
    fn: Callable[[], Any],
    *,
    timeout_s: float | None,
    policy: BackoffPolicy = POLL_POLICY,
    rng: random.Random | None = None,
    describe: str = "condition",
) -> Any:
    """Poll `fn` until it returns non-None; jittered-backoff sleeps between
    polls; TimeoutError after `timeout_s`. The final poll happens AT the
    deadline, so a condition that became true during the last sleep is
    still returned rather than timed out."""
    deadline = Deadline(timeout_s)
    attempt = 0
    while True:
        out = fn()
        if out is not None:
            return out
        rem = deadline.remaining()
        if rem is not None and rem <= 0.0:
            raise TimeoutError(f"{describe} not met within {timeout_s}s")
        delay = policy.delay_for(attempt, rng)
        if rem is not None:
            delay = min(delay, rem)
        time.sleep(max(delay, 0.0))
        attempt += 1


def backoff_sleep(
    policy: BackoffPolicy,
    attempt: int,
    *,
    deadline: Deadline | None = None,
    rng: random.Random | None = None,
) -> float:
    """One pause inside a hand-written poll loop (a loop that cannot be
    shaped as poll_until because each iteration does real work): sleeps
    the policy's jittered delay for `attempt`, clamped to the deadline's
    remaining budget. Returns the seconds actually slept (0.0 when the
    deadline is already spent)."""
    delay = policy.delay_for(attempt, rng)
    if deadline is not None:
        rem = deadline.remaining()
        if rem is not None:
            delay = min(delay, max(rem, 0.0))
    if delay > 0.0:
        time.sleep(delay)
    return delay


def hinted_sleep(
    hint_s: float,
    *,
    cap_s: float | None = None,
    deadline: Deadline | None = None,
) -> bool:
    """Honor a server-advertised wait (Retry-After) within the caller's
    budget: sleep min(hint, cap) unless that would overshoot the
    deadline. Returns True when the wait was taken (caller re-dials) and
    False when it would overshoot (caller surfaces the error now instead
    of parking past its own budget)."""
    delay = max(hint_s, 0.0)
    if cap_s is not None:
        delay = min(delay, cap_s)
    if deadline is not None:
        rem = deadline.remaining()
        if rem is not None and delay >= rem:
            return False
    time.sleep(delay)
    return True
