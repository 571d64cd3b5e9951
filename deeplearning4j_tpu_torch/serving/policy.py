"""Scheduler policy, from serving/policy.py: the `SchedulingPolicy`
admission decision point and the default `ColocatedPolicy`.

The engine consults `admit` when the head-of-queue block reservation fails.
Without a lifecycle manager (KV eviction is not ported yet) the colocated
policy denies with a hint and the request waits in FIFO order, exactly as
in the JAX package. The JAX policy's other decision points (route, evict,
transfer) serve replica groups and the radix tree, which are not ported.
Pure host bookkeeping: no device access.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

_MAX_BURN_BACKOFF = 10.0


def retry_after_from_burn(slack_s: float, burn: Optional[float]) -> float:
    """Deny-hint backoff (local copy of telemetry/alerts.py's): the
    admittee's remaining TTFT slack, stretched by 1 + min(burn, 10) when a
    burn-rate monitor reports an overload."""
    base = max(0.0, float(slack_s))
    if burn is None:
        return base
    b = float(burn)
    if not math.isfinite(b) or b <= 0.0:
        return base
    return base * (1.0 + min(b, _MAX_BURN_BACKOFF))


@dataclass
class AdmissionDecision:
    """Outcome of the ``admit`` decision point: "accept", "deny_with_hint"
    (hint: reclaimable_bytes, retry_after_s) or "preempt" (victims: an
    eviction plan)."""
    kind: str
    victims: Optional[dict] = None
    hint: Optional[dict] = None

    @classmethod
    def accept(cls) -> "AdmissionDecision":
        return cls("accept")

    @classmethod
    def deny(cls, hint: Optional[dict] = None) -> "AdmissionDecision":
        return cls("deny_with_hint", hint=hint)

    @classmethod
    def preempt(cls, plan: dict) -> "AdmissionDecision":
        return cls("preempt", victims=plan)


class SchedulingPolicy:
    """Base interface; the default decision is to wait (deny)."""

    def admit(self, request, pool_view: dict) -> AdmissionDecision:
        return AdmissionDecision.deny()


class ColocatedPolicy(SchedulingPolicy):
    """The default policy: every replica both prefills and decodes. On a
    failed reservation: deny-with-hint without a lifecycle manager, else
    plan-then-preempt, held back while an `slo` leaves TTFT slack."""

    def __init__(self, *, slo=None):
        self.slo = slo

    def admit(self, request, pool_view: dict) -> AdmissionDecision:
        lifecycle = pool_view.get("lifecycle")
        hint = {"reclaimable_bytes": pool_view.get("reclaimable_bytes", 0),
                "retry_after_s": 0.0}
        slack = 0.0
        if self.slo is not None and pool_view.get("now") is not None:
            slack = self.slo.slack_s(pool_view["now"]
                                     - pool_view["t_submit"])
            if slack > 0:
                hint["retry_after_s"] = retry_after_from_burn(
                    slack, pool_view.get("burn_rate_short"))
        if lifecycle is None or (self.slo is not None and slack > 0):
            return AdmissionDecision.deny(hint)
        shortfall = pool_view["shortfall"]
        eligible = pool_view["eligible"]
        if shortfall <= 0 or not eligible:
            return AdmissionDecision.deny(hint)
        plan = lifecycle.plan(pool_view["snapshot_fn"](), shortfall,
                              eligible=eligible)
        if not plan["evicted"] or not plan["satisfies"]:
            return AdmissionDecision.deny(hint)
        return AdmissionDecision.preempt(plan)
