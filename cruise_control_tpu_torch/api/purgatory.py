"""Two-step verification purgatory for POST requests (port of
cruise_control_tpu/api/purgatory.py).

Reference CC/servlet/purgatory/Purgatory.java:1-280 + the wiki's
2-step-verification doc: when enabled, mutating POSTs are parked as
review requests; an admin approves or discards them through REVIEW, and an
approved request executes when re-submitted with its review id.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import threading
import time as _time
from typing import Callable, Dict, List, Optional


class ReviewStatus(enum.Enum):
    PENDING_REVIEW = "PENDING_REVIEW"
    APPROVED = "APPROVED"
    SUBMITTED = "SUBMITTED"
    DISCARDED = "DISCARDED"


@dataclasses.dataclass
class ReviewRequest:
    review_id: int
    endpoint: str
    query: str
    submitter: str
    status: ReviewStatus
    submitted_ms: float
    reason: str = ""
    status_update_ms: float = 0.0

    def to_json(self) -> dict:
        return {
            "Id": self.review_id,
            "EndPoint": self.endpoint,
            "RequestURL": f"{self.endpoint}?{self.query}" if self.query
                          else self.endpoint,
            "SubmitterAddress": self.submitter,
            "Status": self.status.value,
            "SubmissionTimeMs": self.submitted_ms,
            "Reason": self.reason,
        }


class Purgatory:
    def __init__(self, retention_s: float = 7 * 24 * 3600.0,
                 max_requests: Optional[int] = None,
                 time_fn: Optional[Callable[[], float]] = None) -> None:
        self._retention_s = retention_s
        #: cap on parked requests (reference two.step.purgatory.max.requests)
        self._max_requests = max_requests
        self._time = time_fn or _time.time
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._requests: Dict[int, ReviewRequest] = {}

    def submit(self, endpoint: str, query: str, submitter: str
               ) -> ReviewRequest:
        now_ms = self._time() * 1000.0
        with self._lock:
            self._expire(now_ms)
            if self._max_requests is not None:
                pending = sum(1 for r in self._requests.values()
                              if r.status == ReviewStatus.PENDING_REVIEW)
                if pending >= self._max_requests:
                    raise ValueError(
                        f"purgatory full: {pending} pending requests "
                        f"(two.step.purgatory.max.requests="
                        f"{self._max_requests})")
            rid = next(self._ids)
            req = ReviewRequest(rid, endpoint, query, submitter,
                                ReviewStatus.PENDING_REVIEW, now_ms)
            self._requests[rid] = req
            return req

    def review(self, approve_ids: List[int], discard_ids: List[int],
               reason: str = "") -> List[ReviewRequest]:
        now_ms = self._time() * 1000.0
        with self._lock:
            overlap = set(approve_ids) & set(discard_ids)
            if overlap:
                raise ValueError(f"ids both approved and discarded: "
                                 f"{sorted(overlap)}")
            out = []
            for rid, status in (
                    [(i, ReviewStatus.APPROVED) for i in approve_ids]
                    + [(i, ReviewStatus.DISCARDED) for i in discard_ids]):
                req = self._requests.get(rid)
                if req is None:
                    raise KeyError(f"unknown review id {rid}")
                if req.status not in (ReviewStatus.PENDING_REVIEW,
                                      ReviewStatus.APPROVED):
                    raise ValueError(
                        f"review {rid} is {req.status.value}; cannot change")
                req.status = status
                req.reason = reason
                req.status_update_ms = now_ms
                out.append(req)
            return out

    @staticmethod
    def _canonical_query(query: str) -> List:
        """Query params sorted, with review_id stripped — the approval is
        bound to exactly what was reviewed."""
        import urllib.parse
        pairs = urllib.parse.parse_qsl(query, keep_blank_values=True)
        return sorted((k, v) for k, v in pairs if k.lower() != "review_id")

    def take_approved(self, review_id: int, endpoint: str,
                      query: str = "") -> ReviewRequest:
        """Consume an approved request for execution (one shot).  The
        resubmission must match the reviewed endpoint AND parameters —
        otherwise an approved harmless request could authorize an arbitrary
        mutation."""
        with self._lock:
            req = self._requests.get(review_id)
            if req is None:
                raise KeyError(f"unknown review id {review_id}")
            if req.endpoint != endpoint:
                raise ValueError(
                    f"review {review_id} is for {req.endpoint}, "
                    f"not {endpoint}")
            if self._canonical_query(req.query) \
                    != self._canonical_query(query):
                raise ValueError(
                    f"review {review_id} was approved for different "
                    f"parameters ({req.query!r})")
            if req.status != ReviewStatus.APPROVED:
                raise ValueError(
                    f"review {review_id} is {req.status.value}, "
                    f"not APPROVED")
            req.status = ReviewStatus.SUBMITTED
            req.status_update_ms = self._time() * 1000.0
            return req

    def re_arm(self, review_id: int) -> None:
        """Roll a consumed (SUBMITTED) approval back to APPROVED because
        the submission was rejected at the scheduler's queue cap — the
        reviewed operation never executed, so burning the one-shot
        approval would turn documented backpressure ("retry later") into
        a permanent failure.  One execution per approval still holds:
        only the request that consumed the approval re-arms it, and only
        when the solve was never admitted."""
        with self._lock:
            req = self._requests.get(review_id)
            if req is not None and req.status == ReviewStatus.SUBMITTED:
                req.status = ReviewStatus.APPROVED
                req.status_update_ms = self._time() * 1000.0

    def all_requests(self, review_ids: Optional[List[int]] = None
                     ) -> List[ReviewRequest]:
        with self._lock:
            self._expire(self._time() * 1000.0)
            reqs = self._requests.values()
            if review_ids is not None:
                reqs = [r for r in reqs if r.review_id in set(review_ids)]
            return sorted(reqs, key=lambda r: r.review_id)

    def _expire(self, now_ms: float) -> None:
        cutoff = now_ms - self._retention_s * 1000.0
        for rid in [rid for rid, r in self._requests.items()
                    if r.submitted_ms < cutoff]:
            del self._requests[rid]
