"""The selector's candidate-skip seam and the failure records of save and
load (the port's copy of the parts of ``transmogrifai_tpu/resilience.py`` it
uses: ``FailureLog``, ``record_failure`` and ``AllCandidatesFailed``).

A candidate family that cannot fit the feature matrix (a tree family on a
``SparseMatrix``) is skipped by the validator: its (fold x grid) block gets
NaN metrics and one "skipped" event here, and the sweep goes on.  The
selector raises ``AllCandidatesFailed`` only when no candidate is left.

Unlike the JAX package there is no ambient, process-global log: the
validator owns one ``FailureLog`` per ``validate`` call and hands it to the
``SelectedModel`` it builds (``failure_log``), and ``WorkflowModel.save`` /
``load`` record into the model's ``failure_log``: what a save dropped
("swallowed", ≙ stages/serialization.py:67-91) and what a load did without
("degraded", ≙ workflow.py:816-931).  Retries and fault injection are not
ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

# the exceptions of a candidate fit that mean "this family cannot fit this
# matrix" (≙ the skip at transmogrifai_tpu/tuning.py:1395-1407): anything
# else still raises
SKIPPABLE = (NotImplementedError, TypeError)


class AllCandidatesFailed(RuntimeError):
    """Every (model x grid-point) candidate of a selector sweep failed;
    carries the per-candidate causes."""

    def __init__(self, message: str, causes: Optional[Dict[str, str]] = None):
        self.causes = dict(causes or {})
        if self.causes:
            detail = "; ".join(f"{k}: {v}" for k, v in
                               sorted(self.causes.items()))
            message = f"{message} — per-candidate causes: {detail}"
        super().__init__(message)


class FailureEvent(NamedTuple):
    """One skipped, dropped or degraded unit of work."""

    stage: str                  # model name, stage uid or subsystem
    action: str                 # one of FailureLog.ACTIONS
    cause: str                  # "ExcType: message", or the message
    detail: Dict[str, Any]      # e.g. the folds and grid points


class FailureLog:
    """The record of one sweep's skipped work (≙ ``record_failure``,
    resilience.py:247, with the log passed instead of read from the ambient
    stack)."""

    ACTIONS = ("skipped",      # unit of work abandoned, sweep continues
               "degraded",     # loaded without an optional part
               "swallowed")    # best-effort side work failed (dropped)

    def __init__(self):
        self.events: List[FailureEvent] = []

    def record(self, stage: str, action: str, cause: Any = None,
               **detail) -> None:
        if action not in self.ACTIONS:
            raise ValueError(f"unknown failure action {action!r}; "
                             f"expected one of {self.ACTIONS}")
        if isinstance(cause, BaseException):
            cause = f"{type(cause).__name__}: {cause}"
        self.events.append(FailureEvent(
            stage, action, "" if cause is None else str(cause), detail))

    def by_action(self, action: str) -> List[FailureEvent]:
        return [e for e in self.events if e.action == action]


def record_failure(log: Optional[FailureLog], stage: str, action: str,
                   cause: Any = None, **detail) -> None:
    """Record into ``log`` (≙ ``record_failure``, resilience.py:247, with the
    log passed instead of read from the ambient stack); no log, no
    record."""
    if log is not None:
        log.record(stage, action, cause, **detail)
