"""Arithmetic that several metric files share, each over the run's record
(``harness.record_for_readers``). A metric file documents what its metric
means and binds ``read`` to one of these, or reads the record itself."""

from __future__ import annotations


def rate_msps(rec: dict) -> float:
    """Input samples of every call completed in the window (calls x
    channels x samples a channel) over the window's wall time, in millions
    a second."""
    return rec["calls"] * rec["channels"] * rec["samples"] / rec["window_s"] / 1e6


def drained_call_ms(rec: dict):
    """The mean of a closed loop's ``issue_drained`` spans, in ms: the host's
    time in a call into the entry point, the device drained before it;
    None where there are none (an untraced run)."""
    spans = rec["spans"].of("issue_drained")
    if not spans or rec["traffic"]["loop"] != "closed":
        return None
    return sum(spans) / len(spans) * 1e3


def idle_share(rec: dict):
    """1 - busy / length of the traced stretch, in %; None untraced."""
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
