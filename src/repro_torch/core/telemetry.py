"""Telemetry hooks of the serving path, as no-ops.

The batcher calls these names at the points where the JAX package's
flight recorder opens and closes request spans.  Here they do nothing, and
the recorder only keeps a clock; the full flight recorder is ROADMAP
queue 1 item 9.
"""
from __future__ import annotations

import time


class NullRecorder:
    """A recorder that records nothing (``enabled`` is False)."""

    enabled = False

    def clock(self) -> float:
        return time.monotonic()

    def record(self, name: str, value: float):
        pass


DISABLED = NullRecorder()


def recorder_of(accounting) -> NullRecorder:
    """The recorder behind ``accounting``, or the shared no-op one."""
    return getattr(accounting, "recorder", None) or DISABLED


def open_request(rec, req, ts=None):
    pass


def mark_admitted(req, ts=None, **attrs):
    pass


def open_decode(rec, req, ts=None):
    pass


def migrate_decode(req, new_rec, ts=None):
    pass


def finish_request(req, ts=None, outcome: str = "ok"):
    pass


def span_group(rec, name: str, reqs, t0: float, t1: float, **attrs):
    pass
