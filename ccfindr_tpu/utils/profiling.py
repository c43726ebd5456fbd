"""Tracing / profiling utilities.

The reference's only runtime visibility is leveled verbose printing
(R/bayesian.R:349-351); here structured per-phase timings are recorded
into SCSet.metadata and a jax.profiler trace context is provided for
device-level analysis (SURVEY.md §5 tracing item).
"""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a jax.profiler trace (view with TensorBoard/XProf)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timings:
    """Lightweight phase timer; accumulates (name, seconds, extras)."""

    def __init__(self):
        self.records: list[dict] = []

    @contextlib.contextmanager
    def phase(self, name: str, **extras):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records.append(
                dict(name=name, seconds=time.perf_counter() - t0,
                     **extras))

    def summary(self) -> list[dict]:
        out = []
        for rec in self.records:
            d = dict(rec)
            sweeps = d.get("total_sweeps")
            if sweeps:
                d["sweeps_per_sec"] = sweeps / d["seconds"]
            out.append(d)
        return out
