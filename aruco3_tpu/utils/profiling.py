"""Tracing / profiling helpers (aux subsystem, SURVEY §5).

The reference's only observability is Instant-based timing in an example
(reference examples/webcam_kamera.rs:55-58) and a commented flamegraph
profile.  Here:

  * ``StageTimer`` — host-clock stage timing that waits for the device
    with ``jax.block_until_ready``.
  * ``trace`` — context manager around ``jax.profiler`` writing a
    TensorBoard-compatible trace directory; profiler failures raise.
  * ``device_op_times`` — per-op device time summed from such a trace.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import os
import time

import jax


class StageTimer:
    """Accumulates per-stage wall times; ``report()`` pretty-prints."""

    def __init__(self):
        self.totals = collections.defaultdict(float)
        self.counts = collections.defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def time_fn(self, name: str, fn, *args, iters: int = 1):
        """Mean seconds of ``fn(*args)`` over ``iters`` calls, after one
        untimed warm-up call; waits for the device at both ends."""
        out = jax.block_until_ready(fn(*args))
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        self.totals[name] += (time.perf_counter() - t0) / iters
        self.counts[name] += 1
        return out

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name:32s} {t * 1000:9.2f} ms total  x{n}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``jax.profiler`` trace of the block into ``log_dir``."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def _op_lines(plane):
    """The lines of a device plane whose events are the executed ops: the
    per-op line when the profiler wrote one, else the stream lines."""
    lines = list(plane.lines)
    ops = [ln for ln in lines if ln.name == "XLA Ops"]
    return ops or [ln for ln in lines if ln.name.startswith("Stream")]


def device_op_times(log_dir: str) -> dict[str, float]:
    """{op name: summed device nanoseconds} over every accelerator plane
    of the newest trace under ``log_dir`` (empty when it has none)."""
    paths = glob.glob(
        os.path.join(log_dir, "plugins", "profile", "*", "*.xplane.pb")
    )
    if not paths:
        raise FileNotFoundError(f"no profiler trace under {log_dir}")
    data = jax.profiler.ProfileData.from_file(max(paths, key=os.path.getmtime))
    totals = collections.Counter()
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in _op_lines(plane):
            for ev in line.events:
                totals[ev.name] += ev.duration_ns
    return dict(totals)
