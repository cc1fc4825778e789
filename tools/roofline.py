"""Scan-chained timing: device time per iteration of a chained step.

``timeit_scan`` compiles ONE program that runs a step n times under
``lax.scan`` with a data dependence through the carry (so XLA cannot batch,
elide, or reorder the iterations), times it at two lengths, and reports the
slope ``(t(n2) - t(n1)) / (n2 - n1)``: per-dispatch overhead and the
one-time program costs cancel.
"""

from __future__ import annotations

import functools
import time

import jax


def _walltime(fn, *args, reps: int = 3) -> float:
    """Best-of-reps wall time of one already-compiled call."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


class SubResolutionError(RuntimeError):
    """timeit_scan could not obtain a slope above the timing-resolution
    floor — distinct from generic RuntimeError so callers dropping
    sub-resolution samples (bench.py) cannot accidentally swallow real
    device/transport failures (XlaRuntimeError etc.)."""


def timeit_scan(
    step,
    x0,
    n1: int = 4,
    n2: int = 36,
    reps: int = 5,
    min_delta_s: float = 8e-3,
    max_n2: int = 1 << 14,
    retries: int = 3,
) -> float:
    """Per-iteration seconds of ``step`` chained through a lax.scan carry.

    ``step: x -> x`` (same pytree structure/shapes). Returns the slope of
    wall time between scan lengths n1 and n2 — per-dispatch overhead and
    the one-time program costs cancel. Auto-calibrates: grows n2 until the
    wall-time delta is at least ``min_delta_s`` so host-clock jitter stays
    below a few percent of the measurement.

    Resolution guard: jitter can push ``t(n2) - t(n1)`` below — or even
    under — the timing resolution, producing a bogus (possibly negative)
    slope.
    A slope is only accepted when it clears a floor of 5% of
    ``min_delta_s / (n2 - n1)``; otherwise the measurement window is
    doubled and retried, and after ``retries`` failures this RAISES
    instead of returning a sub-resolution number, so no caller can ever
    publish a negative time.
    """

    @functools.partial(jax.jit, static_argnames="n")
    def run(x, n):
        def body(c, _):
            return step(c), None

        out, _ = jax.lax.scan(body, x, None, length=n)
        return out

    jax.block_until_ready(run(x0, n1))  # compile once per length
    slope = float("nan")
    for _attempt in range(retries + 1):
        while True:
            jax.block_until_ready(run(x0, n2))
            t1 = _walltime(run, x0, n1, reps=reps)
            t2 = _walltime(run, x0, n2, reps=reps)
            delta = t2 - t1
            if delta >= min_delta_s or n2 >= max_n2:
                break
            est = max(delta / (n2 - n1), 1e-7)
            n2 = min(max_n2, max(n2 * 4, n1 + int(min_delta_s / est)))
        slope = delta / (n2 - n1)
        floor = 0.05 * min_delta_s / (n2 - n1)
        if slope > floor:
            return slope
        # Sub-resolution measurement: GENUINELY widen the window — the
        # capped exit above means n2 == max_n2 here, so max_n2 must grow
        # for the retry to measure a longer program (a real slope's delta
        # then doubles while the floor, fixed by min_delta_s, halves
        # relative to it).
        max_n2 *= 2
        n2 = min(max_n2, n2 * 2)
    raise SubResolutionError(
        f"timeit_scan: slope {slope:.3e} s/iter stayed below the timing "
        f"resolution floor after {retries} widened retries (n2={n2}, "
        f"min_delta_s={min_delta_s}) — refusing to publish a "
        "sub-resolution (possibly negative) time"
    )
