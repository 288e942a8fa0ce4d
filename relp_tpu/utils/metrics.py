"""Observability: timers, structured per-solve metrics, profiler hooks.

The reference has no tracing/metrics at all (SURVEY §5: "absent... only
println! in the CLI"); this is a new first-class subsystem here: every
solve produces a :class:`SolveMetrics` record, optional
structured logging is enabled with ``RELP_TPU_LOG=1``, and
:func:`device_trace` wraps ``jax.profiler`` for Perfetto/XPlane dumps.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from dataclasses import asdict, dataclass, field
from typing import Optional

logger = logging.getLogger("relp_tpu")
if os.environ.get("RELP_TPU_LOG"):
    # RELP_TPU_LOG=1 → INFO (per-chunk progress); RELP_TPU_LOG=debug →
    # DEBUG (adds per-device-call cost decomposition in the XL loop)
    _lvl = (
        logging.DEBUG
        if os.environ["RELP_TPU_LOG"].lower() in ("debug", "2")
        else logging.INFO
    )
    logging.basicConfig(level=_lvl, format="%(name)s %(message)s")


@dataclass
class SolveMetrics:
    """One device solve's worth of counters."""

    status: str = ""
    iterations: int = 0
    wall_s: float = 0.0
    m: int = 0
    n: int = 0
    m_padded: int = 0
    n_padded: int = 0
    art_residual: float = 0.0
    phase: int = 0
    nnz: int = 0              # nonzeros of the lowered A (sparse-cost model)
    matrix_format: str = ""   # device layout actually used ("dense"/"ell")
    # per-iteration stream aggregates (config.trace_iters; 0 when off)
    pivots: int = 0
    bound_flips: int = 0
    refresh_iters: int = 0
    bland_iters: int = 0
    degenerate_steps: int = 0
    # worst periodic in-loop invariant violation (config.check_every_n)
    check_violation: float = 0.0
    # in-loop primal refactorizations by path (simplex/core.State.refactors)
    refactor_polish: int = 0
    refactor_newton: int = 0
    refactor_gj: int = 0

    @property
    def iters_per_s(self) -> float:
        return self.iterations / self.wall_s if self.wall_s > 0 else 0.0

    def emit(self) -> None:
        if logger.isEnabledFor(logging.INFO):
            payload = asdict(self)
            payload["iters_per_s"] = round(self.iters_per_s, 2)
            logger.info("solve %s", json.dumps(payload))


class Timer:
    """Wall-clock context manager: ``with Timer() as t: ...; t.elapsed``."""

    def __enter__(self):
        self._t0 = time.perf_counter()
        self.elapsed = 0.0
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False

    def peek(self) -> float:
        """Elapsed time so far, while the context is still open."""
        return time.perf_counter() - self._t0


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Profile the enclosed device work with jax.profiler (Perfetto/XPlane
    dump under ``log_dir``); no-op when log_dir is falsy."""
    if not log_dir:
        yield
        return
    import jax

    with jax.profiler.trace(log_dir):
        yield
