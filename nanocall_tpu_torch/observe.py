"""Observability: log levels, per-read context, stage timing, progress (a
copy of nanocall_tpu/observe.py without its JAX profiling helpers).

The reference logs `training user_cpu_secs=` / `basecalling user_cpu_secs=`
(nanocall.cpp:580-581,867-868) and prints `Processed N reads in S seconds`
progress from its thread pool (nanocall.cpp:576-579,862-866).  This module
provides the equivalents.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import sys
import threading
import time

log = logging.getLogger("nanocall")

# hpptools logger levels (logger.hpp, used via --log; nanocall.cpp:911-912):
# error > warning > info > debug > debug1 > debug2.  debug1/debug2 map to
# custom python levels below DEBUG so `--log debug2` reveals more than
# `--log debug`.
DEBUG1 = 9
DEBUG2 = 8
logging.addLevelName(DEBUG1, "DEBUG1")
logging.addLevelName(DEBUG2, "DEBUG2")
LOG_LEVELS = {
    "error": logging.ERROR,
    "warning": logging.WARNING,
    "info": logging.INFO,
    "debug": logging.DEBUG,
    "debug1": DEBUG1,
    "debug2": DEBUG2,
}


def set_levels_from_options(specs, default=logging.INFO) -> int:
    """Reference --log semantics (Logger::set_levels_from_options,
    nanocall.cpp:911-912): each spec is either `<level>` (sets the default
    level) or `<facility>:<level>` (sets that facility's logger only, e.g.
    `--log Fast5_Summary:debug`).  Returns the default level; facility
    loggers are configured as a side effect."""
    root_level = default
    for spec in specs:
        if ":" in spec:
            fac, _, lvl = spec.partition(":")
            if lvl not in LOG_LEVELS:
                raise SystemExit(f"unknown log level: {lvl!r} (in {spec!r})")
            logging.getLogger(fac).setLevel(LOG_LEVELS[lvl])
        else:
            if spec not in LOG_LEVELS:
                raise SystemExit(f"unknown log level: {spec!r}")
            root_level = LOG_LEVELS[spec]
    return root_level


# -- per-read failure context (global_assert.hpp:21-25) ---------------------
#
# The reference keeps a thread-local context string ("processing read X")
# that ASSERT prints on failure (set per work item, nanocall.cpp:295,624).
# Here: a contextvar set around each read's host-side work; any exception
# escaping the block gets the context attached as a __notes__ line.

_read_ctx: contextvars.ContextVar[str] = contextvars.ContextVar(
    "read_ctx", default=""
)


@contextlib.contextmanager
def read_context(read_id: str):
    """Tag this thread's work with a read id; exceptions escaping the block
    carry `processing read [<id>]` as an exception note (the reference's
    global_assert thread-local message, global_assert.hpp:21-25)."""
    token = _read_ctx.set(read_id)
    try:
        yield
    except Exception as e:
        if hasattr(e, "add_note"):  # PEP 678, python >= 3.11
            e.add_note(f"processing read [{read_id}]")
        raise
    finally:
        _read_ctx.reset(token)


class StageTimer:
    """Wall + process-CPU timing per pipeline stage."""

    def __init__(self):
        self.stages: dict[str, dict] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        w0, c0 = time.time(), time.process_time()
        try:
            yield
        finally:
            rec = self.stages.setdefault(name, {"wall_s": 0.0, "cpu_s": 0.0})
            rec["wall_s"] += time.time() - w0
            rec["cpu_s"] += time.process_time() - c0
            log.info(
                "%s wall_secs=%.1f user_cpu_secs=%.1f",
                name, rec["wall_s"], rec["cpu_s"],
            )

    def summary(self) -> dict:
        return dict(self.stages)


class Progress:
    """Counter with periodic stderr reporting, matching the reference's
    `Processed N reads in S seconds` lines."""

    def __init__(self, what: str = "reads", interval_s: float = 2.0,
                 stream=None):
        self.what = what
        self.interval_s = interval_s
        self.count = 0
        self.t0 = time.time()
        self._last = 0.0
        self.stream = stream if stream is not None else sys.stderr
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._lock:  # count AND interval check: two threads passing
            # the check together would emit interleaved lines
            self.count += n
            now = time.time()
            if now - self._last < self.interval_s:
                return
            self._last = now
            count = self.count
        self.stream.write(
            f"Processed {count:6d} {self.what} in "
            f"{int(now - self.t0):6d} seconds\r"
        )
        self.stream.flush()

    def finish(self) -> None:
        self.stream.write(
            f"Processed {self.count:6d} {self.what} in "
            f"{int(time.time() - self.t0):6d} seconds\n"
        )
        self.stream.flush()
