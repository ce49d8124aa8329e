"""Read ingestion: summarize + event filtering in worker processes (a copy
of nanocall_tpu/ingest.py), and event-detection data from arrays in
memory.

The per-read host work (h5py parsing, abasic/hairpin island detection, event
filtering, initial moment-matching scaling — Fast5_Summary.hpp:138-319) is
GIL-bound numpy/h5py, so it runs in fork()ed worker processes, and results
stream back in file order so the EM driver consumes them as they arrive.
The pool must be forked while the process is still single-threaded, before
anything initialises CUDA: the CLI calls ensure_pool() first.

`ed_from_arrays` builds the EdEventData that a fast5 file would give, so a
machine without h5py can feed read_pipeline.summarize_ed, and through it
the pipeline, the same (summary, per-strand events) stream.
"""

from __future__ import annotations

import collections
import logging
import os

import numpy as np

from . import fast5_io, read_pipeline

log = logging.getLogger("nanocall")

_executor = None
_executor_workers = 0

# files per task: large enough to amortize the (models, cfg) pickle per
# task, small enough to stream results back promptly
_CHUNK = 8


def auto_workers() -> int:
    n = os.cpu_count() or 1
    return max(1, min(n - 1, 6))


def _resolve_workers(workers: int) -> int:
    return auto_workers() if workers < 0 else workers


def _get_executor(workers: int):
    global _executor, _executor_workers
    if _executor is not None and _executor_workers == workers:
        return _executor
    if _executor is not None:
        _executor.shutdown(wait=False, cancel_futures=True)
        _executor = None
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    _executor = ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("fork")
    )
    _executor_workers = workers
    return _executor


def _discard_executor() -> None:
    """Drop a failed pool so the next ingest_stream rebuilds it instead of
    getting the same broken executor back from the cache."""
    global _executor, _executor_workers
    if _executor is not None:
        _executor.shutdown(wait=False, cancel_futures=True)
    _executor = None
    _executor_workers = 0


def ensure_pool(workers: int = -1) -> None:
    """Fork the pool's workers now, while the process is still
    single-threaded (call before anything initialises CUDA)."""
    workers = _resolve_workers(workers)
    if workers > 1:
        try:
            pool = _get_executor(workers)
            # ProcessPoolExecutor forks workers lazily at first submit(),
            # not at construction: run one trivial task per worker and
            # wait, so every worker process exists before we return
            list(pool.map(_warm_task, range(workers)))
        except Exception as e:  # pool is an optimization, never fatal
            log.warning("ingest pool pre-create failed (%s)", e)
            _discard_executor()


def _warm_task(_i):
    """Trivial picklable task used to force eager worker fork (ensure_pool)."""
    return os.getpid()


def _worker_chunk(paths, models, cfg):
    return [
        read_pipeline.summarize(p, models, cfg, return_events=True)
        for p in paths
    ]


def ingest_stream(files, models, cfg):
    """Yield (summary, per-strand events) per fast5 file, in file order.

    With cfg.ingest_workers > 1 (default: auto), files are summarized by a
    persistent fork pool; any pool failure falls back to in-process
    ingestion for the remaining files (per-read errors never surface here —
    summarize catches them and returns num_ed_events == 0, matching
    Fast5_Summary.hpp:311-315 semantics)."""
    workers = _resolve_workers(cfg.ingest_workers)
    if workers <= 1 or len(files) <= _CHUNK:
        for p in files:
            yield read_pipeline.summarize(p, models, cfg, return_events=True)
        return
    chunks = [files[i : i + _CHUNK] for i in range(0, len(files), _CHUNK)]
    done = 0
    # bounded in-flight window: enough chunks to keep every worker busy
    # while the consumer drains, without buffering the whole dataset's
    # event arrays in parent RAM
    window = workers * 4
    next_ci = 0
    futs: "collections.deque" = collections.deque()
    try:
        pool = _get_executor(workers)
        while next_ci < len(chunks) and len(futs) < window:
            futs.append(pool.submit(_worker_chunk, chunks[next_ci], models, cfg))
            next_ci += 1
    except Exception as e:
        log.warning("ingest pool unavailable (%s); ingesting in-process", e)
        _discard_executor()
        futs.clear()
        next_ci = len(chunks)
    while futs:
        fut = futs.popleft()
        try:
            results = fut.result()
        except Exception as e:
            log.warning(
                "ingest pool failed (%s); ingesting remaining %d files "
                "in-process", e, len(files) - done,
            )
            for f2 in futs:
                f2.cancel()
            _discard_executor()
            futs.clear()
            break
        del fut  # release the Future's result reference promptly
        try:
            while next_ci < len(chunks) and len(futs) < window:
                futs.append(
                    pool.submit(_worker_chunk, chunks[next_ci], models, cfg)
                )
                next_ci += 1
        except Exception as e:
            log.warning(
                "ingest submit failed (%s); finishing in-process", e
            )
            _discard_executor()
            next_ci = len(chunks)
        for r in results:
            done += 1
            yield r
    for p in files[done:]:
        yield read_pipeline.summarize(p, models, cfg, return_events=True)


def shutdown() -> None:
    """Tear down the worker pool (tests / process exit hygiene)."""
    _discard_executor()


def ed_from_arrays(mean, stdv, start, length, sampling_rate: float,
                   read_id: str = "") -> fast5_io.EdEventData:
    """EdEventData as fast5_io.Fast5File reads back a file that holds these
    events: float64 mean/stdv, and start/length stored as int64 sample
    counts."""
    return fast5_io.EdEventData(
        read_id=read_id, sampling_rate=float(sampling_rate),
        mean=np.asarray(mean, np.float64), stdv=np.asarray(stdv, np.float64),
        start=np.asarray(start).astype(np.int64).astype(np.float64),
        length=np.asarray(length).astype(np.int64).astype(np.float64),
    )
