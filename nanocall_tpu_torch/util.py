"""Small host-side utilities (a copy of nanocall_tpu/util.py)."""

from __future__ import annotations

import gzip


def zopen(path, mode: str = "rt"):
    """zlib-transparent open (the reference reads every text input through
    zstr streams, accepting plain or gzip files; SURVEY.md section 2.9)."""
    path = str(path)
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, mode)
    return open(path, mode)
