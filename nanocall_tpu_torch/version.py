"""Version stamping with git-describe parity (a copy of
nanocall_tpu/version.py).

The reference bakes `package_version` at build time via
src/get-dir-version:6-21 with the fallback chain
git describe -> VERSION file -> "unknown"; here the same chain runs once
per process.
"""

from __future__ import annotations

import functools
import pathlib
import subprocess

FALLBACK = "0.1.0"


@functools.lru_cache(maxsize=1)
def get_version() -> str:
    root = pathlib.Path(__file__).resolve().parent.parent
    # git describe (get-dir-version:8-12), only if the working copy the
    # package sits in is this project's checkout
    try:
        top = subprocess.run(
            ["git", "rev-parse", "--show-toplevel"],
            cwd=root, capture_output=True, text=True, timeout=5,
        )
        if (
            top.returncode == 0
            and pathlib.Path(top.stdout.strip()).resolve() == root
        ):
            r = subprocess.run(
                ["git", "describe", "--tags", "--always", "--dirty"],
                cwd=root, capture_output=True, text=True, timeout=5,
            )
            if r.returncode == 0 and r.stdout.strip():
                return f"{FALLBACK}+{r.stdout.strip()}"
    except (OSError, subprocess.TimeoutExpired):
        pass
    # VERSION file (get-dir-version:14-16)
    vf = root / "VERSION"
    if vf.is_file():
        return vf.read_text().strip()
    return FALLBACK
