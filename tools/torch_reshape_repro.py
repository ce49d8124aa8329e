#!/usr/bin/env python3
"""The in-kernel shape cast (8, 128, 4) -> (8, 512) on one NVIDIA GPU: the
PyTorch + CUDA counterpart of tools/exp_mosaic_repro.py (K10).

    python3 tools/torch_reshape_repro.py [--device cuda|cpu]

Runs K10 (nanocall_tpu_torch/csrc/reshape_copy.cu, through
nanocall_tpu_torch.ops.repro) on the card, or its plain version with
`--device cpu`, on np.arange(4096) as an (8, 128, 4) float32 tensor, and
checks the result with torch.equal against x.reshape(8, 512).  Prints PASS
or FAIL as the original does; exits 1 on a mismatch.  A kernel that does
not build or launch raises.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from nanocall_tpu_torch.ops import repro

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    x = torch.from_numpy(
        np.arange(8 * 128 * 4, dtype=np.float32).reshape(8, 128, 4)).to(dev)
    out = repro.reshape_copy(x).cpu()
    ok = torch.equal(out, x.cpu().reshape(8, 512))
    print(f"{'PASS' if ok else 'FAIL'}: shape cast ran on {dev}; values "
          f"{'ok' if ok else 'WRONG'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
