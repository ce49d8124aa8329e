"""Builtin pore models (a copy of nanocall_tpu/models/__init__.py, with
its own copy of builtin.npz).

builtin.npz packs the six builtin 6-mer pore-model tables (ONT-provided
data) of the reference's Builtin_Model: the R7.3 tables of
src/builtin_models/r73.*.ont.model and the R9 tables of the compiled
binary's initializer lists.
"""

from __future__ import annotations

import os

import numpy as np

from .. import pore_model
from ..kmer import n_states

_NPZ = os.path.join(os.path.dirname(__file__), "builtin.npz")


def load_builtin_models(pore: str = "r73", K: int = 6) -> dict:
    """Builtin models whose name starts with '<pore>.' (nanocall.cpp:155-177).
    Returns {name: PoreModel}."""
    out = {}
    with np.load(_NPZ, allow_pickle=False) as z:
        names = [str(x) for x in z["names"]]
        strands = z["strands"]
        for name, strand in zip(names, strands):
            if not name.startswith(pore + "."):
                continue
            tbl = z[f"{name}.table"]
            assert tbl.shape == (4, n_states(K))
            out[name] = pore_model.PoreModel(
                level_mean=tbl[0].astype(np.float32),
                level_stdv=tbl[1].astype(np.float32),
                sd_mean=tbl[2].astype(np.float32),
                sd_stdv=tbl[3].astype(np.float32),
                K=K,
                strand=int(strand),
                name=name,
            )
    # sorted like the reference's std::map-keyed Pore_Model_Dict
    return dict(sorted(out.items()))
