"""Pore models: per-state emission distributions, scaling, and I/O (a
copy of nanocall_tpu/pore_model.py).

The model is a struct-of-arrays (level_mean/level_stdv/sd_mean/sd_stdv
over all n_states k-mers; Pore_Model.hpp); scaling is a functional
transform; emissions are computed inside the DP kernels (ops/hmm.py).

Distributions (Pore_Model.hpp:24-40):
  event mean  ~ Normal(level_mean, level_stdv)
  event stdv  ~ InverseGaussian(sd_mean, sd_lambda),
                sd_lambda = sd_mean^3 / sd_stdv^2  (Pore_Model.hpp:112)
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from . import kmer

LOG_2PI = math.log(2.0 * math.pi)

# strand codes (Builtin_Model semantics): 0=template, 1=complement, 2=both
TEMPLATE, COMPLEMENT, BOTH = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class PoreModelParams:
    """Per-read scaling parameters (Pore_Model.hpp:42-77)."""

    scale: float = 1.0
    shift: float = 0.0
    drift: float = 0.0
    var: float = 1.0
    scale_sd: float = 1.0
    var_sd: float = 1.0

    def as_array(self) -> np.ndarray:
        return np.array(
            [self.scale, self.shift, self.drift, self.var, self.scale_sd, self.var_sd],
            dtype=np.float32,
        )

    @staticmethod
    def from_array(a) -> "PoreModelParams":
        a = np.asarray(a, dtype=np.float64)
        return PoreModelParams(
            scale=float(a[0]),
            shift=float(a[1]),
            drift=float(a[2]),
            var=float(a[3]),
            scale_sd=float(a[4]),
            var_sd=float(a[5]),
        )

    def write_tsv(self) -> str:
        return "\t".join(
            f"{v:.5f}"
            for v in (self.scale, self.shift, self.drift, self.var, self.scale_sd, self.var_sd)
        )

    def __str__(self) -> str:
        return (
            f"[scale={self.scale:g} shift={self.shift:g} drift={self.drift:g}"
            f" var={self.var:g} scale_sd={self.scale_sd:g} var_sd={self.var_sd:g}]"
        )


@dataclasses.dataclass(frozen=True)
class PoreModel:
    """Struct-of-arrays pore model over all n_states k-mers.

    Arrays are float32 (n_states,), indexed by k-mer integer code.
    """

    level_mean: np.ndarray
    level_stdv: np.ndarray
    sd_mean: np.ndarray
    sd_stdv: np.ndarray
    K: int = 6
    strand: int = BOTH
    name: str = ""

    @property
    def n_states(self) -> int:
        return kmer.n_states(self.K)

    @property
    def sd_lambda(self) -> np.ndarray:
        """sd_lambda = sd_mean^3 / sd_stdv^2 (Pore_Model.hpp:112)."""
        return (self.sd_mean.astype(np.float64) ** 3 / self.sd_stdv.astype(np.float64) ** 2).astype(
            np.float32
        )

    def mean(self) -> float:
        """Mean of level_mean over states (Pore_Model.hpp:187,307-313),
        float32 sequential accumulation (alg::mean_stdv_of<Float_Type>)."""
        from . import native

        return native.mean_stdv_f32(self.level_mean)[0]

    def stdv(self) -> float:
        """Population stdv of level_mean over states (same f32 semantics)."""
        from . import native

        return native.mean_stdv_f32(self.level_mean)[1]

    def scaled(self, params: PoreModelParams) -> "PoreModel":
        """Return a new model with per-read scaling applied
        (Pore_Model_State::scale, Pore_Model.hpp:126-138):
          level_mean <- level_mean * scale + shift
          level_stdv <- level_stdv * var
          sd_mean    <- sd_mean * scale_sd
          sd_lambda  <- sd_lambda * var_sd   (via sd_stdv update)
        """
        lm = self.level_mean * np.float32(params.scale) + np.float32(params.shift)
        ls = self.level_stdv * np.float32(params.var)
        sm = self.sd_mean * np.float32(params.scale_sd)
        new_lambda = self.sd_lambda * np.float32(params.var_sd)
        # sd_stdv from (sd_mean^3 / lambda)^0.5 (Pore_Model.hpp:115)
        ss = np.sqrt(sm.astype(np.float64) ** 3 / new_lambda.astype(np.float64)).astype(np.float32)
        return dataclasses.replace(
            self, level_mean=lm, level_stdv=ls, sd_mean=sm, sd_stdv=ss
        )

    def state_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(level_mean, level_stdv, sd_mean, sd_lambda) for the DP kernels."""
        return self.level_mean, self.level_stdv, self.sd_mean, self.sd_lambda


def load_tsv(path, K: int = 6, strand: int = BOTH, name: str = "") -> PoreModel:
    """Load a pore-model TSV (kmer, level_mean, level_stdv, sd_mean, sd_stdv),
    skipping '#' comments and header lines containing 'kmer'
    (Pore_Model.hpp:251-287).  Rows are sorted into k-mer order."""
    n = kmer.n_states(K)
    lm = np.zeros(n, dtype=np.float32)
    ls = np.zeros(n, dtype=np.float32)
    sm = np.zeros(n, dtype=np.float32)
    ss = np.zeros(n, dtype=np.float32)
    seen = np.zeros(n, dtype=bool)
    count = 0
    from .util import zopen

    with zopen(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].startswith("#") or "kmer" in line:
                continue
            i = kmer.kmer_to_int(parts[0])
            lm[i], ls[i], sm[i], ss[i] = (float(x) for x in parts[1:5])
            seen[i] = True
            count += 1
    if count != n or not seen.all():
        raise ValueError(f"unexpected number of states in {path}: {count} != {n}")
    base = path if isinstance(path, str) else str(path)
    return PoreModel(
        level_mean=lm, level_stdv=ls, sd_mean=sm, sd_stdv=ss, K=K, strand=strand,
        name=name or base,
    )


def save_tsv(pm: PoreModel, path) -> None:
    """Write a pore model in the reference TSV format (Pore_Model.hpp:151-159,
    241-249): kmer, level_mean, level_stdv, sd_mean, sd_stdv per line."""
    kmers = kmer.all_kmer_strings(pm.K)
    with open(path, "w") as fh:
        for i in range(pm.n_states):
            fh.write(
                f"{kmers[i]}\t{pm.level_mean[i]:g}\t{pm.level_stdv[i]:g}"
                f"\t{pm.sd_mean[i]:g}\t{pm.sd_stdv[i]:g}\n"
            )
