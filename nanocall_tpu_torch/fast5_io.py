"""fast5 (HDF5) reading and writing via h5py (a copy of
nanocall_tpu/fast5_io.py).

Replaces the reference's vendored mateidavid/fast5 header library (see
SURVEY.md section 2.9; call sites cited below are where nanocall consumes
each accessor).  Layout follows ONT fast5 conventions:

  /UniqueGlobalKey/channel_id            @sampling_rate
  /Analyses/EventDetection_<grp>/Reads/Read_<N>
      @read_id (optional)
      Events: compound dataset {mean, stdv (or variance), start, length}
  /Analyses/<bc_grp>/BaseCalled_{template|complement}/
      Fastq   (written basecalls)
      Events  (written event table with model states/moves)
      Model   (written model table) @scale/@shift/...

Basecall groups are written under fresh Nanocall_NNN names so reruns never
clobber earlier results (Fast5_Summary.hpp:280-309).
"""

from __future__ import annotations

import dataclasses
import os
import re

import numpy as np

try:
    import h5py
except ImportError:  # the CLI refuses to run without it
    h5py = None

STRAND_GROUP = {0: "BaseCalled_template", 1: "BaseCalled_complement"}


def is_valid_file(path: str) -> bool:
    """True if path is an HDF5 file (fast5::File::is_valid_file,
    nanocall.cpp:212)."""
    if not os.path.isfile(path):
        return False
    sig = b"\x89HDF\r\n\x1a\n"
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as fh:
            # H5Fis_hdf5 semantics: the superblock may sit after a
            # userblock at offset 512, 1024, 2048, ... (doubling)
            off = 0
            while off + 8 <= size:
                fh.seek(off)
                if fh.read(8) == sig:
                    return True
                off = 512 if off == 0 else off * 2
            return False
    except OSError:
        return False


@dataclasses.dataclass
class EdEventData:
    """Raw event-detection data for one read."""

    read_id: str
    sampling_rate: float
    mean: np.ndarray
    stdv: np.ndarray
    start: np.ndarray  # raw sample index
    length: np.ndarray  # raw sample count


class Fast5File:
    """Minimal fast5 accessor mirroring the fast5::File API surface used by
    the reference."""

    def __init__(self, path: str, rw: bool = False):
        self.path = path
        self._f = h5py.File(path, "r+" if rw else "r")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --- reading ---------------------------------------------------------

    def have_sampling_rate(self) -> bool:
        g = self._f.get("/UniqueGlobalKey/channel_id")
        return g is not None and "sampling_rate" in g.attrs

    def get_sampling_rate(self) -> float:
        return float(self._f["/UniqueGlobalKey/channel_id"].attrs["sampling_rate"])

    def eventdetection_groups(self) -> list[str]:
        """Available EventDetection group suffixes ('000', '001', ...)."""
        an = self._f.get("/Analyses")
        if an is None:
            return []
        out = []
        for name in an:
            m = re.fullmatch(r"EventDetection_(\d+)", name)
            if m:
                out.append(m.group(1))
        return sorted(out)

    def have_eventdetection_events(self, grp: str = "") -> bool:
        grp = grp or (self.eventdetection_groups() or [None])[0]
        if grp is None:
            return False
        g = self._f.get(f"/Analyses/EventDetection_{grp}/Reads")
        return g is not None and len(g) > 0

    def get_eventdetection_events(self, grp: str = "") -> EdEventData:
        """Events + params for the (first) read of an EventDetection group
        (Fast5_Summary.hpp:174-184,505-509).

        "First" is lexicographic — deliberately: HDF5's default iteration
        order (H5_INDEX_NAME) is lexicographic, so this matches what the
        reference's fast5 lib sees; real-world group tags are zero-padded
        ("000") and files carry one Read_N, so numeric-vs-lex ordering
        differs only on hand-built files."""
        grp = grp or (self.eventdetection_groups() or [""])[0]
        reads = self._f[f"/Analyses/EventDetection_{grp}/Reads"]
        read_name = sorted(reads.keys())[0]
        rg = reads[read_name]
        read_id = rg.attrs.get("read_id", b"")
        if isinstance(read_id, bytes):
            read_id = read_id.decode()
        ds = rg["Events"][()]
        names = ds.dtype.names
        stdv = (
            ds["stdv"]
            if "stdv" in names
            else np.sqrt(np.maximum(ds["variance"], 0.0))
        )
        return EdEventData(
            read_id=str(read_id),
            sampling_rate=self.get_sampling_rate() if self.have_sampling_rate() else 0.0,
            mean=np.asarray(ds["mean"], dtype=np.float64),
            stdv=np.asarray(stdv, dtype=np.float64),
            start=np.asarray(ds["start"], dtype=np.float64),
            length=np.asarray(ds["length"], dtype=np.float64),
        )

    def get_basecall_group_list(self) -> list[str]:
        an = self._f.get("/Analyses")
        return list(an.keys()) if an is not None else []

    # --- writing (Fast5_Summary.hpp:379-437) -----------------------------

    def add_basecall_seq(
        self, strand: int, bc_grp: str, name: str, seq: str, default_qual: int = 33
    ) -> None:
        g = self._f.require_group(f"/Analyses/{bc_grp}/{STRAND_GROUP[strand]}")
        fastq = f"@{name}\n{seq}\n+\n{chr(default_qual) * len(seq)}\n"
        if "Fastq" in g:
            del g["Fastq"]
        g.create_dataset("Fastq", data=np.bytes_(fastq.encode()))

    def add_basecall_events(self, strand: int, bc_grp: str, table: np.ndarray) -> None:
        g = self._f.require_group(f"/Analyses/{bc_grp}/{STRAND_GROUP[strand]}")
        if "Events" in g:
            del g["Events"]
        g.create_dataset("Events", data=table)

    def add_basecall_model(self, strand: int, bc_grp: str, table: np.ndarray) -> None:
        g = self._f.require_group(f"/Analyses/{bc_grp}/{STRAND_GROUP[strand]}")
        if "Model" in g:
            del g["Model"]
        g.create_dataset("Model", data=table)

    def add_basecall_model_params(self, strand: int, bc_grp: str, params) -> None:
        g = self._f.require_group(f"/Analyses/{bc_grp}/{STRAND_GROUP[strand]}")
        for k in ("scale", "shift", "drift", "var", "scale_sd", "var_sd"):
            g.attrs[k] = float(getattr(params, k))


def next_basecall_group(existing: list[str], prefix: str = "Nanocall_") -> str:
    """First unused Nanocall_NNN tag (Fast5_Summary.hpp:280-303)."""
    used = set()
    for g in existing:
        if g.startswith(prefix) and len(g) > len(prefix):
            used.add(g[len(prefix):])
    for i in range(1000):
        tag = f"{i:03d}"
        if tag not in used:
            return prefix + tag
    raise RuntimeError("no available basecall tag")


def basecall_event_table(ev, path_states, moves, p_states, K: int) -> np.ndarray:
    """Build the compound Events table written back to fast5
    (Fast5_Summary.hpp:394-407): mean/stdv/start/length plus decoded
    model_state/move."""
    from . import kmer as kmer_mod

    T = len(ev)
    dt = np.dtype(
        [
            ("mean", "<f8"),
            ("start", "<f8"),
            ("stdv", "<f8"),
            ("length", "<f8"),
            ("model_state", f"S{K}"),
            ("move", "<i4"),
            ("p_model_state", "<f8"),
        ]
    )
    out = np.zeros(T, dtype=dt)
    out["mean"] = ev.mean
    out["stdv"] = ev.stdv
    out["start"] = ev.start
    out["length"] = ev.length
    kmers = np.array([k.encode() for k in kmer_mod.all_kmer_strings(K)])
    out["model_state"] = kmers[np.asarray(path_states, dtype=np.intp)]
    out["move"] = moves
    out["p_model_state"] = p_states
    return out


def model_table(pm) -> np.ndarray:
    """Compound Model table (kmer, level_mean, level_stdv, sd_mean, sd_stdv)."""
    from . import kmer as kmer_mod

    dt = np.dtype(
        [
            ("kmer", f"S{pm.K}"),
            ("level_mean", "<f8"),
            ("level_stdv", "<f8"),
            ("sd_mean", "<f8"),
            ("sd_stdv", "<f8"),
        ]
    )
    out = np.zeros(pm.n_states, dtype=dt)
    out["kmer"] = [s.encode() for s in kmer_mod.all_kmer_strings(pm.K)]
    out["level_mean"] = pm.level_mean
    out["level_stdv"] = pm.level_stdv
    out["sd_mean"] = pm.sd_mean
    out["sd_stdv"] = pm.sd_stdv
    return out



def write_fast5(
    path: str,
    mean,
    stdv,
    start,
    length,
    sampling_rate: float = 4000.0,
    read_id: str = "",
    ed_group: str = "000",
    read_number: int = 0,
) -> None:
    """Create a synthetic fast5 file with an EventDetection group (used by
    tests and the data simulator)."""
    with h5py.File(path, "w") as f:
        ch = f.create_group("/UniqueGlobalKey/channel_id")
        ch.attrs["sampling_rate"] = float(sampling_rate)
        rg = f.create_group(f"/Analyses/EventDetection_{ed_group}/Reads/Read_{read_number}")
        if read_id:
            rg.attrs["read_id"] = np.bytes_(read_id.encode())
        dt = np.dtype(
            [("mean", "<f8"), ("stdv", "<f8"), ("start", "<i8"), ("length", "<i8")]
        )
        tbl = np.zeros(len(mean), dtype=dt)
        tbl["mean"] = mean
        tbl["stdv"] = stdv
        tbl["start"] = start
        tbl["length"] = length
        rg.create_dataset("Events", data=tbl)
