"""Several devices and several hosts: sequence-parallel Viterbi (seqpar,
K9), the per-device data sharder (mesh) and multi-host runs (multihost)."""
