"""tools/torch_sass_diff.py's parsing of `cuobjdump -sass` output and its
instruction diff (the comparison itself needs the CUDA toolkit)."""

import importlib.util
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]

_spec = importlib.util.spec_from_file_location(
    "torch_sass_diff", ROOT / "tools" / "torch_sass_diff.py")
sass_diff = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(sass_diff)

#: a kernel's mangled name after the anonymous namespace's hash
KERNEL = "_20_viterbi_traceback_cu_b0c24viterbi_traceback_kernelEv"


def _dump(ns_hash: str, second: str) -> str:
    """cuobjdump -sass output of one three-instruction kernel."""
    return f"""
	code for sm_90a
		Function : _ZN53_GLOBAL__N__{ns_hash}{KERNEL}
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                     /* 0x00000a00ff017b82 */
                                                                              /* 0x000fe40000000800 */
        /*0010*/                   {second} ;              /* 0x0000000000027919 */
                                                                              /* 0x000e220000002100 */
        /*0020*/                   EXIT ;                                     /* 0x000000000000794d */
"""


def test_parse_sass_drops_addresses_encodings_and_the_namespace_hash():
    """Two builds whose only differences are the anonymous namespace's
    hash and the encodings parse to the same kernel; a changed instruction
    shows as one replace line with its old and new text."""
    a = sass_diff.parse_sass(_dump("3e5f268c", "S2R R0, SR_TID.X"))
    b = sass_diff.parse_sass(_dump("cc62097d", "S2R R0, SR_TID.X"))
    name = "_ZN53_GLOBAL__N_" + KERNEL
    assert a == b == {name: ["LDC R1, c[0x0][0x28]", "S2R R0, SR_TID.X",
                             "EXIT"]}
    c = sass_diff.parse_sass(_dump("cc62097d", "S2R R2, SR_TID.X"))
    assert sass_diff.diff_lines(a[name], c[name]) == [
        "replace old[1:2] new[1:2]", "  - S2R R0, SR_TID.X",
        "  + S2R R2, SR_TID.X"]
    assert sass_diff.diff_lines(a[name], a[name]) == []
