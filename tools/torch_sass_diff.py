#!/usr/bin/env python3
"""Compare the SASS of the port's kernels between two checkouts.

Builds (or reuses) each checkout's kernel library, disassembles both with
`cuobjdump -sass` and prints, per kernel, its instruction count in each and
whether the instructions are the same (addresses and encodings dropped,
the anonymous namespace's per-build hash taken out of the names).  With
--diff FILE it writes the differing instructions of each kernel that
differs.  --rename PATTERN=REPLACEMENT (a regular expression, repeatable)
rewrites the new checkout's kernel names first, so that an instance whose
template gained a parameter is held against its old self (K5m's
em_backward_wave_kernel<SYS, CLUSTER> against <SYS, CLUSTER, false>:
--rename '(em_backward_wave_kernelILb.ELb.E)Lb0E=\1').  Needs nvcc and
cuobjdump (the CUDA toolkit):

    python3 tools/torch_sass_diff.py OLD_CHECKOUT NEW_CHECKOUT [--diff FILE]
"""

import argparse
import difflib
import os
import re
import subprocess
import sys

LOAD = ("from nanocall_tpu_torch.ops import _cuda; _cuda.load(); "
        "print(_cuda._lib_path()); print(_cuda._nvcc())")


def library(tree: str) -> tuple:
    """(path of the checkout's built kernel library, its nvcc)."""
    out = subprocess.run([sys.executable, "-c", LOAD], cwd=tree,
                         capture_output=True, text=True, check=True)
    lib, nvcc = out.stdout.split()[-2:]
    return lib, nvcc


def parse_sass(text: str) -> dict:
    """{kernel name: [instruction, ...]} of `cuobjdump -sass` output."""
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__",
                          m.group(1))
            funcs[name] = []
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if name and m:
            funcs[name].append(m.group(1).strip())
    return funcs


def kernels(tree: str) -> dict:
    """parse_sass of the checkout's library."""
    lib, nvcc = library(tree)
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    return parse_sass(subprocess.run([cuobjdump, "-sass", lib],
                                     capture_output=True, text=True,
                                     check=True).stdout)


def diff_lines(fa: list, fb: list) -> list:
    """The instructions that differ between two kernels' lists, as
    `op old[i:j] new[k:l]` lines each followed by the - / + instructions."""
    lines = []
    sm = difflib.SequenceMatcher(a=fa, b=fb, autojunk=False)
    for op, i1, i2, j1, j2 in sm.get_opcodes():
        if op != "equal":
            lines.append(f"{op} old[{i1}:{i2}] new[{j1}:{j2}]")
            lines += [f"  - {x}" for x in fa[i1:i2]]
            lines += [f"  + {x}" for x in fb[j1:j2]]
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--diff", default="", metavar="FILE")
    ap.add_argument("--rename", action="append", default=[],
                    metavar="PATTERN=REPLACEMENT")
    args = ap.parse_args(argv)
    a, b = kernels(args.old), kernels(args.new)
    for rule in args.rename:
        pattern, repl = rule.split("=", 1)
        b = {re.sub(pattern, repl, f): ins for f, ins in b.items()}
    lines = []
    for f in sorted(set(a) | set(b)):
        fa, fb = a.get(f, []), b.get(f, [])
        print(f"sass {f}: {len(fa)} / {len(fb)} instructions, "
              f"{'same' if fa == fb else 'different'}", flush=True)
        if fa and fb and fa != fb:
            lines += [f"### {f}", *diff_lines(fa, fb)]
    if args.diff:
        with open(args.diff, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
