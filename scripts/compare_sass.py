#!/usr/bin/env python3
"""Compare the SASS of one kernel source between two trees, kernel by
kernel, on a machine with the CUDA toolkit:

    python3 scripts/compare_sass.py OLD_CSRC NEW_CSRC FILE.cu [--dump DIR]

(NEW_CSRC "" for this checkout's own sources.)
Compiles ``FILE.cu`` of each csrc directory (e.g. a parent commit's
``yolo_tpu_torch/kernels/csrc`` unpacked with ``git archive``, and this
checkout's) to a cubin with the port's nvcc flags, disassembles each with
``cuobjdump -sass`` and compares every kernel of the old cubin with the
new kernel of the same body, its name aside: a kernel's mangled name
changes with its template arguments (a template parameter added for new
instantiations), and the address comments, labels and the name in its
branch targets are dropped before the comparison. Prints one JSON line
per old kernel (identical or not, instructions in each) and a summary
line; exits 1 where an old kernel has no identical new one. With
``--dump DIR`` each kernel's normalized instructions are also written to
``DIR/old/`` and ``DIR/new/``, one file per kernel named without its
namespace hash, for ``diff``."""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from yolo_tpu_torch.kernels import build  # noqa: E402


def sass(csrc: Path, name: str, tmp: Path) -> dict:
    """{kernel name: its normalized instructions} of csrc/name."""
    cubin = tmp / f"{abs(hash(csrc.as_posix()))}.cubin"
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    subprocess.run([build._nvcc(), *flags, "-cubin", str(csrc / name), "-o",
                    str(cubin)], check=True, capture_output=True)
    nvcc_bin = Path(build._nvcc()).parent
    out = subprocess.run([str(nvcc_bin / "cuobjdump"), "-sass", str(cubin)],
                         check=True, capture_output=True, text=True).stdout
    kernels: dict = {}
    cur = None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            kernels[cur] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;?\s*(/\*.*\*/)?\s*$",
                     line)
        if cur and m and m.group(1):
            ins = re.sub(r"`\(\.L_x_\d+\)", "LABEL", m.group(1))
            kernels[cur].append(ins)
    return kernels


def dump(kernels: dict, out: Path) -> None:
    out.mkdir(parents=True, exist_ok=True)
    for k, body in kernels.items():
        short = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+", "", k)
        (out / f"{short[:200]}.sass").write_text("\n".join(body) + "\n")


def main() -> int:
    args = sys.argv[1:]
    dump_dir = None
    if len(args) == 5 and args[3] == "--dump":
        dump_dir = Path(args.pop())
        args.pop()
    if len(args) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    old_dir, new_dir, name = args
    with tempfile.TemporaryDirectory() as tmp:
        old = sass(ROOT / old_dir, name, Path(tmp))
        new = sass(ROOT / new_dir if new_dir else build.CSRC, name,
                   Path(tmp))
    if dump_dir is not None:
        dump(old, dump_dir / "old")
        dump(new, dump_dir / "new")
    bodies = {tuple(v): k for k, v in new.items()}
    same = 0
    for k, body in old.items():
        match = bodies.get(tuple(body))
        same += match is not None
        print(json.dumps({"kernel": k, "identical_in_new": match is not None,
                          "new_kernel": match, "instructions": len(body)}))
    print(json.dumps({"source": name, "old_kernels": len(old),
                      "new_kernels": len(new), "old_identical_in_new": same}))
    return 0 if same == len(old) else 1


if __name__ == "__main__":
    sys.exit(main())
