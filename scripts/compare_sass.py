#!/usr/bin/env python3
"""Compare the machine code (SASS) that two versions of a CUDA source in
``rust_bio_tpu_torch/ops/csrc/`` compile to, kernel by kernel, with the
flags ``ops/_build.py`` builds them with (``sm_90a``).

    python3 scripts/compare_sass.py OLD.cu NEW.cu [--source NAME] [--diff N]

``--source`` names the source whose ``EXTRA_FLAGS`` apply (default: NEW's
file name without ``.cu``); ``--diff N`` prints, under each pair that
differs, the first N lines of a unified diff of their instructions. A kernel is named by its demangled function
name without namespaces, return type and parameters, template arguments
kept. For each kernel it prints ``same`` or ``differs`` (with the
instruction counts); a new kernel without its old name is held against
the old kernels of the same name up to its template arguments that the
new side lacks, those whose arguments are a subsequence of its own or it
of theirs (a template argument gained or dropped) where there are any
(``same as old ...``), else it is ``new only``; an old one left over is
``old only``. Equal machine code means equal outputs and
equal time on the same inputs. Exits non-zero when nvcc or cuobjdump is
missing or a build fails. Needs the CUDA toolkit, not a card.
"""

from __future__ import annotations

import argparse
import difflib
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def tool(name: str) -> str:
    found = shutil.which(name) or str(Path("/usr/local/cuda/bin") / name)
    if not Path(found).exists():
        sys.exit(f"compare_sass: {name} not found")
    return found


def kernels(src: Path, flags: list, tmp: Path) -> dict:
    """{kernel name: its SASS instructions, addresses and encodings cut}."""
    cubin = tmp / (src.stem + str(len(list(tmp.iterdir()))) + ".cubin")
    flags = [f for f in flags if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([tool("nvcc"), *flags, "-cubin", "-o", str(cubin), str(src)], check=True)
    sass = subprocess.run([tool("cuobjdump"), "-sass", str(cubin)], check=True, capture_output=True, text=True).stdout
    names = subprocess.run(
        [tool("cu++filt")], input="\n".join(re.findall(r"Function : (\S+)", sass)),
        check=True, capture_output=True, text=True,
    ).stdout.split("\n")
    out = {}
    for name, body in zip(names, re.split(r"\n\s*Function : \S+\n", sass)[1:]):
        code = [re.sub(r"/\*\s*(0x)?[0-9a-f]+\s*\*/", "", line).strip() for line in body.split("\n")]
        out[kernel_name(name)] = [c for c in code if c and not c.startswith(".")]
    return out


def kernel_name(demangled: str) -> str:
    """``void (anonymous namespace)::k<float, 16>(int, ...)`` -> ``k<float, 16>``."""
    s = demangled.strip().replace("(anonymous namespace)::", "").replace("<unnamed>::", "")
    if s.endswith(")"):  # cut the parameter list at its matching parenthesis
        depth = 0
        for i in range(len(s) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(s[i], 0)
            if depth == 0:
                s = s[:i]
                break
    depth, start = 0, 0
    for i, ch in enumerate(s):  # the last name at template depth 0
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if depth == 0 and (ch == " " or s.startswith("::", i)):
            start = i + (2 if ch == ":" else 1)
    return s[start:]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path)
    ap.add_argument("--source")
    ap.add_argument("--diff", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    from rust_bio_tpu_torch.ops import _build

    flags = list(_build.NVCC_FLAGS) + list(_build.EXTRA_FLAGS.get(args.source or args.new.stem, ()))
    with tempfile.TemporaryDirectory() as d:
        old, new = kernels(args.old, flags, Path(d)), kernels(args.new, flags, Path(d))
    bare = lambda name: re.sub(r"<.*>$", "", name)  # noqa: E731
    paired = set()

    def targs(name: str) -> list:
        inner = re.search(r"<(.*)>$", name)
        return [a.strip() for a in inner.group(1).split(",")] if inner else []

    def within(short: list, long: list) -> bool:
        it = iter(long)
        return all(a in it for a in short)

    def show(o: str, n: str) -> None:
        if args.diff and old[o] != new[n]:
            lines = list(difflib.unified_diff(old[o], new[n], "old", "new", n=1, lineterm=""))
            print("\n".join("    " + line for line in lines[: args.diff]))

    for name in sorted(set(old) | set(new)):
        if name in old and name in new:
            same = "same" if old[name] == new[name] else "differs"
            print(f"{name}: {same} ({len(old[name])} against {len(new[name])} instructions)")
            show(name, name)
        elif name in new:
            # a kernel that lost or gained its template: against each old
            # instantiation of its bare name that the new side lacks
            olds = [o for o in old if o not in new and bare(o) == bare(name)]
            near = [o for o in olds if within(targs(o), targs(name)) or within(targs(name), targs(o))]
            olds = near or olds
            for o in olds:
                same = "same as" if old[o] == new[name] else "differs from"
                print(f"{name}: {same} old {o} ({len(old[o])} against {len(new[name])} instructions)")
                show(o, name)
            paired.update(olds)
            if not olds:
                print(f"{name}: new only")
    for name in sorted(set(old) - set(new) - paired):
        print(f"{name}: old only")
    return 0


if __name__ == "__main__":
    sys.exit(main())
