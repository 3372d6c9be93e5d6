"""Whether two builds of a kernel source compile a kernel to the same code.

    python -m hank_tpu_torch.tools.sass_compare OLD.cu NEW.cu [--kernels REGEX]
        [--rename OLD_PART=NEW_PART ...] [--out FILE]
    python -m hank_tpu_torch.tools.sass_compare --digest SOURCE.cu [--rename ...] [--out FILE]

Compiles each source with the library's nvcc flags (`ops/cuda_build.py`)
into a temporary directory, disassembles both with `cuobjdump -sass` and,
per kernel, compares the instruction text with addresses, encodings and
column padding stripped. Kernels of the same mangled name in both builds
are compared when the name matches `--kernels` (default: all). A kernel
renamed between the builds is compared under `--rename`: each OLD_PART of
an old build's mangled name is read as NEW_PART (e.g.
`19forward_scan_kernel=28forward_scan_previous_kernel`).

Prints one JSON line per compared kernel: its name, the instruction counts
of both builds, whether they are identical and, if not, the index and text
of the first differing instruction. With `--digest` it prints one JSON
object instead: the nvcc version and, per kernel of one source, its
instruction count and the SHA-256 of its instruction text (`digests`), the
record `chip_smoke.py` holds a build to when the old source is not at hand
(`sass_reference.json` beside this file: the previous build's kernels).
Needs nvcc and cuobjdump (the CUDA toolkit), not a card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile


def _tool(name: str) -> str:
    from hank_tpu_torch.ops import cuda_build

    path = os.path.join(os.path.dirname(cuda_build._nvcc()), name)
    if os.path.isfile(path):
        return path
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"{name} not found beside nvcc or on PATH")
    return found


def build(source: str, out: str) -> None:
    """`source` compiled with the library's flags into the shared library
    `out`."""
    from hank_tpu_torch.ops import cuda_build

    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", out, source],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)


def sass(library: str) -> dict[str, list[str]]:
    """{mangled kernel name: its instructions}, each instruction's text
    without its address, encoding or padding."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", library], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    return parse_sass(text)


# The anonymous namespace's mangled name carries the source file's name and
# a hash of it: `_ZN51_GLOBAL__N__8ce16936_18_household_sweep_cu_42b7fca8...`.
ANON = re.compile(r"_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_\w*?_cu_[0-9a-f]{8}")


def parse_sass(text: str) -> dict[str, list[str]]:
    """`cuobjdump -sass` text → {kernel: instructions}. The anonymous
    namespace's file-specific part is dropped from every name, so copies of
    a source under other file names compare by kernel. Branch labels
    (`.L_x_N`, numbered across the whole file) are renumbered per kernel in
    order of first use, so a kernel's text does not depend on the others."""
    out, cur, labels = {}, None, {}

    def label(m):
        return f".L{labels.setdefault(m.group(0), len(labels))}"

    for line in text.splitlines():
        line = ANON.sub("_ZN_anon_", line)
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur, labels = out.setdefault(m.group(1), []), {}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if cur is not None and m:
            cur.append(re.sub(r"\.L_x_\d+", label, " ".join(m.group(1).split())))
    return out


def digests(kernels: dict[str, list[str]]) -> dict[str, dict]:
    """{kernel: {"instructions": count, "sha256": digest of the text}}."""
    return {name: {"instructions": len(text),
                   "sha256": hashlib.sha256("\n".join(text).encode()).hexdigest()}
            for name, text in kernels.items()}


def nvcc_version() -> str:
    """The last line of `nvcc --version` (the release and build)."""
    from hank_tpu_torch.ops import cuda_build

    out = subprocess.run([cuda_build._nvcc(), "--version"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return out.strip().splitlines()[-1]


def compare(old: list[str], new: list[str]) -> dict:
    first = next((i for i, (a, b) in enumerate(zip(old, new)) if a != b),
                 None if len(old) == len(new) else min(len(old), len(new)))
    rec = {"old_instructions": len(old), "new_instructions": len(new),
           "identical": first is None}
    if first is not None:
        rec.update(first_difference=first,
                   old_text=old[first] if first < len(old) else None,
                   new_text=new[first] if first < len(new) else None)
    return rec


def renamed(kernels: dict, rules: list[str]) -> dict:
    """`kernels` with each rule "OLD_PART=NEW_PART" applied to every name."""
    for rule in rules:
        a, b = rule.split("=", 1)
        kernels = {name.replace(a, b): text for name, text in kernels.items()}
    return kernels


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="+", help="OLD.cu NEW.cu, or SOURCE.cu with --digest")
    ap.add_argument("--digest", action="store_true")
    ap.add_argument("--kernels", default="")
    ap.add_argument("--rename", action="append", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if len(args.sources) != (1 if args.digest else 2):
        ap.error("give OLD.cu NEW.cu, or one SOURCE.cu with --digest")
    if args.digest:
        with tempfile.TemporaryDirectory() as tmp:
            build(args.sources[0], os.path.join(tmp, "k.so"))
            kernels = renamed(sass(os.path.join(tmp, "k.so")), args.rename)
        rec = {"nvcc": nvcc_version(), "source": args.sources[0],
               "kernels": digests({k: v for k, v in kernels.items()
                                   if re.search(args.kernels, k)})}
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(rec, f, indent=1)
        return 0
    args.old, args.new = args.sources
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = [os.path.join(tmp, "old.so"), os.path.join(tmp, "new.so")]
        build(args.old, libs[0])
        build(args.new, libs[1])
        old, new = sass(libs[0]), sass(libs[1])
    old = renamed(old, args.rename)
    for name in sorted(set(old) & set(new)):
        if re.search(args.kernels, name):
            lines.append({"kernel": name, **compare(old[name], new[name])})
    lines.append({"old_only": sorted(set(old) - set(new)),
                  "new_only": sorted(set(new) - set(old))})
    for rec in lines:
        print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(rec) + "\n" for rec in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
