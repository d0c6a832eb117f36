"""Kernel-by-kernel SASS of the package's sources against another tree's.

Compiles each named ``csrc/<name>.cu`` of this checkout and of another
tree's ``csrc`` directory (``--parent``, e.g. a ``git archive`` of the
parent commit unpacked under the ignored ``_tree/``) to a cubin with the
package's flags (``cuda_build.NVCC_FLAGS``, ``-cubin`` in place of
``-shared``), disassembles both with ``cuobjdump -sass`` and matches the
kernels: a kernel is *identical* where the other tree has a kernel of the
same name whose instructions (addresses and encodings stripped) are the
same, *moved* where only a kernel of another name has them (matched by
body), else *changed*.  Sources build in parallel, one ``nvcc`` each.

Run on a machine with the CUDA toolkit::

    python -m deepestscatter_tpu_torch.probes.sass_diff --parent _tree/csrc \\
        pathtrace path_adjoint spatial [--extra pathtrace_variants] \\
        [--require KERNEL_SUBSTRING ...]

Prints one line a kernel of the parent's sources, then a JSON object as
the last line; exits 1 where a kernel whose demangled name contains a
``--require`` substring is not identical (or, with ``--body``, not
identical or moved).
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List

from .. import cuda_build


def cubin_flags() -> List[str]:
    """The package's nvcc flags for a cubin."""
    drop = {"-shared", "-Xcompiler", "-fPIC"}
    return [f for f in cuda_build.NVCC_FLAGS if f not in drop] + ["-cubin"]


def compile_all(csrc: Path, names: List[str], out: Path) -> Dict[str, Path]:
    """Each ``csrc/<name>.cu`` to ``out/<name>.cubin``, all nvcc at once."""
    procs = {}
    for n in names:
        cmd = [cuda_build.nvcc(), *cubin_flags(), "-I", str(csrc), "-o", str(out / f"{n}.cubin"),
               str(csrc / f"{n}.cu")]
        procs[n] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
    failed = []
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{csrc / n}.cu:\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {n: out / f"{n}.cubin" for n in names}


def cuobjdump() -> str:
    nvcc = Path(cuda_build.nvcc())
    tool = nvcc.with_name("cuobjdump")
    return str(tool) if tool.is_file() else (shutil.which("cuobjdump") or "cuobjdump")


def kernels(cubin: Path) -> Dict[str, List[str]]:
    """Mangled kernel name → its instructions, addresses and encodings
    stripped."""
    text = subprocess.run([cuobjdump(), "-sass", str(cubin)], capture_output=True, text=True,
                          check=True).stdout
    out: Dict[str, List[str]] = {}
    name = None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        if name is None:
            continue
        ins = re.sub(r"/\*[^*]*\*/", "", ln).strip()
        if ins and not ins.startswith("."):
            out[name].append(ins)
    return out


def demangle(names: List[str]) -> Dict[str, str]:
    tool = shutil.which("c++filt") or shutil.which("cu++filt")
    if tool is None or not names:
        return {n: n for n in names}
    res = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    lines = res.stdout.splitlines()
    return dict(zip(names, lines)) if len(lines) == len(names) else {n: n for n in names}


def compare(parent: Path, names: List[str], extra: List[str] = ()) -> Dict[str, dict]:
    """Each kernel of the parent tree's sources: its status against this
    tree's kernels of the same sources (a kernel of this tree's ``extra``
    sources may also hold its body), and its instruction count."""
    with tempfile.TemporaryDirectory() as tmp:
        a, b = Path(tmp) / "parent", Path(tmp) / "new"
        a.mkdir()
        b.mkdir()
        old_c = compile_all(parent, names, a)
        new_c = compile_all(cuda_build.CSRC, list(names) + list(extra), b)
        new_all = {n: kernels(new_c[n]) for n in new_c}
        bodies = {tuple(v): k for n in new_c for k, v in new_all[n].items()}
        report: Dict[str, dict] = {}
        for n in names:
            old, new = kernels(old_c[n]), new_all[n]
            readable = demangle(sorted(set(old) | set(new) | set(bodies.values())))
            for k, body in old.items():
                if new.get(k) == body:
                    status = "identical"
                elif tuple(body) in bodies:
                    status = "moved to " + readable[bodies[tuple(body)]]
                else:
                    status = "changed"
                report[f"{n}: {readable[k]}"] = dict(status=status, instructions=len(body),
                                                     new_instructions=len(new.get(k, [])))
            for k in new:
                if k not in old:
                    report[f"{n}: {readable[k]}"] = dict(status="new",
                                                         new_instructions=len(new[k]))
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, required=True,
                        help="the other tree's csrc directory")
    parser.add_argument("--require", action="append", default=[],
                        help="a substring of the demangled names that must be identical")
    parser.add_argument("--body", action="store_true",
                        help="a required kernel may also have moved (the same body)")
    parser.add_argument("--extra", action="append", default=[],
                        help="a source of this tree only, whose kernels may hold a parent "
                             "kernel's body")
    parser.add_argument("names", nargs="+", help="sources (csrc/<name>.cu)")
    opts = parser.parse_args(argv)
    report = compare(opts.parent, opts.names, opts.extra)
    ok = True
    for key, row in report.items():
        print(f"sass {key}: {json.dumps(row)}", flush=True)
        if any(r in key for r in opts.require) and row["status"] != "new":
            good = row["status"] == "identical" or (opts.body and row["status"].startswith("moved"))
            ok = ok and good
    print(json.dumps(dict(ok=ok, kernels=report)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
