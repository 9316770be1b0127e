"""What the decode kernels compile to: instruction counts from their SASS,
and ptxas' registers, spills and shared memory.

    python -m fastsmc_tpu_torch.probes.sass [--rpw 9] [--kernel hmm_forward]
    python -m fastsmc_tpu_torch.probes.sass --rpw 0 --kernel alpha_wall_backward

Builds the library of ``--kernel`` (the decode kernels', or the probe's
for ``alpha_wall``; on a machine with the CUDA toolkit) unless it exists,
dumps the SASS of every entry function
whose name holds ``--kernel`` and the row count ``--rpw`` (KP = 8 x rpw;
K=69 gives 9; 0 takes every function, as the probe's kernels need) with
``cuobjdump -sass``, and prints one JSON line: for each function, its
instruction counts over the whole function and over its
densest loop (the backward branch whose body has the largest share of the
product's opcode: HGMMA (wgmma) or HMMA (mma.sync) in a function that has
tensor-core products, FFMA otherwise), and ptxas' line for it when the
library was built by this call.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
from collections import Counter
from typing import Optional

# opcodes counted; LDS alone is a 32-bit shared load; LDL / STL are local
# memory (spills)
OPCODES = ("FFMA", "HMMA", "HGMMA", "LDS", "LDS.64", "LDS.128", "LDSM", "SHFL",
           "LDG", "BAR", "SYNCS", "LDL", "STL")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"(.*?);")
_TARGET = re.compile(r"(?:0x([0-9a-f]+)|`\(([^)]+)\))")
_LABEL = re.compile(r"^\s*(\.L\w+):")


def _counts(ops) -> dict:
    c = Counter()
    for op in ops:
        base = op.split(".")[0]
        if base == "LDS":
            width = next((w for w in (".64", ".128") if w in op), "")
            c["LDS" + width] += 1
        elif base in ("BAR", "SYNCS", "FFMA", "HMMA", "HGMMA", "LDSM", "SHFL",
                      "LDG", "LDL", "STL"):
            c[base] += 1
    return {k: c.get(k, 0) for k in OPCODES} | {"instructions": len(ops)}


def parse_sass(text: str) -> dict:
    """{function: {"total": counts, "densest_loop": counts or None}}."""
    funcs, name, body, labels = {}, None, [], {}

    def close():
        if name is None:
            return
        addr = [a for a, _, _ in body]
        ops = [o for _, o, _ in body]
        product = next((p for p in ("HGMMA", "HMMA")
                        if any(o.startswith(p) for o in ops)), "FFMA")
        best = None
        for i, (a, op, rest) in enumerate(body):
            if not op.startswith("BRA"):
                continue
            m = _TARGET.search(rest)
            if not m:
                continue
            tgt = int(m.group(1), 16) if m.group(1) else labels.get(m.group(2))
            if tgt is None or tgt >= a:
                continue
            j = next(k for k, x in enumerate(addr) if x >= tgt)
            loop = ops[j:i + 1]
            share = sum(o.startswith(product) for o in loop) / len(loop)
            if best is None or share > best[0]:
                best = (share, loop)
        funcs[name] = {"total": _counts(ops),
                       "densest_loop": _counts(best[1]) if best else None}

    pending = []
    for line in text.splitlines():
        if "Function :" in line:
            close()
            name, body, labels, pending = line.split(":", 1)[1].strip(), [], {}, []
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if m and name is not None:
            a = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = a
            pending = []
            body.append((a, m.group(2), m.group(3)))
    close()
    return funcs


def ptxas_lines(log: str) -> dict:
    """{mangled entry name: ptxas' registers / spill lines joined}."""
    out, fn = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and ("registers" in line or "spill" in line):
            text = line.split(":", 1)[-1].strip()
            out[fn] = f"{out[fn]}; {text}" if fn in out else text
    return out


def sass_report(lib_path, log: str, kernel: str,
                rpw: Optional[int] = None) -> dict:
    """{function: counts and ptxas' line} for the entry functions whose name
    holds ``kernel`` (and, with ``rpw``, the row count ``rpw``)."""
    from torch.utils.cpp_extension import CUDA_HOME
    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True).stdout
    tag = f"ILi{rpw}E"
    ptx = ptxas_lines(log)
    return {fn: dict(counts, ptxas=ptx.get(fn))
            for fn, counts in parse_sass(text).items()
            if kernel in fn and (rpw is None or tag in fn)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rpw", type=int, default=9,
                    help="row count of the decode kernels' instantiations "
                    "(0: every function, as for --kernel alpha_wall)")
    ap.add_argument("--kernel", default="hmm_forward")
    args = ap.parse_args(argv)
    from fastsmc_tpu_torch.engine import _build
    from fastsmc_tpu_torch.probes import alpha_wall
    lib = alpha_wall.LIBRARY if "alpha_wall" in args.kernel else _build.DECODE
    info = _build.build(lib)
    res = sass_report(info.path, info.log, args.kernel,
                      args.rpw or None)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
