"""Instruction counts of the built CUDA kernels, by opcode, from
`cuobjdump -sass` of the libraries `ops/build.py` makes.

The cell update is bound by instruction throughput before bytes, so what a
change does to a kernel's integer and control instructions says more than
its byte count.  The counts are static (every branch's code counts once,
whether a cell runs it or not).

    python -m open_ludwig_torch.tools.sass_counts [kernel ...]

Needs nvcc and cuobjdump (the CUDA toolkit); no device.  `main(argv)`
returns {kernel: [{"function", "instructions", "by_opcode"}, ...]}.
"""

from __future__ import annotations

import collections
import os
import re
import subprocess
import sys
from typing import Dict, List, Optional, Sequence

from ..ops import build

_FUNCTION = re.compile(r"Function : (\S+)")
_INSTRUCTION = re.compile(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\d\s+)?([A-Z][A-Z0-9_]*)")


def count(sass: str) -> List[Dict]:
    """Per function of a `cuobjdump -sass` listing: its name, its number of
    instructions and the count of each opcode (modifiers dropped)."""
    out: List[Dict] = []
    for line in sass.splitlines():
        m = _FUNCTION.search(line)
        if m:
            out.append({"function": m.group(1), "instructions": 0,
                        "by_opcode": collections.Counter()})
            continue
        m = _INSTRUCTION.match(line)
        if m and out:
            out[-1]["instructions"] += 1
            out[-1]["by_opcode"][m.group(1)] += 1
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, List[Dict]]:
    names = list(argv if argv is not None else sys.argv[1:]) or list(build.KERNELS)
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    result = {}
    for name, built in zip(names, build.load_all(names)):
        sass = subprocess.run([cuobjdump, "-sass", built.path], capture_output=True,
                              text=True, check=True).stdout
        result[name] = count(sass)
        for fn in result[name]:
            top = ", ".join(f"{op} {n}" for op, n in fn["by_opcode"].most_common(14))
            print(f"{name} {fn['function'][:72]}: {fn['instructions']} instructions"
                  f" | {top}")
    return result


if __name__ == "__main__":
    main()
