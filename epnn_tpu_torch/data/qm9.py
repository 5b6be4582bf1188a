"""Raw QM9 ``.xyz`` → loader-format converter (counterpart of
``epnn_tpu/data/qm9.py``, the same bytes out).

Line 2 of a raw QM9 file is the GDB property line (``gdb 73000 ...``),
where the loader expects a float net charge.  The converted copy has the
header ``<natoms>\\n0 0``, tab-separated atom lines with the trailing
per-atom Mulliken column kept (the loader ignores it), and raw QM9's
``*^`` scientific notation rewritten as ``e``.
"""

from __future__ import annotations

import os
from typing import Dict

QM9_HEADER_CHARGE_LINE = "0 0"


def _fix_number(tok: str) -> str:
    # raw QM9 writes Mathematica-style "1.234*^-6"
    return tok.replace("*^", "e")


def convert_text(text: str) -> str:
    lines = text.splitlines()
    if len(lines) < 3:
        raise ValueError("not a QM9 xyz: fewer than 3 lines")
    natoms = int(lines[0].split()[0])
    out = [str(natoms), QM9_HEADER_CHARGE_LINE]
    for ln in lines[2:2 + natoms]:
        toks = ln.split()
        nums = [_fix_number(t) for t in toks[1:5]]  # x y z [mulliken]
        out.append("\t".join([toks[0]] + nums))
    return "\n".join(out) + "\n"


def convert_file(src: str, dst: str) -> None:
    with open(src, "r") as f:
        text = f.read()
    with open(dst, "w") as f:
        f.write(convert_text(text))


def convert_directory(src_dir: str, dst_dir: str) -> Dict[str, str]:
    """Convert every raw QM9 .xyz in ``src_dir`` into ``dst_dir``."""
    os.makedirs(dst_dir, exist_ok=True)
    written: Dict[str, str] = {}
    for fname in sorted(os.listdir(src_dir)):
        if not fname.endswith(".xyz"):
            continue
        src = os.path.join(src_dir, fname)
        dst = os.path.join(dst_dir, fname)
        convert_file(src, dst)
        written[src] = dst
    return written
