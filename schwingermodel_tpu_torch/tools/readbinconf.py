"""Binary-to-text gauge-configuration converter.

Counterpart of ``schwingermodel_tpu/tools/readbinconf.py``. Replaces the
reference's standalone `readBinConf.cpp` + `readBin.sh` workflow (which
sed-edits compile-time lattice dims into the source and rebuilds per
size, readBin.sh:9-12): here the lattice shape is sniffed from the binary
file's own index records, so one tool handles every size.

Usage (both work):

    python -m schwingermodel_tpu_torch.tools.readbinconf SRC.ctxt DST.txt
    printf "SRC.ctxt\nDST.txt" | python -m schwingermodel_tpu_torch.tools.readbinconf

The second form is pipe-compatible with the reference's stdin prompt loop
(`./readBinConf < filenames`, readBin.sh:13-14). The text output reproduces
the reference converter's exact column format (readBinConf.cpp:113-127):
`x` unpadded, then t and mu right-aligned in width 10, then re and im
right-aligned in width 30 as 17-digit scientific.
"""

from __future__ import annotations

import argparse
import sys

from schwingermodel_tpu_torch.io import ctxt


def format_reference_text(U) -> str:
    """Render links [2, Nx, Nt] in readBinConf.cpp's SaveConf text format
    (readBinConf.cpp:113-127: setw(10) ints, setw(30) scientific prec 17)."""
    import numpy as np

    U = np.asarray(U)
    _, Nx, Nt = U.shape
    lines = []
    for x in range(Nx):
        for t in range(Nt):
            for mu in range(2):
                v = U[mu, x, t]
                lines.append(
                    f"{x}{t:>10}{mu:>10}{v.real:>30.17e}{v.imag:>30.17e}"
                )
    return "\n".join(lines) + "\n"


def convert(src: str, dst: str) -> tuple[int, int]:
    """Binary .ctxt -> reference-format text. Returns the sniffed (Nx, Nt)."""
    Nx, Nt = ctxt.sniff_lattice_shape(src)
    U = ctxt.read_conf(src, Nx, Nt, binary=True)
    with open(dst, "w") as f:
        f.write(format_reference_text(U))
    return Nx, Nt


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m schwingermodel_tpu_torch.tools.readbinconf",
        description="Convert a binary .ctxt gauge configuration to "
        "human-readable text (reference readBinConf.cpp equivalent).",
    )
    p.add_argument("src", nargs="?", help="binary .ctxt file (stdin if omitted)")
    p.add_argument("dst", nargs="?", help="output text file (stdin if omitted)")
    args = p.parse_args(argv)

    src, dst = args.src, args.dst
    interactive = sys.stdin.isatty()
    if src is None:
        if interactive:  # reference prompt (readBinConf.cpp:135-137)
            print("Enter the name of the binary file: ", file=sys.stderr)
        src = sys.stdin.readline().strip()
    if dst is None:
        if interactive:
            print("Enter the name of the output file: ", file=sys.stderr)
        dst = sys.stdin.readline().strip()
    if not src or not dst:
        print("error: need a source and a destination file", file=sys.stderr)
        return 1

    try:
        Nx, Nt = convert(src, dst)
    except FileNotFoundError:
        print(f"File {src} not found", file=sys.stderr)  # readBinConf.cpp:80
        return 1
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f"Nx {Nx}  Nt {Nt}")  # reference banner (readBinConf.cpp:134)
    print(f"Wrote {dst}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
