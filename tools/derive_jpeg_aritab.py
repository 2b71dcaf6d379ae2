#!/usr/bin/env python3
"""Derive the arithmetic decoder's probability estimation table for the
PyTorch port's JPEG decoder (`straps_tpu_torch/csrc/jpeg_aritab.h`):

    python tools/derive_jpeg_aritab.py

The table is T.81 Table D.2 (Qe, Next_Index_LPS, Next_Index_MPS,
Switch_MPS for the 113 states of the QM coder) plus libjpeg's state 113,
the fixed probability of one half that codes signs and refinement bits,
in libjpeg's packed form: Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7
| Next_Index_LPS (`jaricom.c`).  The script reads the table (114 64-bit
words) out of the libjpeg-turbo that Pillow bundles and out of cv2's
module, which must agree; checks the Qe of every state against Table
D.2's Qe column below and the whole row of the states listed in `ROWS`;
and writes the header.  It needs Pillow and cv2; the port imports
neither.  `tests/test_torch_jpeg_codings.py` holds the committed header
to `header_text(read_table())`.
"""

import glob
import os
import struct
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "straps_tpu_torch", "csrc", "jpeg_aritab.h")

# T.81 Table D.2, the Qe column (hexadecimal), states 0-112.
QE = [
    0x5A1D, 0x2586, 0x1114, 0x080B, 0x03D8, 0x01DA, 0x00E5, 0x006F, 0x0036, 0x001A,
    0x000D, 0x0006, 0x0003, 0x0001, 0x5A7F, 0x3F25, 0x2CF2, 0x207C, 0x17B9, 0x1182,
    0x0CEF, 0x09A1, 0x072F, 0x055C, 0x0406, 0x0303, 0x0240, 0x01B1, 0x0144, 0x00F5,
    0x00B7, 0x008A, 0x0068, 0x004E, 0x003B, 0x002C, 0x5AE1, 0x484C, 0x3A0D, 0x2EF1,
    0x261F, 0x1F33, 0x19A8, 0x1518, 0x1177, 0x0E74, 0x0BFB, 0x09F8, 0x0861, 0x0706,
    0x05CD, 0x04DE, 0x040F, 0x0363, 0x02D4, 0x025C, 0x01F8, 0x01A4, 0x0160, 0x0125,
    0x00F6, 0x00CB, 0x00AB, 0x008F, 0x5B12, 0x4D04, 0x412C, 0x37D8, 0x2FE8, 0x293C,
    0x2379, 0x1EDF, 0x1AA9, 0x174E, 0x1424, 0x119C, 0x0F6B, 0x0D51, 0x0BB6, 0x0A40,
    0x5832, 0x4D1C, 0x438E, 0x3BDD, 0x34EE, 0x2EAE, 0x299A, 0x2516, 0x5570, 0x4CA9,
    0x44D9, 0x3E22, 0x3824, 0x32B4, 0x2E17, 0x56A8, 0x4F46, 0x47E5, 0x41CF, 0x3C3D,
    0x375E, 0x5231, 0x4C0F, 0x4639, 0x415E, 0x5627, 0x50E7, 0x4B85, 0x5597, 0x504F,
    0x5A10, 0x5522, 0x59EB,
]
# Rows of Table D.2 in full: (state, Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS).
ROWS = [(0, 0x5A1D, 1, 1, 1), (1, 0x2586, 14, 2, 0), (2, 0x1114, 16, 3, 0),
        (3, 0x080B, 18, 4, 0), (4, 0x03D8, 20, 5, 0), (13, 0x0001, 12, 13, 0),
        (14, 0x5A7F, 15, 15, 1), (112, 0x59EB, 112, 111, 1)]
# The first 32 bytes of the table in libjpeg's binaries (states 0-3).
HEAD = struct.pack("<4Q", 0x5A1D0181, 0x2586020E, 0x11140310, 0x080B0412)


def read_table_from(path: str):
    with open(path, "rb") as f:
        data = f.read()
    at = data.find(HEAD)
    if at < 0 or data.find(HEAD, at + 1) >= 0:
        raise ValueError(f"{path}: no single copy of jpeg_aritab")
    return list(struct.unpack("<114Q", data[at:at + 114 * 8])), at


def unpack(v: int):
    return v >> 16, v & 0x7F, (v >> 8) & 0xFF, (v >> 7) & 1


def check(table) -> None:
    assert len(QE) == 113
    for i, v in enumerate(table[:113]):
        qe, nlps, nmps, switch = unpack(v)
        assert qe == QE[i], (i, hex(qe))
        assert nlps < 113 and nmps < 113, i
    for i, qe, nlps, nmps, switch in ROWS:
        assert unpack(table[i]) == (qe, nlps, nmps, switch), i
    assert unpack(table[113]) == (0x5A1D, 113, 113, 0)


def read_table():
    """The table out of Pillow's libjpeg and cv2's module, checked; prints
    where it found it."""
    import PIL
    import cv2
    libs = sorted(glob.glob(os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                                         "pillow.libs", "libjpeg*.so*")))
    mods = sorted(glob.glob(os.path.join(os.path.dirname(cv2.__file__), "cv2*.so")))
    tables = [(path,) + read_table_from(path) for path in libs[:1] + mods[:1]]
    for path, table, at in tables:
        print(f"{os.path.basename(path)}: jpeg_aritab at file offset {at}")
    assert len(tables) == 2 and tables[0][1] == tables[1][1], "the two binaries disagree"
    check(tables[0][1])
    return tables[0][1]


def header_text(table) -> str:
    lines = ["// T.81 Table D.2 in libjpeg's packed form, written by",
             "// tools/derive_jpeg_aritab.py (read from libjpeg-turbo's binaries and",
             "// checked against the standard's Qe column): Qe << 16 | Next_Index_MPS",
             "// << 8 | Switch_MPS << 7 | Next_Index_LPS; state 113 is libjpeg's",
             "// fixed probability of one half.",
             "#pragma once",
             "#include <cstdint>",
             "",
             "static const uint32_t kJpegAritab[114] = {"]
    for i in range(0, 114, 6):
        lines.append("    " + " ".join(f"0x{v:08x}," for v in table[i:i + 6]))
    lines.append("};")
    return "\n".join(lines) + "\n"


def main() -> int:
    with open(OUT, "w") as f:
        f.write(header_text(read_table()))
    print(f"wrote {OUT}: 114 entries, Qe of all 113 states equal to T.81 Table D.2")
    return 0


if __name__ == "__main__":
    sys.exit(main())
