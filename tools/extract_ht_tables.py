"""Write ``akari_torch/native/j2k_ht_tables.h``: OpenJPEG 2.5.4's two HTJ2K
cleanup-pass VLC decode tables, found in the ``libopenjp2`` that Pillow
bundles.

The tables (``vlc_tbl0`` for the first quad row of a code-block,
``vlc_tbl1`` for the others) are 1024 ``uint16`` entries each, stored one
after the other in the library's read-only data. They are found by their
first eight entries, not by an offset. The index of an entry is
``(context << 7) | (the next 7 bits of the VLC stream)``; the entry holds
the codeword length (bits 0-2), ``u_off`` (bit 3), ``rho`` (bits 4-7),
``e_1`` (bits 8-11) and ``e_k`` (bits 12-15).

    python tools/extract_ht_tables.py [--check]

``--check`` compares the committed header with the library's bytes instead
of writing it. ``read_header`` parses the header back (the HT writer of
``tools/j2k_writers.py`` inverts the tables into its encoder).
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import struct
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = os.path.join(ROOT, "akari_torch", "native", "j2k_ht_tables.h")

# the first eight entries of each table
HEAD0 = (0x0023, 0x00A5, 0x0043, 0x0066, 0x0083, 0xA8EE, 0x0014, 0xD8DF)
HEAD1 = (0x0013, 0x0065, 0x0043, 0x00DE, 0x0083, 0x888D, 0x0023, 0x444E)
N = 1024

_PREAMBLE = """\
// OpenJPEG 2.5.4's HTJ2K (JPEG 2000 Part 15) cleanup-pass VLC decode tables,
// vlc_tbl0 (the first quad row of a code-block) and vlc_tbl1 (the other quad
// rows), as in OpenJPEG's src/lib/openjp2/t1_ht_luts.h. Written by
// tools/extract_ht_tables.py from the libopenjp2 that Pillow bundles; do not
// edit by hand.
//
// An entry's index is (context << 7) | (the next 7 bits of the VLC stream).
// Bits 0-2: the codeword length; bit 3: u_off; bits 4-7: rho (the quad's
// significant samples); bits 8-11: e_1; bits 12-15: e_k.
//
// The tables are OpenJPEG's, under its BSD 2-clause licence:
//
// Redistribution and use in source and binary forms, with or without
// modification, are permitted provided that the following conditions are
// met:
// 1. Redistributions of source code must retain the above copyright notice,
//    this list of conditions and the following disclaimer.
// 2. Redistributions in binary form must reproduce the above copyright
//    notice, this list of conditions and the following disclaimer in the
//    documentation and/or other materials provided with the distribution.
//
// THIS SOFTWARE IS PROVIDED BY THE COPYRIGHT HOLDERS AND CONTRIBUTORS "AS IS"
// AND ANY EXPRESS OR IMPLIED WARRANTIES, INCLUDING, BUT NOT LIMITED TO, THE
// IMPLIED WARRANTIES OF MERCHANTABILITY AND FITNESS FOR A PARTICULAR PURPOSE
// ARE DISCLAIMED. IN NO EVENT SHALL THE COPYRIGHT OWNER OR CONTRIBUTORS BE
// LIABLE FOR ANY DIRECT, INDIRECT, INCIDENTAL, SPECIAL, EXEMPLARY, OR
// CONSEQUENTIAL DAMAGES (INCLUDING, BUT NOT LIMITED TO, PROCUREMENT OF
// SUBSTITUTE GOODS OR SERVICES; LOSS OF USE, DATA, OR PROFITS; OR BUSINESS
// INTERRUPTION) HOWEVER CAUSED AND ON ANY THEORY OF LIABILITY, WHETHER IN
// CONTRACT, STRICT LIABILITY, OR TORT (INCLUDING NEGLIGENCE OR OTHERWISE)
// ARISING IN ANY WAY OUT OF THE USE OF THIS SOFTWARE, EVEN IF ADVISED OF THE
// POSSIBILITY OF SUCH DAMAGE.

#pragma once

#include <cstdint>
"""


def library_path():
    """Pillow's bundled libopenjp2."""
    import PIL

    libs = glob.glob(os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                                  "pillow.libs", "libopenjp2*.so*"))
    if not libs:
        raise RuntimeError("PIL's bundled libopenjp2 was not found")
    return libs[0]


def find_tables(blob):
    """(vlc_tbl0, vlc_tbl1) as [1024] uint16 arrays from the library's bytes:
    the one place where the first table's head is followed, 2048 bytes on,
    by the second's."""
    h0, h1 = struct.pack("<8H", *HEAD0), struct.pack("<8H", *HEAD1)
    hits = []
    pos = blob.find(h0)
    while pos >= 0:
        if blob[pos + 2 * N:pos + 2 * N + 16] == h1:
            hits.append(pos)
        pos = blob.find(h0, pos + 1)
    if len(hits) != 1:
        raise RuntimeError(f"expected the two HT tables once in the library, found {len(hits)}")
    t = np.frombuffer(blob[hits[0]:hits[0] + 4 * N], "<u2")
    return t[:N].copy(), t[N:].copy()


def render(t0, t1):
    out = [_PREAMBLE]
    for name, t in (("vlc_tbl0", t0), ("vlc_tbl1", t1)):
        out.append(f"\nstatic const uint16_t {name}[{N}] = {{\n")
        for i in range(0, N, 8):
            out.append("    " + " ".join(f"0x{int(v):04x}," for v in t[i:i + 8]) + "\n")
        out.append("};\n")
    return "".join(out)


def read_header(path=HEADER):
    """The two tables parsed back from the committed header."""
    with open(path) as f:
        text = f.read()
    tables = []
    for name in ("vlc_tbl0", "vlc_tbl1"):
        body = re.search(name + r"\[\d+\] = \{(.*?)\};", text, re.S).group(1)
        tables.append(np.array([int(v, 16) for v in re.findall(r"0x[0-9a-f]+", body)], np.uint16))
        if tables[-1].size != N:
            raise ValueError(f"{name} has {tables[-1].size} entries")
    return tables[0], tables[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="compare the committed header with the library instead of writing it")
    args = ap.parse_args(argv)
    with open(library_path(), "rb") as f:
        t0, t1 = find_tables(f.read())
    text = render(t0, t1)
    if args.check:
        with open(HEADER) as f:
            same = f.read() == text
        print("equal" if same else "differs")
        return 0 if same else 1
    with open(HEADER, "w") as f:
        f.write(text)
    print(f"wrote {HEADER}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
