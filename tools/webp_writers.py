"""A seeded random writer of lossy WebP (VP8 key frame) files.

``random_vp8_webp(seed, width, height)`` draws a random but valid VP8 key
frame (RFC 6386) and wraps it in a RIFF ``VP8 `` chunk. Its boolean
encoder writes what a real encoder rarely or never does, so that the
port's decoder (``akari_torch/native/webp_vp8.cpp``) can be held to
libwebp's on every path:

- the simple and the normal loop filter, levels 0-63, sharpness 0-7,
  reference and mode loop-filter deltas;
- segments with absolute or delta quantisers and filter levels, updated or
  not, and a segment map with its own probabilities;
- 1, 2, 4 or 8 token partitions; quantiser deltas on every matrix;
- random coefficient probability updates;
- every 16x16, 4x4 and chroma mode at every macroblock (the frame's
  borders included);
- tokens of every category, the largest values included, with and
  without the skip flag.

The token probabilities, their update probabilities and the key-frame 4x4
mode probabilities are read from the decoder's source, so a wrong table
there shows as a stream PIL decodes to other pixels.

``BitWriter``, ``vp8l_header``, ``chunk`` and ``riff`` are small helpers
for hand-made files (the crafted VP8L streams of
``tests/test_torch_image_webp.py``).
"""

from __future__ import annotations

import os
import re
import struct

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VP8_SOURCE = os.path.join(ROOT, "akari_torch", "native", "webp_vp8.cpp")

BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
CAT_PROBS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
             (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# libwebp's order of the 4x4 modes (its kBModesProba is indexed by it) and
# the tree leaves: DC, TM, VE, HE, RD, VR, LD, VL, HD, HU
B_TREE = {0: "0", 1: "10", 2: "110", 3: "11100", 4: "111010", 5: "111011", 6: "11110",
          7: "111110", 8: "1111110", 9: "1111111"}
B_NODE = {"": 0, "1": 1, "11": 2, "111": 3, "1110": 4, "11101": 5, "1111": 6, "11111": 7,
          "111111": 8}
# 16x16 / chroma modes in libwebp's numbering: DC 0, TM 1, V 2, H 3


def _tables():
    src = open(VP8_SOURCE).read()
    out = {}
    for name in ("kCoeffsProba0", "kCoeffsUpdateProba", "kBModesProba"):
        body = re.search(name + r"\[[^=]*=\s*\{(.*?)\};", src, re.S).group(1)
        out[name] = np.array([int(v) for v in re.findall(r"\d+", body)], np.int64)
    return (out["kCoeffsProba0"].reshape(4, 8, 3, 11).tolist(),
            out["kCoeffsUpdateProba"].reshape(4, 8, 3, 11).tolist(),
            out["kBModesProba"].reshape(10, 10, 9).tolist())


class BoolEncoder:
    """RFC 6386 section 7.3, with the interval bottom kept as an unbounded
    integer (so carries need no care) and flushed with spare zero bytes,
    so that libwebp's reader never runs out before the last bit."""

    def __init__(self):
        self.low, self.range, self.shifts = 0, 255, 0

    def put(self, bit, prob):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.low += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            self.low <<= 1
            self.shifts += 1

    def put_value(self, v, n):
        for k in range(n - 1, -1, -1):
            self.put((v >> k) & 1, 128)

    def put_signed(self, v, n):
        self.put_value(abs(v), n)
        self.put(int(v < 0), 128)

    def flag_value(self, v, n):
        """An optional signed field: a flag, then the value when it is
        non-zero."""
        self.put(int(v != 0), 128)
        if v:
            self.put_signed(v, n)

    def data(self):
        bits = self.shifts + 8
        nbytes = (bits + 7) // 8 + 2
        return (self.low << (8 * nbytes - bits)).to_bytes(nbytes, "big")


def _put_large(e, p, v):
    if v <= 4:
        e.put(0, p[3])
        e.put(int(v > 2), p[4])
        if v > 2:
            e.put(v - 3, p[5])
        return
    e.put(1, p[3])
    if v <= 10:
        e.put(0, p[6])
        if v <= 6:
            e.put(0, p[7])
            e.put(v - 5, 159)
        else:
            e.put(1, p[7])
            e.put((v - 7) >> 1, 165)
            e.put((v - 7) & 1, 145)
        return
    e.put(1, p[6])
    cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
    e.put(cat >> 1, p[8])
    e.put(cat & 1, p[9 + (cat >> 1)])
    extra = v - (3 + (8 << cat))
    probs = CAT_PROBS[cat]
    for k, prob in enumerate(probs):
        e.put((extra >> (len(probs) - 1 - k)) & 1, prob)


def _token_class(v):
    """1, 2, 3-4, 5-6, 7-10, then the extra-bit categories 3-6."""
    return next(c for c, top in enumerate((1, 2, 4, 6, 10, 18, 34, 66, 2114)) if v <= top)


def _put_coeffs(e, probs, ctx, first, vals, coverage=None):
    """Tokens of one block (``vals`` in zig-zag order), as libwebp's
    GetCoeffs reads them; returns what it returns."""
    nonzero = [n for n in range(first, 16) if vals[n]]
    last = nonzero[-1] if nonzero else -1
    n = first
    p = probs[BANDS[n]][ctx]
    while n < 16:
        if n > last:
            e.put(0, p[0])
            return n
        e.put(1, p[0])
        while vals[n] == 0:
            e.put(0, p[1])
            n += 1
            p = probs[BANDS[n]][0]
        e.put(1, p[1])
        v = abs(int(vals[n]))
        if coverage is not None:
            coverage.add(("token", _token_class(v)))
        if v == 1:
            e.put(0, p[2])
            ctx = 1
        else:
            e.put(1, p[2])
            _put_large(e, p, v)
            ctx = 2
        e.put(int(vals[n] < 0), 128)
        n += 1
        p = probs[BANDS[n]][ctx]
    return 16


def _random_block(r, first, density, big):
    vals = [0] * 16
    for n in range(first, 16):
        if r.random() < density:
            kind = r.random()
            if kind < big:
                v = int(r.integers(11, 2115))  # categories 3-6
            elif kind < 0.5:
                v = int(r.integers(2, 11))
            else:
                v = 1
            vals[n] = v if r.random() < 0.5 else -v
    if r.random() < 0.3:  # end early: tests the EOB contexts
        cut = int(r.integers(first, 17))
        vals[cut:] = [0] * (16 - cut)
    return vals


def random_vp8_frame(seed, width, height, coverage=None, **force):
    """The payload of a VP8 chunk: a random key frame of ``width`` x
    ``height``. ``force`` pins header choices by name (``simple``,
    ``level``, ``sharpness``, ``log2_parts``, ``segments``, ``skip_proba``,
    ``lf_delta``, ``density``, ``big``). ``coverage``, a set, receives
    (kind, mode, on the frame's top edge, left edge, right edge) for each
    16x16 ("y16"), 4x4 ("y4") and chroma ("uv") prediction written, and
    ("token", size class) for each coefficient (``_put_large``'s classes)."""
    r = np.random.default_rng(seed)
    proba0, update_proba, bmodes = _tables()

    def pick(name, value):
        return force.get(name, value)

    mb_w, mb_h = (width + 15) // 16, (height + 15) // 16
    e = BoolEncoder()
    e.put_value(int(r.integers(0, 2)), 1)  # colour space
    e.put_value(int(r.integers(0, 2)), 1)  # clamping type
    segments = pick("segments", bool(r.random() < 0.6))
    update_map = segments and bool(r.random() < 0.7)
    seg_proba = [int(r.integers(1, 256)) if r.random() < 0.7 else 255 for _ in range(3)]
    e.put(int(segments), 128)
    if segments:
        e.put(int(update_map), 128)
        update_data = bool(r.random() < 0.8)
        e.put(int(update_data), 128)
        if update_data:
            absolute = bool(r.random() < 0.5)
            e.put(int(absolute), 128)
            for _ in range(4):
                e.flag_value(int(r.integers(0, 128) if absolute else r.integers(-40, 41)), 7)
            for _ in range(4):
                e.flag_value(int(r.integers(0, 64) if absolute else r.integers(-20, 21)), 6)
        if update_map:
            for p in seg_proba:
                e.put(int(p != 255), 128)
                if p != 255:
                    e.put_value(p, 8)
    simple = pick("simple", bool(r.random() < 0.4))
    e.put(int(simple), 128)
    e.put_value(pick("level", int(r.integers(0, 64))), 6)
    e.put_value(pick("sharpness", int(r.integers(0, 8))), 3)
    lf_delta = pick("lf_delta", bool(r.random() < 0.5))
    e.put(int(lf_delta), 128)
    if lf_delta:
        update = bool(r.random() < 0.8)
        e.put(int(update), 128)
        if update:
            for _ in range(8):
                e.flag_value(int(r.integers(-63, 64)) if r.random() < 0.7 else 0, 6)
    log2_parts = pick("log2_parts", int(r.integers(0, 4)))
    e.put_value(log2_parts, 2)
    e.put_value(int(r.integers(0, 128)), 7)  # base quantiser index
    for _ in range(5):
        e.flag_value(int(r.integers(-15, 16)) if r.random() < 0.5 else 0, 4)
    e.put_value(int(r.integers(0, 2)), 1)  # refresh entropy probabilities (ignored)
    probs = proba0
    rate = float(r.choice([0.0, 0.02, 0.3]))
    for t, b, c, k in np.ndindex(4, 8, 3, 11):
        upd = bool(r.random() < rate)
        e.put(int(upd), update_proba[t][b][c][k])
        if upd:
            probs[t][b][c][k] = int(r.integers(1, 256))
            e.put_value(probs[t][b][c][k], 8)
    skip_proba = pick("skip_proba", bool(r.random() < 0.5))
    skip_p = int(r.integers(1, 256))
    e.put(int(skip_proba), 128)
    if skip_proba:
        e.put_value(skip_p, 8)

    density = pick("density", float(r.choice([0.05, 0.3, 0.8])))
    big = pick("big", float(r.choice([0.0, 0.05, 0.3])))
    parts = [BoolEncoder() for _ in range(1 << log2_parts)]
    intra_t = [0] * (4 * mb_w)
    top_nz = [0] * mb_w
    top_nz_dc = [0] * mb_w
    for mb_y in range(mb_h):
        t = parts[mb_y & ((1 << log2_parts) - 1)]
        intra_l = [0] * 4
        left_nz = left_nz_dc = 0
        rows = []
        for mb_x in range(mb_w):  # modes of the row (first partition)
            if update_map:
                s = int(r.integers(0, 4))
                e.put(s >> 1, seg_proba[0])
                e.put(s & 1, seg_proba[1 + (s >> 1)])
            skip = skip_proba and bool(r.random() < 0.3)
            if skip_proba:
                e.put(int(skip), skip_p)
            i4x4 = bool(r.random() < 0.5)
            e.put(int(not i4x4), 145)
            if not i4x4:
                ymode = int(r.integers(0, 4))
                edges = (mb_y == 0, mb_x == 0, mb_x == mb_w - 1)
                if coverage is not None:
                    coverage.add(("y16", ymode, *edges))
                bits = {0: (0, 0), 2: (0, 1), 3: (1, 0), 1: (1, 1)}[ymode]
                e.put(bits[0], 156)
                e.put(bits[1], 128 if bits[0] else 163)
                intra_t[4 * mb_x:4 * mb_x + 4] = [ymode] * 4
                intra_l = [ymode] * 4
            else:
                for y in range(4):
                    left = intra_l[y]
                    for x in range(4):
                        mode = int(r.integers(0, 10))
                        if coverage is not None:
                            coverage.add(("y4", mode, mb_y == 0 and y == 0, mb_x == 0 and x == 0,
                                          mb_x == mb_w - 1 and x == 3))
                        prob = bmodes[intra_t[4 * mb_x + x]][left]
                        code = B_TREE[mode]
                        for k, bit in enumerate(code):
                            e.put(int(bit), int(prob[B_NODE[code[:k]]]))
                        intra_t[4 * mb_x + x] = left = mode
                    intra_l[y] = left
            uvmode = int(r.integers(0, 4))
            if coverage is not None:
                coverage.add(("uv", uvmode, mb_y == 0, mb_x == 0, mb_x == mb_w - 1))
            e.put(int(uvmode != 0), 142)
            if uvmode:
                e.put(int(uvmode != 2), 114)
                if uvmode != 2:
                    e.put(int(uvmode == 1), 183)
            rows.append((skip, i4x4))
        for mb_x, (skip, i4x4) in enumerate(rows):  # tokens (the row's partition)
            if skip:
                top_nz[mb_x] = left_nz = 0
                if not i4x4:
                    top_nz_dc[mb_x] = left_nz_dc = 0
                continue
            tnz, lnz = int(top_nz[mb_x]), left_nz
            if not i4x4:
                nz = _put_coeffs(t, probs[1], int(top_nz_dc[mb_x]) + left_nz_dc, 0,
                                 _random_block(r, 0, density, big), coverage)
                top_nz_dc[mb_x] = left_nz_dc = int(nz > 0)
            first = 0 if i4x4 else 1
            table = probs[3] if i4x4 else probs[0]
            new_t, new_l = 0, 0
            tbits = [(tnz >> x) & 1 for x in range(4)]
            for y in range(4):
                l_ = (lnz >> y) & 1
                for x in range(4):
                    nz = _put_coeffs(t, table, l_ + tbits[x], first,
                                     _random_block(r, first, density, big), coverage)
                    l_ = tbits[x] = int(nz > first)
                new_l |= l_ << y
            new_t = sum(b << x for x, b in enumerate(tbits))
            for ch in (0, 2):  # U then V, 2x2 blocks each
                tb = [(tnz >> (4 + ch + x)) & 1 for x in range(2)]
                for y in range(2):
                    l_ = (lnz >> (4 + ch + y)) & 1
                    for x in range(2):
                        nz = _put_coeffs(t, probs[2], l_ + tb[x], 0,
                                         _random_block(r, 0, density, big), coverage)
                        l_ = tb[x] = int(nz > 0)
                    new_l |= l_ << (4 + ch + y)
                new_t |= (tb[0] << (4 + ch)) | (tb[1] << (5 + ch))
            top_nz[mb_x], left_nz = new_t, new_l
    first_part = e.data()
    tokens = [p.data() for p in parts]
    scale = int(r.integers(0, 4)), int(r.integers(0, 4))
    tag = 0 | (int(r.integers(0, 4)) << 1) | (1 << 4) | (len(first_part) << 5)
    head = (struct.pack("<I", tag)[:3] + b"\x9d\x01\x2a"
            + struct.pack("<HH", width | (scale[0] << 14), height | (scale[1] << 14)))
    sizes = b"".join(struct.pack("<I", len(p))[:3] for p in tokens[:-1])
    return head + first_part + sizes + b"".join(tokens)


class BitWriter:
    """VP8L's bit order: values least significant bit first."""

    def __init__(self):
        self.bits = []

    def put(self, v, n):
        self.bits.extend((int(v) >> k) & 1 for k in range(n))

    def code(self, canonical, length):
        """A prefix code's codeword: its first bit is read first."""
        self.put(int(format(canonical, f"0{length}b")[::-1], 2) if length else 0, length)

    def simple_code(self, *symbols):
        """A simple code of one or two symbols (the first 1 or 8 bits)."""
        self.put(1, 1)
        self.put(len(symbols) - 1, 1)
        wide = symbols[0] > 1
        self.put(int(wide), 1)
        self.put(symbols[0], 8 if wide else 1)
        if len(symbols) == 2:
            self.put(symbols[1], 8)

    def data(self):
        return np.packbits(np.array(self.bits, np.uint8), bitorder="little").tobytes()


def vp8l_header(width, height, alpha=0):
    """The 5-byte header of a VP8L bitstream."""
    bits = (width - 1) | ((height - 1) << 14) | (alpha << 28)
    return b"\x2f" + struct.pack("<I", bits)


def chunk(fourcc, payload):
    return fourcc + struct.pack("<I", len(payload)) + payload + b"\x00" * (len(payload) & 1)


def riff(*chunks):
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def random_vp8_webp(seed, width, height, coverage=None, **force):
    """``random_vp8_frame`` in a simple-format WebP file."""
    return riff(chunk(b"VP8 ", random_vp8_frame(seed, width, height, coverage, **force)))
