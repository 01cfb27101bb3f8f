"""Writers of arithmetic-coded and lossless JPEGs, and a cutter of
progressive ones, for the PyTorch port's decoder tests and
``chip_smoke.py``. Pillow writes neither form, and the smoke runs where
there is no PIL.

- ``arith_jpeg``: sequential (SOF9) or progressive (SOF10) arithmetic
  coding of quantised coefficients, as libjpeg's jcarith.c codes them: the
  QM encoder of ITU-T T.81 Annex D (``_QM``, with its carry and 0xFF
  stuffing), the DC and AC models of Annexes F.1.4.4 and G.1.3, DAC
  conditioning (L, U, K) and restart intervals;
- ``lossless_jpeg``: lossless Huffman JPEG (SOF3, Annex H), predictors 1-7,
  the point transform Pt, restart intervals of whole MCU rows, one scan of
  all components at their sampling factors; vectorised for large images;
- ``cut_progressive``: a progressive file's first k scans and an EOI, what
  a download cut at a scan boundary leaves;
- the coefficients to code: ``pixel_coefficients`` (a float DCT of pixels,
  quantised), or ``file_coefficients``, a JPEG's own, read by the port's
  ``akari_torch.core.jpeg.read_scans`` (so that a file re-coded
  arithmetically decodes to the same pixels).

Usage from Python, e.g.
``arith_jpeg(*pixel_coefficients(px, [(2, 2), (1, 1), (1, 1)], 80), script=PROGRESSION)``.
"""

from __future__ import annotations

import heapq
import struct

import numpy as np

# zig-zag index -> natural (row-major) index of an 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])

# libjpeg's jpeg_simple_progression for three components (what PIL writes):
# (component indices, Ss, Se, Ah, Al)
PROGRESSION = [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
               ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
               ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
               ((0,), 1, 63, 1, 0)]
PROGRESSION_GREY = [((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((0,), 6, 63, 0, 2),
                    ((0,), 1, 63, 2, 1), ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0)]


def _segment(code, body):
    return b"\xff" + bytes([code]) + struct.pack(">H", len(body) + 2) + body


# T.81 Table D.2 as (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS); entry
# 113 is the fixed 0.5 estimate of T.851, used for signs
_QE = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0),
    (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1), (0x3f25, 36, 16, 0),
    (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0), (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0),
    (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0),
    (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0),
    (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0),
    (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0), (0x119c, 74, 76, 0),
    (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0), (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
    (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0),
]
# per state: Qe, the state after an LPS (with the MPS bit flipped on a
# switch) and after an MPS, as jaricom.c packs them
_LPS = [nl | (sw << 7) for _, nl, _, sw in _QE]
_MPS = [nm for _, _, nm, _ in _QE]
_Q = [qe for qe, _, _, _ in _QE]


class _QM:
    """The QM encoder (T.81 D.1, jcarith.c arith_encode / finish_pass):
    binary decisions in statistics bins ``st[i]`` (bit 7 the MPS, bits 0-6
    the state) to bytes, carries resolved over stacked 0xFF bytes."""

    def __init__(self):
        self.a, self.c, self.ct = 0x10000, 0, 11
        self.sc = self.zc = 0
        self.buffer = -1
        self.out = bytearray()

    def _flush_pending(self, temp):
        """One byte ready in ``temp`` (bits 19+ of C): resolve the carry."""
        out = self.out
        if temp > 0xFF:  # carry over the stacked 0xFF bytes
            if self.buffer >= 0:
                out += bytes(self.zc)
                self.zc = 0
                out.append(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    out.append(0)
            self.zc += self.sc
            self.sc = 0
            self.buffer = temp & 0xFF
        elif temp == 0xFF:
            self.sc += 1
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                out += bytes(self.zc)
                self.zc = 0
                out.append(self.buffer)
            if self.sc:
                out += bytes(self.zc)
                self.zc = 0
                out += b"\xff\x00" * self.sc
                self.sc = 0
            self.buffer = temp & 0xFF

    def encode(self, st, i, val):
        sv = st[i]
        s = sv & 0x7F
        qe = _Q[s]
        a = self.a - qe
        if val != (sv >> 7):  # the LPS
            if a >= qe:
                self.c += a
                a = qe
            st[i] = (sv & 0x80) ^ _LPS[s]
        else:
            if a >= 0x8000:
                self.a = a
                return
            if a < qe:
                self.c += a
                a = qe
            st[i] = (sv & 0x80) ^ _MPS[s]
        c, ct = self.c, self.ct
        while True:  # renormalise, bytes out
            a <<= 1
            c <<= 1
            ct -= 1
            if ct == 0:
                self._flush_pending(c >> 19)
                c &= 0x7FFFF
                ct = 8
            if a >= 0x8000:
                break
        self.a, self.c, self.ct = a, c, ct

    def finish(self):
        """T.81 D.1.8 termination; returns the coded bytes."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        out = self.out
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                out += bytes(self.zc)
                self.zc = 0
                out.append(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    out.append(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                out += bytes(self.zc)
                self.zc = 0
                out.append(self.buffer)
            if self.sc:
                out += bytes(self.zc)
                self.zc = 0
                out += b"\xff\x00" * self.sc
                self.sc = 0
        if self.c & 0x7FFF800:  # final bytes, unless zeros
            out += bytes(self.zc)
            out.append((self.c >> 19) & 0xFF)
            if (self.c >> 19) & 0xFF == 0xFF:
                out.append(0)
            if self.c & 0x7F800:
                out.append((self.c >> 11) & 0xFF)
                if (self.c >> 11) & 0xFF == 0xFF:
                    out.append(0)
        return bytes(out)


def _magnitude(enc, st, i, v, x2=None):
    """Figures F.8 / F.9: v - 1 >= 0 coded from bin i (the first decision
    there; AC models code a second one there too, then move to ``x2``)."""
    m = 0
    v -= 1
    if v:
        enc.encode(st, i, 1)
        m = 1
        v2 = v >> 1
        if x2 is None:
            i = 20
            while v2:
                enc.encode(st, i, 1)
                m <<= 1
                i += 1
                v2 >>= 1
        elif v2:
            enc.encode(st, i, 1)
            m <<= 1
            i = x2
            v2 >>= 1
            while v2:
                enc.encode(st, i, 1)
                m <<= 1
                i += 1
                v2 >>= 1
    enc.encode(st, i, 0)
    i += 14
    m >>= 1
    while m:
        enc.encode(st, i, 1 if m & v else 0)
        m >>= 1


class _ScanCoder:
    """One scan's statistics and DC state (jcarith.c), reset by ``reset``."""

    def __init__(self, tables, cond, dc, ac):
        self.tables, self.cond, self.dc, self.ac = tables, cond, dc, ac
        self.reset()

    def reset(self):
        self.enc = _QM()
        self.dc_stats = {t[0]: bytearray(64) for t in self.tables} if self.dc else {}
        self.ac_stats = {t[1]: bytearray(256) for t in self.tables} if self.ac else {}
        self.last_dc = [0] * len(self.tables)
        self.ctx = [0] * len(self.tables)
        self.fixed = bytearray([113])

    def dc_first(self, j, m):
        """Figure F.4: the DC value m (after the point transform) of scan
        component j."""
        enc, tbl = self.enc, self.tables[j][0]
        st, s0 = self.dc_stats[tbl], self.ctx[j]
        v = m - self.last_dc[j]
        if v == 0:
            enc.encode(st, s0, 0)
            self.ctx[j] = 0
            return
        self.last_dc[j] = m
        enc.encode(st, s0, 1)
        sign = int(v < 0)
        enc.encode(st, s0 + 1, sign)
        v = abs(v)
        self.ctx[j] = 8 if sign else 4
        mag = v - 1
        top = 1 << (mag.bit_length() - 1) if mag else 0
        lo, hi = self.cond[tbl], self.cond[16 + tbl]
        if top < ((1 << lo) >> 1):
            self.ctx[j] = 0
        elif top > ((1 << hi) >> 1):
            self.ctx[j] += 8
        _magnitude(enc, st, s0 + 2 + sign, v)

    def ac_first(self, j, zz, ss, se, al):
        """Figure G.3 / F.5: coefficients ss..se (zig-zag values ``zz``)
        after the point transform al (magnitudes shifted toward zero)."""
        enc, tbl = self.enc, self.tables[j][1]
        st, kk = self.ac_stats[tbl], self.cond[32 + tbl]
        mags = [abs(int(x)) >> al for x in zz]
        ke = se
        while ke > 0 and not mags[ke]:
            ke -= 1
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            enc.encode(st, i, 0)  # not the end of the block
            while not mags[k]:
                enc.encode(st, i + 1, 0)
                i += 3
                k += 1
            enc.encode(st, i + 1, 1)
            enc.encode(self.fixed, 0, int(zz[k] < 0))
            _magnitude(enc, st, i + 2, mags[k], 189 if k <= kk else 217)
            k += 1
        if k <= se:
            enc.encode(st, 3 * (k - 1), 1)

    def ac_refine(self, j, zz, ss, se, ah, al):
        """Figure G.10: the next bit of coefficients ss..se."""
        enc, tbl = self.enc, self.tables[j][1]
        st = self.ac_stats[tbl]
        mags = [abs(int(x)) >> al for x in zz]
        ke = se
        while ke > 0 and not mags[ke]:
            ke -= 1
        kex = ke
        while kex > 0 and not (abs(int(zz[kex])) >> ah):
            kex -= 1
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            if k > kex:
                enc.encode(st, i, 0)
            while True:
                v = mags[k]
                if v:
                    if v >> 1:  # nonzero before: its next bit
                        enc.encode(st, i + 2, v & 1)
                    else:
                        enc.encode(st, i + 1, 1)
                        enc.encode(self.fixed, 0, int(zz[k] < 0))
                    break
                enc.encode(st, i + 1, 0)
                i += 3
                k += 1
            k += 1
        if k <= se:
            enc.encode(st, 3 * (k - 1), 1)


def _frame_bytes(sof, size, comps, qtables, app):
    h, w = size
    out = b"\xff\xd8" + app
    for tq in sorted(qtables):
        q = np.asarray(qtables[tq])[ZIGZAG]
        out += _segment(0xDB, bytes([tq]) + bytes(q.astype(np.uint8)) if q.max() < 256
                        else bytes([0x10 | tq]) + q.astype(">u2").tobytes())
    body = struct.pack(">BHHB", 8, h, w, len(comps))
    body += b"".join(bytes([cid, hs << 4 | vs, tq]) for cid, hs, vs, tq in comps)
    return out + _segment(sof, body)


def _mcu_blocks(comps, idx, size):
    """The blocks of a scan of components ``idx`` in coding order:
    (scan component, [row, col] of its plane) per block, MCU by MCU."""
    h, w = size
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    if len(idx) == 1:  # one block an MCU, over the component's own blocks
        c = comps[idx[0]]
        bw = -(-(-(-w * c[1] // hmax)) // 8)
        bh = -(-(-(-h * c[2] // vmax)) // 8)
        for by in range(bh):
            for bx in range(bw):
                yield [(0, by, bx)]
        return
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    for my in range(mcuy):
        for mx in range(mcux):
            mcu = []
            for j, ci in enumerate(idx):
                _, hs, vs, _ = comps[ci]
                mcu += [(j, my * vs + v, mx * hs + u) for v in range(vs) for u in range(hs)]
            yield mcu


def _arith_scan(job):
    """One scan's coded bytes (restart markers included) from its
    components' zig-zag coefficients: ``arith_jpeg``'s work, a scan a job."""
    zz, comps, idx, size, tables, cond, ss, se, ah, al, seq, restart = job
    coder = _ScanCoder(tables, cond, dc=seq or (ss == 0 and ah == 0), ac=seq or ss > 0)
    data, n = b"", 0
    for mcu in _mcu_blocks(comps, idx, size):
        if restart and n and n % restart == 0:
            data += coder.enc.finish() + bytes([0xFF, 0xD0 + (n // restart - 1) % 8])
            coder.reset()
        n += 1
        for j, by, bx in mcu:
            blk = zz[j][by, bx]
            if seq:
                coder.dc_first(j, int(blk[0]))
                coder.ac_first(j, blk, 1, 63, 0)
            elif ss == 0 and ah == 0:
                coder.dc_first(j, int(blk[0]) >> al)
            elif ss == 0:
                coder.enc.encode(coder.fixed, 0, (int(blk[0]) >> al) & 1)
            elif ah == 0:
                coder.ac_first(j, blk, ss, se, al)
            else:
                coder.ac_refine(j, blk, ss, se, ah, al)
    return data + coder.enc.finish()


def arith_jpeg(coefs, comps, size, qtables, script=None, restart=0, dac=(), mapper=map):
    """An arithmetic-coded JPEG of quantised coefficients.

    coefs: per component int [rows, cols, 64] natural-order blocks covering
    its MCU grid; comps: [(id, h, v, tq)]; size: (height, width); qtables:
    {tq: [64] natural-order values}; script: None for one sequential scan of
    every component (SOF9), else progressive scans (SOF10) as [(component
    indices, Ss, Se, Ah, Al)], e.g. ``PROGRESSION``; restart: the restart
    interval in MCUs (0: none); dac: [(class 0 DC / 1 AC, table, value)]
    DAC entries (DC value U << 4 | L, AC value K) of the conditioning
    tables, 0 for the first component and 1 for the others; mapper: a
    ``map`` over the scans' jobs (a process pool's codes the scans of a
    large image in parallel)."""
    tables = [(0, 0)] + [(1, 1)] * (len(comps) - 1)
    cond = [0] * 16 + [1] * 16 + [5] * 16
    for tc, tb, val in dac:
        if tc:
            cond[32 + tb] = val
        else:
            cond[tb], cond[16 + tb] = val & 15, val >> 4
    out = _frame_bytes(0xC9 if script is None else 0xCA, size, comps, qtables, b"")
    if dac:
        out += _segment(0xCC, b"".join(bytes([tc << 4 | tb, val]) for tc, tb, val in dac))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    zz = [np.asarray(c)[..., ZIGZAG].astype(np.int32) for c in coefs]
    scans = script or [(tuple(range(len(comps))), 0, 63, 0, 0)]
    jobs = [([zz[ci] for ci in idx], comps, idx, size, [tables[ci] for ci in idx], cond, ss, se,
             ah, al, script is None, restart) for idx, ss, se, ah, al in scans]
    for (idx, ss, se, ah, al), data in zip(scans, mapper(_arith_scan, jobs)):
        sos = bytes([len(idx)]) + b"".join(
            bytes([comps[ci][0], tables[ci][0] << 4 | tables[ci][1]]) for ci in idx)
        out += _segment(0xDA, sos + bytes([ss, se, ah << 4 | al])) + data
    return out + b"\xff\xd9"


# ------------------------------------------------------------------ lossless

def _huffman_table(counts):
    """T.81 Annex K.2 code lengths (at most 16 bits, no all-ones code) for
    symbol counts [17] -> DHT body of table 0 (class 0) and the code and
    length of each symbol."""
    freq = [(int(n), s) for s, n in enumerate(counts) if n] + [(1, 256)]  # 256: reserved
    heap = [(f, i, [s]) for i, (f, s) in enumerate(freq)]
    heapq.heapify(heap)
    size = {s: 0 for _, s in freq}
    tick = len(heap)
    while len(heap) > 1:
        f1, _, a = heapq.heappop(heap)
        f2, _, b = heapq.heappop(heap)
        for s in a + b:
            size[s] += 1
        heapq.heappush(heap, (f1 + f2, tick, a + b))
        tick += 1
    bits = [0] * 33
    for n in size.values():
        bits[n] += 1
    for i in range(32, 16, -1):  # K.3: limit to 16 bits
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1  # drop the reserved symbol's code
    order = sorted((size[s], s) for s in size if s < 256)
    syms = [s for _, s in order]
    codes, lengths = np.zeros(17, np.int64), np.zeros(17, np.int64)
    code, k = 0, 0
    for ln in range(1, 17):
        for _ in range(bits[ln]):
            codes[syms[k]], lengths[syms[k]] = code, ln
            code += 1
            k += 1
        code <<= 1
    body = bytes([0]) + bytes(bits[1:17]) + bytes(syms)
    return body, codes, lengths


def _pack_bits(vals, lens, chunk=1 << 21):
    """Fields (value, bit count) -> bytes, most significant bit first, the
    last byte padded with 1 bits, 0xFF stuffed with 0x00 (a few million
    fields at a time)."""
    keep = lens > 0
    vals, lens = vals[keep].astype(np.int64), lens[keep].astype(np.int64)
    parts = []
    for i in range(0, lens.size, chunk):
        v, n = vals[i:i + chunk], lens[i:i + chunk]
        field = np.repeat(np.arange(n.size), n)
        pos = np.arange(field.size) - np.repeat(np.cumsum(n) - n, n)
        parts.append(((v[field] >> (n[field] - 1 - pos)) & 1).astype(np.uint8))
    bits = np.concatenate(parts + [np.ones(-sum(p.size for p in parts) % 8, np.uint8)])
    packed = np.packbits(bits)
    ff = np.flatnonzero(packed == 0xFF)
    return np.insert(packed, ff + 1, 0).tobytes()


def lossless_jpeg(planes, comps, size, psv, pt=0, restart_rows=0, app=b""):
    """A lossless Huffman JPEG (SOF3) of one scan of every component.

    planes: per component uint8 [height, width] samples at its sampling
    (the component's own size); comps: [(id, h, v)]; size: (height,
    width); psv: the predictor, 1-7; pt: the point transform (the decoder
    gives back samples >> pt << pt); restart_rows: a restart marker every
    this many MCU rows (0: none). Each MCU row's first row starts from
    2^(7 - pt) after a restart, as the decoder's does."""
    h, w = size
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    interleaved = len(comps) > 1
    mcux, mcuy = (-(-w // hmax), -(-h // vmax)) if interleaved else (w, h)
    diffs = []
    for (cid, hs, vs), plane in zip(comps, planes):
        x = np.asarray(plane).astype(np.int64) >> pt
        ch, cw = x.shape
        first = np.zeros(ch, bool)  # rows predicted as a first row
        step = vs if interleaved else 1
        first[::step * (restart_rows or mcuy + 1)] = True
        first[0] = True
        ra = np.concatenate([np.zeros((ch, 1), np.int64), x[:, :-1]], 1)
        rb = np.concatenate([np.zeros((1, cw), np.int64), x[:-1]], 0)
        rc = np.concatenate([np.zeros((ch, 1), np.int64), rb[:, :-1]], 1)
        pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[psv].copy()
        pred[:, 0] = rb[:, 0]
        pred[first, 0] = 1 << (7 - pt)
        pred[first, 1:] = ra[first, 1:]
        d = ((x - pred + 32768) % 65536) - 32768
        if interleaved:  # dummy samples past the edges code a zero difference
            full = np.zeros((mcuy * vs, mcux * hs), np.int64)
            full[:ch, :cw] = d
            d = full.reshape(mcuy, vs, mcux, hs).transpose(0, 2, 1, 3).reshape(mcuy, mcux, -1)
        else:
            d = d.reshape(mcuy, mcux, 1)
        diffs.append(d)
    d = np.concatenate(diffs, axis=2)  # [MCU rows, MCUs, samples of an MCU]
    mag = np.abs(d)
    cat = np.where(mag > 0, np.floor(np.log2(np.maximum(mag, 1))).astype(np.int64) + 1, 0)
    cat[d == -32768] = 16
    extra = np.where(d < 0, d + (1 << np.minimum(cat, 15)) - 1, d)
    dht, codes, lengths = _huffman_table(np.bincount(cat.ravel(), minlength=17))
    out = _frame_bytes(0xC3, size, [(c[0], c[1], c[2], 0) for c in comps], {}, app)
    out += _segment(0xC4, dht)
    if restart_rows:
        out += _segment(0xDD, struct.pack(">H", restart_rows * mcux))
    sos = bytes([len(comps)]) + b"".join(bytes([c[0], 0]) for c in comps)
    out += _segment(0xDA, sos + bytes([psv, 0, pt]))
    seg_rows = restart_rows or mcuy
    for n, r0 in enumerate(range(0, mcuy, seg_rows)):
        if n:
            out += bytes([0xFF, 0xD0 + (n - 1) % 8])
        c, e = cat[r0:r0 + seg_rows].ravel(), extra[r0:r0 + seg_rows].ravel()
        ebits = np.where(c == 16, 0, c)
        vals = np.stack([codes[c], e & ((1 << ebits) - 1)], 1).ravel()
        lens = np.stack([lengths[c], ebits], 1).ravel()
        out += _pack_bits(vals, lens)
    return out + b"\xff\xd9"


# ------------------------------------------------------------------ others

def _scan_ends(data):
    """The end of each scan of a JPEG (the position of the marker after
    its entropy-coded data)."""
    ends, pos = [], 2
    while pos + 4 <= len(data) and data[pos + 1] != 0xD9:
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] == 0xDA:
            while not (data[end] == 0xFF and data[end + 1] not in (0, *range(0xD0, 0xD8))):
                end += 1
            ends.append(end)
        pos = end
    return ends


def cut_progressive(data, k):
    """A JPEG's bytes up to the end of its k-th scan, then an EOI."""
    ends = _scan_ends(data)
    if len(ends) < k:
        raise ValueError(f"the file holds fewer than {k} scans")
    return data[:ends[k - 1]] + b"\xff\xd9"


def scan_count(data):
    """The number of scans of a JPEG."""
    return len(_scan_ends(data))


def pixel_coefficients(px, sampling, quality):
    """[H, W, 3] (YCbCr from RGB, JFIF) or [H, W] uint8 pixels -> (coefs,
    comps, size, qtables) for ``arith_jpeg``: components box-downsampled to
    ``sampling`` [(h, v)], a float DCT quantised by the Annex K tables
    scaled to ``quality`` as libjpeg scales them (luma table 0, chroma 1)."""
    px = np.asarray(px, np.float64)
    size = px.shape[:2]
    if px.ndim == 3:
        r, g, b = px[..., 0], px[..., 1], px[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    else:
        planes = [px]
    lum = [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57,
           69, 56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55,
           64, 81, 104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100,
           103, 99]
    chrom = np.full(64, 99)
    chrom[:4], chrom[8:12], chrom[16:19], chrom[24:26] = [17, 18, 24, 47], [18, 21, 26, 66], \
        [24, 26, 56], [47, 66]
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    qtables = {i: np.clip((np.asarray(t) * scale + 50) // 100, 1, 255).astype(np.int64)
               for i, t in enumerate((lum, chrom))}
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    mcux, mcuy = -(-size[1] // (8 * hmax)), -(-size[0] // (8 * vmax))
    k = np.arange(8)
    basis = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * np.where(k == 0, np.sqrt(
        0.5), 1.0)[:, None] / 2
    coefs, comps = [], []
    for i, (plane, (hs, vs)) in enumerate(zip(planes, sampling)):
        fy, fx = vmax // vs, hmax // hs
        ph, pw = -(-size[0] // fy), -(-size[1] // fx)
        pad = np.pad(plane, ((0, ph * fy - size[0]), (0, pw * fx - size[1])), mode="edge")
        small = pad.reshape(ph, fy, pw, fx).mean(axis=(1, 3))
        rows, cols = mcuy * vs * 8, mcux * hs * 8
        full = np.pad(small, ((0, rows - ph), (0, cols - pw)), mode="edge") - 128
        blocks = full.reshape(rows // 8, 8, cols // 8, 8).transpose(0, 2, 1, 3)
        dct = np.einsum("ux,abxy,vy->abuv", basis, blocks, basis).reshape(rows // 8, cols // 8, 64)
        q = qtables[min(i, 1)]
        coefs.append(np.round(dct / q).astype(np.int64))
        comps.append((i + 1, hs, vs, min(i, 1)))
    return coefs, comps, size, {i: t for i, t in qtables.items() if i < len(planes)}


def file_coefficients(data):
    """A Huffman JPEG's quantised coefficients as the port reads them ->
    (coefs, comps, size, qtables) for ``arith_jpeg``: re-coded, the file
    decodes to the same pixels."""
    from akari_torch.core.jpeg import read_scans

    frame, scans, _ = read_scans(data)
    comps, qtables = [], {}
    for i, (c, q) in enumerate(zip(frame["comps"], scans.latched)):
        comps.append((c["id"], c["h"], c["v"], i))
        qtables[i] = q
    return [p.astype(np.int64) for p in scans.planes], comps, (frame["h"], frame["w"]), qtables
