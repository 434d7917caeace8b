"""A progressive JPEG writer for the tests: given quantized coefficients and
any scan script, the file libjpeg's progressive Huffman encoder
(jcphuff.c) would write for them, with flat Huffman tables that code every
symbol, so a test can hold the port's decoders against PIL's decode of
scan scripts that PIL and cv2 never write (DC scans per component,
spectral selection without successive approximation, several refinement
bits, bands split anywhere, restart intervals in every kind of scan).

    data = progressive_jpeg(size, coef, sampling, quant, script, restart=0)

``size``: the image's (H, W); ``coef``: per component int [block rows,
block cols, 64] in natural (row-major) order over the padded MCU area
(``blocks(size, sampling)`` gives the shapes); ``sampling``: per component
(h, v); ``quant``: a 64-entry table in natural order, one for all
components; ``script``: scans (component indices, Ss, Se, Ah, Al).
"""

from __future__ import annotations

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44,
    51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
DC_SYMBOLS = list(range(16))       # every size class, 5-bit codes
AC_SYMBOLS = list(range(255))      # every run / size byte, 8-bit codes


def _segment(marker, payload):
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload


def _dht(tc, th, symbols, length):
    counts = [0] * 16
    counts[length - 1] = len(symbols)
    return _segment(0xC4, bytes([tc << 4 | th] + counts + symbols))


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value, nbits):
        for i in range(nbits - 1, -1, -1):
            self.acc = self.acc << 1 | (value >> i) & 1
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc = self.n = 0

    def align(self):
        while self.n:
            self.put(1, 1)


class _Scan:
    """One scan's entropy coder (jcphuff.c's encode_mcu_* and emit_eobrun)."""

    def __init__(self, ss, se, ah, al):
        self.ss, self.se, self.ah, self.al = ss, se, ah, al
        self.bits = _Bits()
        self.restart()

    def restart(self):
        self.last_dc, self.eobrun, self.be = {}, 0, []

    def huff_dc(self, s):
        self.bits.put(DC_SYMBOLS.index(s), 5)

    def huff_ac(self, rs):
        self.bits.put(AC_SYMBOLS.index(rs), 8)

    def emit_eobrun(self):
        if self.eobrun:
            nbits = self.eobrun.bit_length() - 1
            self.huff_ac(nbits << 4)
            if nbits:
                self.bits.put(self.eobrun, nbits)
            self.eobrun = 0
            for b in self.be:
                self.bits.put(b, 1)
            self.be = []

    def dc_first(self, ci, block):
        v = int(block[0]) >> self.al
        diff, self.last_dc[ci] = v - self.last_dc.get(ci, 0), v
        s = abs(diff).bit_length()
        self.huff_dc(s)
        if s:
            self.bits.put(diff if diff > 0 else diff - 1 + (1 << s), s)

    def dc_refine(self, ci, block):
        self.bits.put(int(block[0]) >> self.al & 1, 1)

    def ac_first(self, ci, block):
        r = 0
        for k in range(self.ss, self.se + 1):
            v = int(block[ZIGZAG[k]])
            mag = abs(v) >> self.al
            if not mag:
                r += 1
                continue
            self.emit_eobrun()
            while r > 15:
                self.huff_ac(0xF0)
                r -= 16
            nbits = mag.bit_length()
            self.huff_ac(r << 4 | nbits)
            self.bits.put(mag if v > 0 else (~mag) & ((1 << nbits) - 1), nbits)
            r = 0
        if r:
            self.eobrun += 1
            if self.eobrun == 0x7FFF:
                self.emit_eobrun()

    def ac_refine(self, ci, block):
        absv = [abs(int(block[ZIGZAG[k]])) >> self.al for k in range(64)]
        eob = max([k for k in range(self.ss, self.se + 1) if absv[k] == 1], default=-1)
        r, br = 0, []
        for k in range(self.ss, self.se + 1):
            temp = absv[k]
            if not temp:
                r += 1
                continue
            while r > 15 and k <= eob:
                self.emit_eobrun()
                self.huff_ac(0xF0)
                r -= 16
                for b in br:
                    self.bits.put(b, 1)
                br = []
            if temp > 1:
                br.append(temp & 1)
                continue
            self.emit_eobrun()
            self.huff_ac(r << 4 | 1)
            self.bits.put(0 if block[ZIGZAG[k]] < 0 else 1, 1)
            for b in br:
                self.bits.put(b, 1)
            br, r = [], 0
        if r or br:
            self.eobrun += 1
            self.be += br
            if self.eobrun == 0x7FFF or len(self.be) > 900:
                self.emit_eobrun()

    def block(self, ci, block):
        if self.ss == 0:
            (self.dc_refine if self.ah else self.dc_first)(ci, block)
        else:
            (self.ac_refine if self.ah else self.ac_first)(ci, block)


def blocks(size, sampling):
    """Each component's (block rows, block cols) over the padded MCU area."""
    max_h = max(h for h, _ in sampling)
    max_v = max(v for _, v in sampling)
    mcu_rows, mcus_per_row = -(-size[0] // (8 * max_v)), -(-size[1] // (8 * max_h))
    return [(mcu_rows * v, mcus_per_row * h) for h, v in sampling]


def progressive_jpeg(size, coef, sampling, quant, script, restart=0):
    """The bytes of the progressive JPEG (module docstring)."""
    nc = len(coef)
    H, W = size
    max_h = max(h for h, _ in sampling)
    max_v = max(v for _, v in sampling)
    mcu_rows, mcus_per_row = -(-H // (8 * max_v)), -(-W // (8 * max_h))
    out = bytearray(b"\xff\xd8")
    out += _segment(0xDB, bytes([0]) + bytes(int(quant[ZIGZAG[k]]) for k in range(64)))
    out += _segment(0xC2, bytes([8]) + H.to_bytes(2, "big") + W.to_bytes(2, "big")
                    + bytes([nc]) + b"".join(bytes([i + 1, h << 4 | v, 0])
                                             for i, (h, v) in enumerate(sampling)))
    out += _dht(0, 0, DC_SYMBOLS, 5) + _dht(1, 0, AC_SYMBOLS, 8)
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, "big"))
    for comps, ss, se, ah, al in script:
        out += _segment(0xDA, bytes([len(comps)]) + b"".join(bytes([ci + 1, 0]) for ci in comps)
                        + bytes([ss, se, ah << 4 | al]))
        scan = _Scan(ss, se, ah, al)
        if len(comps) == 1:
            ci = comps[0]
            h, v = sampling[ci]
            rows = -(-(-(-H * v // max_v)) // 8)     # ceil(ceil(H * v / max_v) / 8)
            cols = -(-(-(-W * h // max_h)) // 8)
            mcus = [[(ci, by, bx)] for by in range(rows) for bx in range(cols)]
        else:
            mcus = [[(ci, my * sampling[ci][1] + y, mx * sampling[ci][0] + x) for ci in comps
                     for y in range(sampling[ci][1]) for x in range(sampling[ci][0])]
                    for my in range(mcu_rows) for mx in range(mcus_per_row)]
        for m, mcu in enumerate(mcus):
            if restart and m and m % restart == 0:
                scan.emit_eobrun()
                scan.bits.align()
                scan.bits.out += bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
                scan.restart()
            for ci, by, bx in mcu:
                scan.block(ci, coef[ci][by, bx])
        scan.emit_eobrun()
        scan.bits.align()
        out += scan.bits.out
    return bytes(out + b"\xff\xd9")
