"""JPEG decoding without PIL: what Pillow's ``np.asarray(Image.open(f))``
gives (libjpeg-turbo under Pillow's defaults: the islow IDCT, fancy
upsampling, block smoothing; EXIF orientation not applied), bit for bit,
for baseline, extended sequential and progressive Huffman files.

* ``decode(data, name)`` / ``read_jpeg(path)``: the hand-written decoder of
  ``csrc/jpeg_decode.cpp`` through ctypes (which drops the GIL, so threads
  decode in parallel). It is built with ``g++ -O3 -shared -fPIC`` on first
  use into ``build/niw_jpeg/libniw_jpeg-<hash of source and flags>.so``
  (git-ignored), linked to a temporary name and moved into place with
  ``os.replace``, so processes that build at once never load a torn
  library. A failed build raises with the compiler's output.
* ``decode_plain(data, name)``: the same decoder in Python and numpy
  (Huffman symbol by symbol in Python; IDCT, upsampling and colour
  conversion vectorised). For small images: the tests and chip_smoke.py
  hold the two against each other.

Both give uint8 [H,W] (grayscale) or [H,W,3] (RGB), and raise ValueError
naming the file and the mode for what they do not decode: lossless,
hierarchical and arithmetic-coded files, 12-bit samples, 2 or 4
components (CMYK, YCCK), and a progressive file whose AC coefficients 1-9
were not all sent to their last bit (libjpeg smooths its blocks, which is
not reproduced: ``SMOOTHED_MODE``). A progressive frame keeps each
component's coefficients over all its scans (any scan script, restarts
inside them) and then takes the baseline's IDCT, upsampling and colour
path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

SIGNATURE = b"\xff\xd8\xff"
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PKG)
SOURCE = os.path.join(_PKG, "csrc", "jpeg_decode.cpp")
BUILD_DIR = os.path.join(_REPO, "build", "niw_jpeg")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_UNSUPPORTED, _CORRUPT = 1, 2
_MSG_LEN = 256

_lock = threading.Lock()
_lib = None


def library_path():
    """Where the decoder's build of the current source and flags lives."""
    with open(SOURCE, "rb") as fh:
        digest = hashlib.sha1(fh.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, "libniw_jpeg-{}.so".format(digest))


def _build(path):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "{}.tmp{}".format(path, os.getpid())
    try:
        run = subprocess.run(["g++"] + CXX_FLAGS + ["-o", tmp, SOURCE],
                             capture_output=True, text=True, timeout=300)
        if run.returncode != 0:
            raise RuntimeError("building the JPEG decoder failed (g++ exited {}):\n{}".format(
                run.returncode, run.stderr))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load():
    """The decoder's ctypes library, built first where it is missing."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.isfile(path):
                _build(path)
            lib = ctypes.CDLL(path)
            for fn in (lib.niw_jpeg_info, lib.niw_jpeg_decode):
                fn.restype = ctypes.c_int
            lib.niw_jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                          ctypes.POINTER(ctypes.c_int), ctypes.c_char_p,
                                          ctypes.c_int]
            lib.niw_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                            ctypes.c_char_p, ctypes.c_int]
            _lib = lib
        return _lib


def _error(status, name, msg):
    if status == _UNSUPPORTED:
        return ValueError("{}: a {} JPEG is not supported (the decoder reads baseline, "
                          "extended sequential and progressive Huffman, 8-bit, 1 or 3 "
                          "components)".format(name, msg))
    return ValueError("{}: corrupt JPEG: {}".format(name, msg))


def decode(data, name="<bytes>"):
    """uint8 [H,W] or [H,W,3] of the JPEG ``data`` (bytes), through the C++
    decoder; ``name`` goes into the error messages."""
    lib = load()
    data = bytes(data)
    hwc = (ctypes.c_int * 3)()
    msg = ctypes.create_string_buffer(_MSG_LEN)
    status = lib.niw_jpeg_info(data, len(data), hwc, msg, _MSG_LEN)
    if status:
        raise _error(status, name, msg.value.decode())
    H, W, C = hwc
    out = np.empty((H, W, C), np.uint8)
    status = lib.niw_jpeg_decode(data, len(data), out.ctypes.data, msg, _MSG_LEN)
    if status:
        raise _error(status, name, msg.value.decode())
    return out[..., 0] if C == 1 else out


def read_jpeg(path):
    """``decode`` of the file at ``path``."""
    with open(path, "rb") as fh:
        return decode(fh.read(), path)


# ------------------------------------------------------------- plain version

_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44,
    51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63] + [63] * 16)
_SOF_MODES = {0xC3: "lossless (SOF3)",
              0xC5: "hierarchical (SOF5)", 0xC6: "hierarchical (SOF6)",
              0xC7: "hierarchical (SOF7)", 0xC9: "arithmetic-coded (SOF9)",
              0xCA: "arithmetic-coded (SOF10)", 0xCB: "arithmetic-coded (SOF11)",
              0xCD: "arithmetic-coded (SOF13)", 0xCE: "arithmetic-coded (SOF14)",
              0xCF: "arithmetic-coded (SOF15)", 0xCC: "arithmetic-coded (DAC)"}


# libjpeg smooths the blocks of a progressive image whose AC coefficients
# 1-9 were not all sent to their last bit (jdcoefct.c's smoothing_ok, on by
# default and so under Pillow); that smoothing is not reproduced here
SMOOTHED_MODE = "block-smoothed progressive (SOF2: AC coefficients 1-9 not all fully sent)"


class _Corrupt(Exception):
    pass


def _huffman_table(counts, vals, dc):
    """A 16-bit lookahead list: (code length << 8) | value, 0 for no code."""
    table = [0] * 65536
    code = k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            table[lo:lo + (1 << (16 - length))] = [(length << 8) | vals[k]] * (1 << (16 - length))
            code += 1
            k += 1
        if code >= 1 << length:
            raise _Corrupt("bad Huffman table")
        code <<= 1
    if dc and any(v > 15 for v in vals):
        raise _Corrupt("bad DC Huffman table")
    return table


def _segments(data, pos):
    """(the unstuffed entropy-coded segments of the scan at ``pos``, split at
    its restart markers, and the position of the marker that ends it)."""
    segs, cur = [], bytearray()
    n = len(data)
    while True:
        j = data.find(b"\xff", pos)
        if j < 0:
            raise _Corrupt("the scan runs past the end of the file")
        cur += data[pos:j]
        q = j + 1
        while q < n and data[q] == 0xFF:
            q += 1
        if q >= n:
            raise _Corrupt("the scan runs past the end of the file")
        if data[q] == 0x00:
            cur.append(0xFF)
            pos = q + 1
        elif 0xD0 <= data[q] <= 0xD7:
            segs.append((bytes(cur), data[q] - 0xD0))
            cur = bytearray()
            pos = q + 1
        else:
            segs.append((bytes(cur), None))
            return segs, j


class _Bits:
    def __init__(self, seg):
        self.data = seg + b"\x00" * 8
        self.p = 0

    def huff(self, table):
        p = self.p
        q = p >> 3
        e = table[(int.from_bytes(self.data[q:q + 3], "big") >> (8 - (p & 7))) & 0xFFFF]
        if not e:
            raise _Corrupt("bad Huffman code")
        self.p = p + (e >> 8)
        return e & 0xFF

    def raw(self, s):
        """The next ``s`` bits as an unsigned number."""
        p = self.p
        q = p >> 3
        v = (int.from_bytes(self.data[q:q + 4], "big") >> (32 - (p & 7) - s)) & ((1 << s) - 1)
        self.p = p + s
        return v

    def receive_bit(self):
        p = self.p
        self.p = p + 1
        return (self.data[p >> 3] >> (7 - (p & 7))) & 1

    def receive(self, s):
        p = self.p
        q = p >> 3
        v = (int.from_bytes(self.data[q:q + 4], "big") >> (32 - (p & 7) - s)) & ((1 << s) - 1)
        self.p = p + s
        return v - (1 << s) + 1 if v < 1 << (s - 1) else v


def _parse(data):
    """The frame header, tables and every scan's coefficients of ``data``."""
    if data[:2] != b"\xff\xd8":
        raise _Corrupt("not a JPEG")
    fr = dict(quant={}, dc={}, ac={}, restart=0, jfif=False, adobe=None, comps=None)
    pos, n = 2, len(data)
    while pos < n:
        j = data.find(b"\xff", pos)
        if j < 0:
            break
        q = j + 1
        while q < n and data[q] == 0xFF:
            q += 1
        if q >= n:
            break
        m, pos = data[q], q + 1
        if m == 0 or 0xD0 <= m <= 0xD7 or m == 0x01:
            continue
        if m == 0xD9:
            break
        if m in _SOF_MODES:
            raise NotImplementedError(_SOF_MODES[m])
        length = int.from_bytes(data[pos:pos + 2], "big")
        seg, end = data[pos + 2:pos + length], pos + length
        if m in (0xC0, 0xC1, 0xC2):
            if seg[0] != 8:
                raise NotImplementedError("{}-bit samples (SOF{})".format(seg[0], m - 0xC0))
            H, W, nc = int.from_bytes(seg[1:3], "big"), int.from_bytes(seg[3:5], "big"), seg[5]
            if nc not in (1, 3):
                raise NotImplementedError("{}-component".format(nc))
            if H == 0:
                raise NotImplementedError("a height set by a DNL marker")
            comps = [dict(id=seg[6 + 3 * i], h=seg[7 + 3 * i] >> 4, v=seg[7 + 3 * i] & 15,
                          tq=seg[8 + 3 * i]) for i in range(nc)]
            fr.update(H=H, W=W, comps=comps, max_h=max(c["h"] for c in comps),
                      max_v=max(c["v"] for c in comps), progressive=m == 0xC2)
            for c in comps:
                if fr["max_h"] % c["h"] or fr["max_v"] % c["v"]:
                    raise NotImplementedError("fractional sampling factors")
                c["dw"] = -(-W * c["h"] // fr["max_h"])
                c["dh"] = -(-H * c["v"] // fr["max_v"])
                mcus_w = -(-W // (8 * fr["max_h"]))
                mcus_h = -(-H // (8 * fr["max_v"]))
                c["coef"] = np.zeros((mcus_h * c["v"], mcus_w * c["h"], 64), np.int16)
                c["coef_bits"] = [-1] * 64
        elif m == 0xC4:
            k = 0
            while k < len(seg):
                tc, th = seg[k] >> 4, seg[k] & 15
                counts = list(seg[k + 1:k + 17])
                vals = list(seg[k + 17:k + 17 + sum(counts)])
                fr["ac" if tc else "dc"][th] = _huffman_table(counts, vals, tc == 0)
                k += 17 + sum(counts)
        elif m == 0xDB:
            k = 0
            while k < len(seg):
                pq, tq = seg[k] >> 4, seg[k] & 15
                raw = (np.frombuffer(seg[k + 1:k + 129], ">u2") if pq
                       else np.frombuffer(seg[k + 1:k + 65], np.uint8))
                table = np.zeros(64, np.int64)
                table[_NATURAL[:64]] = raw.astype(np.int64)
                fr["quant"][tq] = table.astype(np.int16).astype(np.int64)
                k += 1 + 64 * (pq + 1)
        elif m == 0xDD:
            fr["restart"] = int.from_bytes(seg[:2], "big")
        elif m == 0xE0 and len(seg) >= 14 and seg[:5] == b"JFIF\x00":
            fr["jfif"] = True
        elif m == 0xEE and len(seg) >= 12 and seg[:5] == b"Adobe":
            fr["adobe"] = seg[11]
        elif m == 0xDA:
            if fr["comps"] is None:
                raise _Corrupt("a scan before the frame")
            ns = seg[0]
            scan = [(next(c for c in fr["comps"] if c["id"] == seg[1 + 2 * i]),
                     seg[2 + 2 * i] >> 4, seg[2 + 2 * i] & 15) for i in range(ns)]
            ss, se, ah, al = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns] >> 4, \
                seg[3 + 2 * ns] & 15
            for c, _, _ in scan:      # libjpeg latches the table at a component's first scan
                c.setdefault("qt", fr["quant"][c["tq"]])
            segs, end = _segments(data, end)
            if fr["progressive"]:
                _decode_progressive_scan(fr, scan, segs, ss, se, ah, al)
            else:
                _decode_scan(fr, [(c, fr["dc"][td], fr["ac"][ta]) for c, td, ta in scan], segs)
        pos = end
    if fr["comps"] is None:
        raise _Corrupt("no frame")
    if fr["progressive"] and any(b != 0 for c in fr["comps"] for b in c["coef_bits"][1:10]):
        raise NotImplementedError(SMOOTHED_MODE)
    return fr


def _decode_scan(fr, scan, segs):
    per_row, n_mcus, blocks_of = _scan_mcus(fr, scan)
    interval = fr["restart"] or n_mcus
    for m0 in range(0, n_mcus, interval):
        seg, rst = segs[m0 // interval]
        if m0 + interval < n_mcus and rst != (m0 // interval) % 8:
            raise _Corrupt("bad restart marker")
        bits = _Bits(seg)
        preds = [0] * len(scan)
        for m in range(m0, min(m0 + interval, n_mcus)):
            for i, by, bx in blocks_of(*divmod(m, per_row)):
                c, dc, ac = scan[i]
                block = c["coef"][by, bx]
                s = bits.huff(dc)
                preds[i] += bits.receive(s) if s else 0
                block[0] = np.int64(preds[i]).astype(np.int16)
                k = 1
                while k < 64:
                    rs = bits.huff(ac)
                    r, s = rs >> 4, rs & 15
                    if s:
                        k += r
                        block[_NATURAL[k]] = bits.receive(s)
                    elif r != 15:
                        break
                    else:
                        k += 15
                    k += 1
    for c, _, _ in scan:
        c["decoded"] = True


def _scan_mcus(fr, scan):
    """(blocks per MCU row, MCU count, each MCU's blocks as [(component
    index in the scan, block row, block col)] of MCU (row, col))."""
    if len(scan) == 1:
        c = scan[0][0]
        per_row = -(-c["dw"] // 8)
        return per_row, per_row * -(-c["dh"] // 8), lambda mrow, mcol: [(0, mrow, mcol)]
    per_row = -(-fr["W"] // (8 * fr["max_h"]))

    def blocks(mrow, mcol):
        return [(i, mrow * c["v"] + y, mcol * c["h"] + x) for i, (c, _, _) in enumerate(scan)
                for y in range(c["v"]) for x in range(c["h"])]
    return per_row, per_row * -(-fr["H"] // (8 * fr["max_v"])), blocks


def _decode_progressive_scan(fr, scan, segs, ss, se, ah, al):
    """One scan of a progressive frame into the components' coefficients
    (jdphuff.c: DC first and refine, AC first and refine with EOB runs and
    correction bits; every count restarts at a restart marker)."""
    dc_band = ss == 0
    if ((se != 0) if dc_band else (ss > se or se > 63 or len(scan) != 1)) \
            or (ah and al != ah - 1) or al > 13:
        raise _Corrupt("bad progression (Ss={} Se={} Ah={} Al={})".format(ss, se, ah, al))
    for c, _, _ in scan:
        for k in range(ss, se + 1):
            c["coef_bits"][k] = al
        if dc_band:
            c["decoded"] = True
    tables = [fr["dc"][td] if dc_band else fr["ac"][ta] for _, td, ta in scan] \
        if not (dc_band and ah) else None
    p1, m1 = 1 << al, -1 << al
    per_row, n_mcus, blocks_of = _scan_mcus(fr, scan)
    interval = fr["restart"] or n_mcus
    for m0 in range(0, n_mcus, interval):
        seg, rst = segs[m0 // interval]
        if m0 + interval < n_mcus and rst != (m0 // interval) % 8:
            raise _Corrupt("bad restart marker")
        bits = _Bits(seg)
        preds = [0] * len(scan)
        eobrun = 0
        for m in range(m0, min(m0 + interval, n_mcus)):
            for i, by, bx in blocks_of(*divmod(m, per_row)):
                block = scan[i][0]["coef"][by, bx]
                if dc_band and not ah:
                    s = bits.huff(tables[i])
                    preds[i] += bits.receive(s) if s else 0
                    block[0] = _wrap16(preds[i] << al)
                elif dc_band:
                    if bits.receive_bit():
                        block[0] = _wrap16(int(block[0]) | p1)
                elif not ah:
                    eobrun = _ac_first(bits, tables[i], block, ss, se, al, eobrun)
                else:
                    eobrun = _ac_refine(bits, tables[i], block, ss, se, p1, m1, eobrun)


def _wrap16(v):
    return (v + 0x8000) % 0x10000 - 0x8000


def _ac_first(bits, table, block, ss, se, al, eobrun):
    if eobrun:
        return eobrun - 1
    k = ss
    while k <= se:
        rs = bits.huff(table)
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            block[_NATURAL[k]] = _wrap16(bits.receive(s) << al)
        elif r == 15:
            k += 15
        else:
            eobrun = 1 << r
            if r:
                eobrun += bits.raw(r)
            return eobrun - 1
        k += 1
    return 0


def _refine(bits, block, pos, p1, m1):
    """A correction bit for the nonzero coefficient at ``pos``."""
    if bits.receive_bit():
        v = int(block[pos])
        if not v & p1:
            block[pos] = _wrap16(v + (p1 if v >= 0 else m1))


def _ac_refine(bits, table, block, ss, se, p1, m1, eobrun):
    k = ss
    if not eobrun:
        while k <= se:
            rs = bits.huff(table)
            r, s = rs >> 4, rs & 15
            if s:
                s = p1 if bits.receive_bit() else m1
            elif r != 15:
                eobrun = 1 << r
                if r:
                    eobrun += bits.raw(r)
                break
            while k <= se:     # past nonzero coefficients (refined) and r zero ones
                pos = _NATURAL[k]
                if block[pos]:
                    _refine(bits, block, pos, p1, m1)
                else:
                    if r == 0:
                        break
                    r -= 1
                k += 1
            if s:
                block[_NATURAL[k]] = s
            k += 1
    if eobrun:
        while k <= se:
            pos = _NATURAL[k]
            if block[pos]:
                _refine(bits, block, pos, p1, m1)
            k += 1
        eobrun -= 1
    return eobrun


def _idct_1d(x, pass1):
    """jidctint.c's 1-D pass over the 8 arrays ``x`` (int64), descaled."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * 4433
    tmp2 = z1 + z3 * -15137
    tmp3 = z1 + z2 * 6270
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * 9633
    tmp0, tmp1, tmp2, tmp3 = tmp0 * 2446, tmp1 * 16819, tmp2 * 25172, tmp3 * 12299
    z1, z2, z3, z4 = z1 * -7373, z2 * -20995, z3 * -16069 + z5, z4 * -3196 + z5
    tmp0, tmp1, tmp2, tmp3 = tmp0 + z1 + z3, tmp1 + z2 + z4, tmp2 + z2 + z3, tmp3 + z1 + z4
    sh = 11 if pass1 else 18
    out = [tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
           tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3]
    out = [(o + (1 << (sh - 1))) >> sh for o in out]
    if pass1:   # the workspace is int
        out = [o.astype(np.int32).astype(np.int64) for o in out]
    return out


def _range_limit(v):
    x = v & 1023
    return np.select([x < 128, x < 512, x < 896], [x + 128, 255, 0], x - 896).astype(np.uint8)


def _plane(c):
    """The component's decoded samples [rows, cols] (the padded MCU area)."""
    coef = c["coef"].astype(np.int64).reshape(*c["coef"].shape[:2], 8, 8)
    deq = coef * c["qt"].reshape(8, 8)
    cols = _idct_1d([deq[..., k, :] for k in range(8)], True)        # columns: over rows k
    ws = np.stack(cols, axis=-2)                                      # [..., 8 rows, 8 cols]
    rows = _idct_1d([ws[..., k] for k in range(8)], False)            # rows: over columns k
    pix = _range_limit(np.stack(rows, axis=-1))                       # [by, bx, 8, 8]
    by, bx = pix.shape[:2]
    return pix.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)


def _upsample(c, plane, H, W, max_h, max_v):
    hr, vr = max_h // c["h"], max_v // c["v"]
    dw, dh = c["dw"], c["dh"]
    p = plane.astype(np.int64)
    y, x = np.arange(H), np.arange(W)
    if hr == 1 and vr == 1:
        out = p[:H, :W]
    elif hr == 2 and vr == 1 and dw > 2:
        i = x >> 1
        nb = np.where(x & 1, np.minimum(i + 1, dw - 1), np.maximum(i - 1, 0))
        out = (3 * p[:H, i] + p[:H, nb] + np.where(x & 1, 2, 1)) >> 2
    elif hr == 1 and vr == 2:
        i = y >> 1
        nb = np.where(y & 1, np.minimum(i + 1, dh - 1), np.maximum(i - 1, 0))
        out = (3 * p[i, :W] + p[nb, :W] + np.where(y & 1, 2, 1)[:, None]) >> 2
    elif hr == 2 and vr == 2 and dw > 2:
        i = y >> 1
        nb = np.where(y & 1, np.minimum(i + 1, dh - 1), np.maximum(i - 1, 0))
        colsum = 3 * p[i, :dw] + p[nb, :dw]
        j = x >> 1
        nj = np.where(x & 1, np.minimum(j + 1, dw - 1), np.maximum(j - 1, 0))
        out = (3 * colsum[:, j] + colsum[:, nj] + np.where(x & 1, 7, 8)) >> 4
    else:
        out = p[(y // vr)[:, None], (x // hr)[None, :]]
    return out


def _ycc_tables():
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    return ((91881 * x + half) >> 16, (116130 * x + half) >> 16, -46802 * x, -22554 * x + half)


def decode_plain(data, name="<bytes>"):
    """``decode`` in Python and numpy (slow: for small images)."""
    data = bytes(data)
    try:
        fr = _parse(data)
    except NotImplementedError as e:
        raise _error(_UNSUPPORTED, name, str(e)) from None
    except (_Corrupt, KeyError, IndexError, StopIteration) as e:
        raise _error(_CORRUPT, name, str(e) or type(e).__name__) from None
    comps = fr["comps"]
    if not all(c.get("decoded") for c in comps):
        raise _error(_CORRUPT, name, "a component in no scan")
    H, W = fr["H"], fr["W"]
    chans = [_upsample(c, _plane(c), H, W, fr["max_h"], fr["max_v"])
             for c in comps]
    if len(chans) == 1:
        return chans[0].astype(np.uint8)
    if fr["jfif"]:
        rgb_space = False
    elif fr["adobe"] is not None:
        rgb_space = fr["adobe"] == 0
    else:
        rgb_space = [c["id"] for c in comps] == [82, 71, 66]
    if rgb_space:
        return np.stack(chans, -1).astype(np.uint8)
    cr_r, cb_b, cr_g, cb_g = _ycc_tables()
    yy, cb, cr = chans
    rgb = [yy + cr_r[cr], yy + ((cb_g[cb] + cr_g[cr]) >> 16), yy + cb_b[cb]]
    return np.clip(np.stack(rgb, -1), 0, 255).astype(np.uint8)
