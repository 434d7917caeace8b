// JPEG decoder for the host: what libjpeg(-turbo) gives under its defaults
// (the "islow" integer IDCT, fancy upsampling, block smoothing on), which is
// what Pillow's decoder asks of it, bit for bit.
//
// Covered: sequential Huffman (SOF0 and SOF1) and progressive Huffman (SOF2)
// with 8-bit samples, 1 or 3 components, any integral sampling factors
// (fancy h2v1, h1v2 and h2v2 as jdsample.c has them, box replication
// otherwise), interleaved and non-interleaved scans, restart intervals,
// DHT / DQT / DRI anywhere before the scan that needs them, APPn and COM
// segments skipped (APP0 "JFIF" and APP14 "Adobe" read for the colour space,
// as jdapimin.c guesses it). A progressive frame keeps every component's
// coefficients across its scans (jdphuff.c: DC first and refine, AC first
// and refine with EOB runs and correction bits, any scan script) and runs
// the IDCT once after the last; each component's quantization table is the
// one defined at its first scan, as libjpeg latches it. libjpeg smooths the
// blocks of a progressive image whose AC coefficients 1-9 were not all sent
// to their last bit (jdcoefct.c's smoothing_ok); such a file is refused
// rather than decoded without the smoothing. Lossless, hierarchical and
// arithmetic-coded files, 12-bit samples and 2 or 4 components are refused
// too, with status 1 and a message naming the mode.
//
// C interface (ctypes; no global state, so calls may run on many threads):
//   int niw_jpeg_info(const uint8_t* data, size_t n, int* hwc, char* msg, int msg_len)
//   int niw_jpeg_decode(const uint8_t* data, size_t n, uint8_t* out, char* msg, int msg_len)
// Both return 0 on success, 1 for an unsupported mode and 2 for a corrupt
// file, with a message in ``msg``. ``out`` holds H*W*C bytes, row-major,
// C = 1 (grayscale) or 3 (RGB).

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum Status { kOk = 0, kUnsupported = 1, kCorrupt = 2 };

struct Failure {
  int status;
  std::string msg;
};

[[noreturn]] void fail(int status, const std::string& msg) { throw Failure{status, msg}; }

// jpeg_natural_order with libjpeg's 16 extra entries, so that a run past
// the block's end lands on coefficient 63 as it does there
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

const int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};   // the largest code of each length, -1 for none
  int32_t valoffset[17] = {};
  uint16_t look[1 << kLookBits] = {};   // (length << 8) | value, 0 if longer
};

void build_huffman(Huffman& h, const uint8_t* counts, const uint8_t* vals, int nvals,
                   bool dc) {
  int code = 0, k = 0;
  std::memset(h.look, 0, sizeof(h.look));
  for (int l = 1; l <= 16; l++) {
    int c = counts[l - 1];
    if (c) {
      h.valoffset[l] = k - code;
      for (int i = 0; i < c; i++, code++, k++) {
        if (l <= kLookBits) {
          int shift = kLookBits - l;
          for (int j = 0; j < (1 << shift); j++)
            h.look[(code << shift) | j] = static_cast<uint16_t>((l << 8) | vals[k]);
        }
      }
      h.maxcode[l] = code - 1;
    } else {
      h.maxcode[l] = -1;
    }
    if (code >= (1 << l)) fail(kCorrupt, "bad Huffman table");   // jdhuff.c's check
    code <<= 1;
  }
  h.maxcode[17] = 0x7fffffff;
  if (k != nvals) fail(kCorrupt, "bad Huffman table");
  std::memcpy(h.vals, vals, nvals);
  if (dc)
    for (int i = 0; i < nvals; i++)
      if (vals[i] > 15) fail(kCorrupt, "bad DC Huffman table");
  h.defined = true;
}

const char kSmoothedMode[] =
    "block-smoothed progressive (SOF2: AC coefficients 1-9 not all fully sent)";

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int width_in_blocks = 0, height_in_blocks = 0;
  int downsampled_width = 0, downsampled_height = 0;
  int stride = 0, rows = 0;
  std::vector<uint8_t> plane;
  bool decoded = false;
  // progressive: the coefficients of every block of the padded MCU area
  // (stride / 8 blocks a row), the quantization table latched at the
  // component's first scan, and the successive-approximation bit last sent
  // of each coefficient (-1 for none), as libjpeg's coef_bits
  std::vector<int16_t> coef;
  int16_t qt[64] = {};
  bool latched = false;
  int coef_bits[64];
};

struct Decoder {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;
  int height = 0, width = 0, ncomp = 0;
  bool progressive = false;
  int max_h = 1, max_v = 1, mcus_per_row = 0, mcu_rows = 0;
  bool have_frame = false, saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  int restart_interval = 0;
  int16_t quant[4][64] = {};   // natural order, as libjpeg-turbo's short multipliers
  bool quant_defined[4] = {};
  Huffman dc[4], ac[4];
  Component comp[4];

  // entropy-coded segment reader
  uint64_t buf = 0;
  int bits = 0;
  bool at_marker = false, truncated = false;

  Decoder(const uint8_t* d, size_t size) : data(d), n(size) {}

  int byte() {
    if (pos >= n) fail(kCorrupt, "unexpected end of file");
    return data[pos++];
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  // ------------------------------------------------------------ headers

  int next_marker() {
    // skip to 0xFF, then past fill bytes (jdmarker.c's next_marker)
    for (;;) {
      int c = byte();
      while (c != 0xFF) c = byte();
      do c = byte(); while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  void skip_segment() {
    int len = word();
    if (len < 2 || pos + (len - 2) > n) fail(kCorrupt, "bad segment length");
    pos += len - 2;
  }

  void read_app() {
    size_t start = pos;
    int len = word();
    if (len < 2 || start + len > n) fail(kCorrupt, "bad segment length");
    const uint8_t* p = data + start + 2;
    int m = len - 2;
    int marker = data[start - 1];
    if (marker == 0xE0 && m >= 14 && std::memcmp(p, "JFIF\0", 5) == 0) saw_jfif = true;
    if (marker == 0xEE && m >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = p[11];
    }
    pos = start + len;
  }

  void read_dqt() {
    int len = word() - 2;
    while (len > 0) {
      int pq_tq = byte();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) fail(kCorrupt, "bad DQT table");
      for (int i = 0; i < 64; i++)
        quant[tq][kNatural[i]] = static_cast<int16_t>(pq ? word() : byte());
      quant_defined[tq] = true;
      len -= 1 + 64 * (pq + 1);
    }
    if (len != 0) fail(kCorrupt, "bad DQT length");
  }

  void read_dht() {
    int len = word() - 2;
    while (len > 16) {
      int tc_th = byte();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail(kCorrupt, "bad DHT table");
      uint8_t counts[16], vals[256];
      int total = 0;
      for (int i = 0; i < 16; i++) total += counts[i] = static_cast<uint8_t>(byte());
      if (total > 256 || total > len - 17) fail(kCorrupt, "bad DHT table");
      for (int i = 0; i < total; i++) vals[i] = static_cast<uint8_t>(byte());
      build_huffman(tc ? ac[th] : dc[th], counts, vals, total, tc == 0);
      len -= 17 + total;
    }
    if (len != 0) fail(kCorrupt, "bad DHT length");
  }

  void read_sof(int marker) {
    if (have_frame) fail(kCorrupt, "two frames");
    int len = word();
    int precision = byte();
    height = word();
    width = word();
    ncomp = byte();
    if (precision != 8)
      fail(kUnsupported, std::to_string(precision) + "-bit samples (SOF" +
                             std::to_string(marker - 0xC0) + ")");
    if (ncomp != 1 && ncomp != 3)
      fail(kUnsupported, std::to_string(ncomp) + "-component");
    if (height == 0) fail(kUnsupported, "a height set by a DNL marker");
    if (width == 0 || len != 8 + 3 * ncomp) fail(kCorrupt, "bad SOF");
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail(kCorrupt, "bad sampling factors or quantization table");
      max_h = std::max(max_h, c.h);
      max_v = std::max(max_v, c.v);
    }
    mcus_per_row = (width + 8 * max_h - 1) / (8 * max_h);
    mcu_rows = (height + 8 * max_v - 1) / (8 * max_v);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      if (max_h % c.h || max_v % c.v)
        fail(kUnsupported, "fractional sampling factors");
      c.downsampled_width = static_cast<int>((static_cast<int64_t>(width) * c.h + max_h - 1) / max_h);
      c.downsampled_height = static_cast<int>((static_cast<int64_t>(height) * c.v + max_v - 1) / max_v);
      c.width_in_blocks = (c.downsampled_width + 7) / 8;
      c.height_in_blocks = (c.downsampled_height + 7) / 8;
      c.stride = mcus_per_row * c.h * 8;
      c.rows = mcu_rows * c.v * 8;
      c.plane.assign(static_cast<size_t>(c.stride) * c.rows, 0);
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
      if (progressive) c.coef.assign(static_cast<size_t>(c.stride) / 8 * c.rows / 8 * 64, 0);
    }
    have_frame = true;
  }

  // ------------------------------------------------------ entropy decoding

  void fill() {
    while (bits <= 56) {
      int b = 0;
      if (!at_marker) {
        if (pos >= n) {
          at_marker = truncated = true;
        } else if (data[pos] == 0xFF) {
          size_t q = pos + 1;   // fill bytes, then a stuffed zero or a marker
          while (q < n && data[q] == 0xFF) q++;
          if (q < n && data[q] == 0x00) {
            b = 0xFF;
            pos = q + 1;
          } else {
            at_marker = true;   // zeros past a marker, as libjpeg gives
            if (q >= n) truncated = true;
          }
        } else {
          b = data[pos++];
        }
      }
      buf |= static_cast<uint64_t>(b) << (56 - bits);
      bits += 8;
    }
  }

  int get_bit() {
    if (bits < 1) fill();
    int v = static_cast<int>(buf >> 63);
    buf <<= 1;
    bits -= 1;
    return v;
  }

  int get_bits(int s) {
    if (bits < s) fill();
    int v = static_cast<int>(buf >> (64 - s));
    buf <<= s;
    bits -= s;
    return v;
  }

  static int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }   // HUFF_EXTEND

  int decode(const Huffman& h) {
    if (bits < 16) fill();
    int e = h.look[buf >> (64 - kLookBits)];
    int l;
    if (e) {
      l = e >> 8;
      buf <<= l;
      bits -= l;
      return e & 0xFF;
    }
    int32_t code = 0;
    for (l = kLookBits + 1; l <= 16; l++) {
      code = static_cast<int32_t>(buf >> (64 - l));
      if (code <= h.maxcode[l]) break;
    }
    if (l > 16) fail(kCorrupt, "bad Huffman code");
    buf <<= l;
    bits -= l;
    return h.vals[h.valoffset[l] + code];
  }

  void reset_reader() {
    buf = 0;
    bits = 0;
    at_marker = false;
  }

  void restart(int expected) {
    reset_reader();
    // the marker must come next, after any fill bytes
    if (pos >= n || data[pos] != 0xFF) fail(kCorrupt, "missing restart marker");
    while (pos < n && data[pos] == 0xFF) pos++;
    if (pos >= n || data[pos] != 0xD0 + expected) fail(kCorrupt, "bad restart marker");
    pos++;
  }

  void decode_block(Component& c, const Huffman& hdc, const Huffman& hac, int& pred,
                    int block_row, int block_col) {
    int16_t coef[64] = {};
    int s = decode(hdc);
    int diff = s ? extend(get_bits(s), s) : 0;
    pred += diff;
    coef[0] = static_cast<int16_t>(pred);
    for (int k = 1; k < 64; k++) {
      int rs = decode(hac);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        coef[kNatural[k]] = static_cast<int16_t>(extend(get_bits(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    idct_islow(coef, c.qt,
               c.plane.data() + static_cast<size_t>(block_row) * 8 * c.stride + block_col * 8,
               c.stride);
  }

  void read_sos() {
    if (!have_frame) fail(kCorrupt, "a scan before the frame header");
    int len = word();
    int ns = byte();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) fail(kCorrupt, "bad SOS");
    Component* scan[4];
    for (int i = 0; i < ns; i++) {
      int id = byte(), t = byte();
      Component* c = nullptr;
      for (int j = 0; j < ncomp; j++)
        if (comp[j].id == id) c = &comp[j];
      if (!c || (c->decoded && !progressive)) fail(kCorrupt, "bad scan component");
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td > 3 || c->ta > 3) fail(kCorrupt, "bad scan Huffman table");
      if (!quant_defined[c->tq]) fail(kCorrupt, "a scan without its quantization table");
      if (!c->latched) {
        std::memcpy(c->qt, quant[c->tq], sizeof(c->qt));
        c->latched = true;
      }
      scan[i] = c;
    }
    int ss = byte(), se = byte(), a = byte();
    int ah = a >> 4, al = a & 15;
    if (progressive) {
      bool dc_band = ss == 0;
      if ((dc_band ? se != 0 : (ss > se || se > 63 || ns != 1)) || (ah && al != ah - 1) ||
          al > 13)
        fail(kCorrupt, "bad progression (Ss=" + std::to_string(ss) + " Se=" +
                           std::to_string(se) + " Ah=" + std::to_string(ah) + " Al=" +
                           std::to_string(al) + ")");
      for (int i = 0; i < ns; i++) {
        Component& c = *scan[i];
        if (dc_band ? !ah && !dc[c.td].defined : !ac[c.ta].defined)
          fail(kCorrupt, "a scan without its Huffman tables");
        for (int k = ss; k <= se; k++) c.coef_bits[k] = al;
      }
    } else {
      for (int i = 0; i < ns; i++)
        if (!dc[scan[i]->td].defined || !ac[scan[i]->ta].defined)
          fail(kCorrupt, "a scan without its Huffman tables");
      if (ss != 0 || se != 63 || a != 0)
        fail(kCorrupt, "bad spectral selection in a sequential scan");
    }

    reset_reader();
    int preds[4] = {0, 0, 0, 0};
    int eobrun = 0;
    int64_t n_mcus;
    int per_row;
    if (ns == 1) {
      per_row = scan[0]->width_in_blocks;
      n_mcus = static_cast<int64_t>(per_row) * scan[0]->height_in_blocks;
    } else {
      per_row = mcus_per_row;
      n_mcus = static_cast<int64_t>(per_row) * mcu_rows;
    }
    int next_rst = 0;
    for (int64_t m = 0; m < n_mcus; m++) {
      if (restart_interval && m > 0 && m % restart_interval == 0) {
        restart(next_rst);
        next_rst = (next_rst + 1) & 7;
        std::fill(preds, preds + 4, 0);
        eobrun = 0;
      }
      int mrow = static_cast<int>(m / per_row), mcol = static_cast<int>(m % per_row);
      for (int i = 0; i < ns; i++) {
        Component& c = *scan[i];
        int nv = ns == 1 ? 1 : c.v, nh = ns == 1 ? 1 : c.h;
        for (int y = 0; y < nv; y++)
          for (int x = 0; x < nh; x++) {
            int by = ns == 1 ? mrow : mrow * c.v + y, bx = ns == 1 ? mcol : mcol * c.h + x;
            if (!progressive) {
              decode_block(c, dc[c.td], ac[c.ta], preds[i], by, bx);
              continue;
            }
            int16_t* block = c.coef.data() + (static_cast<size_t>(by) * (c.stride / 8) + bx) * 64;
            if (ss == 0 && !ah)
              dc_first(block, dc[c.td], preds[i], al);
            else if (ss == 0)
              dc_refine(block, al);
            else if (!ah)
              ac_first(block, ac[c.ta], ss, se, al, eobrun);
            else
              ac_refine(block, ac[c.ta], ss, se, al, eobrun);
          }
      }
    }
    if (truncated) fail(kCorrupt, "the scan runs past the end of the file");
    if (ss == 0)
      for (int i = 0; i < ns; i++) scan[i]->decoded = true;
    // past the scan's padding bits to the next marker
    reset_reader();
    while (pos + 1 < n && !(data[pos] == 0xFF && data[pos + 1] != 0x00 &&
                            !(data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7)))
      pos++;
  }

  // ------------------------------------------- progressive scans (jdphuff.c)

  void dc_first(int16_t* block, const Huffman& h, int& pred, int al) {
    int s = decode(h);
    pred += s ? extend(get_bits(s), s) : 0;
    block[0] = static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(pred) << al));
  }

  void dc_refine(int16_t* block, int al) {
    if (get_bit()) block[0] = static_cast<int16_t>(block[0] | (1 << al));
  }

  void ac_first(int16_t* block, const Huffman& h, int ss, int se, int al, int& eobrun) {
    if (eobrun) {
      eobrun--;
      return;
    }
    for (int k = ss; k <= se; k++) {
      int rs = decode(h);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        block[kNatural[k]] = static_cast<int16_t>(
            static_cast<int>(static_cast<unsigned>(extend(get_bits(s), s)) << al));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += get_bits(r);
        eobrun--;
        return;
      }
    }
  }

  // a correction bit for a nonzero coefficient: 1 adds the bit being coded
  // to its magnitude, unless it is already there
  void refine(int16_t& coef, int p1, int m1) {
    if (get_bit() && !(coef & p1)) coef = static_cast<int16_t>(coef + (coef >= 0 ? p1 : m1));
  }

  void ac_refine(int16_t* block, const Huffman& h, int ss, int se, int al, int& eobrun) {
    const int p1 = 1 << al, m1 = static_cast<int>(~0u << al);
    int k = ss;
    if (!eobrun) {
      for (; k <= se; k++) {
        int rs = decode(h);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = get_bit() ? p1 : m1;   // a newly nonzero coefficient is +-1 in this bit
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += get_bits(r);
          break;
        }
        // past the nonzero coefficients (refined) and r zero ones
        do {
          int16_t& coef = block[kNatural[k]];
          if (coef) {
            refine(coef, p1, m1);
          } else if (--r < 0) {
            break;
          }
          k++;
        } while (k <= se);
        if (s) block[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun) {
      for (; k <= se; k++)
        if (block[kNatural[k]]) refine(block[kNatural[k]], p1, m1);
      eobrun--;
    }
  }

  // after the last scan of a progressive frame: refuse what libjpeg would
  // smooth, then the IDCT of every block
  void finish_progressive() {
    for (int i = 0; i < ncomp; i++)
      for (int k = 1; k < 10; k++)
        if (comp[i].coef_bits[k] != 0) fail(kUnsupported, kSmoothedMode);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      int bw = c.stride / 8, bh = c.rows / 8;
      for (int by = 0; by < bh; by++)
        for (int bx = 0; bx < bw; bx++)
          idct_islow(c.coef.data() + (static_cast<size_t>(by) * bw + bx) * 64, c.qt,
                     c.plane.data() + static_cast<size_t>(by) * 8 * c.stride + bx * 8, c.stride);
    }
  }

  // ---------------------------------------------------------------- IDCT

  static void idct_islow(const int16_t* coef, const int16_t* q, uint8_t* out, int stride) {
    // jidctint.c's jpeg_idct_islow
    const int kConstBits = 13, kPass1Bits = 2;
    const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;
    int ws[64];
    for (int col = 0; col < 8; col++) {
      const int16_t* in = coef + col;
      const int16_t* qt = q + col;
      int* w = ws + col;
      if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
        int dcval = static_cast<int>(static_cast<uint64_t>(static_cast<int64_t>(in[0] * qt[0]))
                                     << kPass1Bits);
        for (int r = 0; r < 8; r++) w[8 * r] = dcval;
        continue;
      }
      int64_t z2 = in[16] * qt[16], z3 = in[48] * qt[48];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      z2 = in[0] * qt[0];
      z3 = in[32] * qt[32];
      int64_t tmp0 = static_cast<int64_t>(static_cast<uint64_t>(z2 + z3) << kConstBits);
      int64_t tmp1 = static_cast<int64_t>(static_cast<uint64_t>(z2 - z3) << kConstBits);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2,
              tmp12 = tmp1 - tmp2;
      tmp0 = in[56] * qt[56];
      tmp1 = in[40] * qt[40];
      tmp2 = in[24] * qt[24];
      tmp3 = in[8] * qt[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = kConstBits - kPass1Bits;
      const int64_t half = int64_t{1} << (sh - 1);
      w[0] = static_cast<int>((tmp10 + tmp3 + half) >> sh);
      w[56] = static_cast<int>((tmp10 - tmp3 + half) >> sh);
      w[8] = static_cast<int>((tmp11 + tmp2 + half) >> sh);
      w[48] = static_cast<int>((tmp11 - tmp2 + half) >> sh);
      w[16] = static_cast<int>((tmp12 + tmp1 + half) >> sh);
      w[40] = static_cast<int>((tmp12 - tmp1 + half) >> sh);
      w[24] = static_cast<int>((tmp13 + tmp0 + half) >> sh);
      w[32] = static_cast<int>((tmp13 - tmp0 + half) >> sh);
    }
    for (int row = 0; row < 8; row++) {
      const int* w = ws + 8 * row;
      uint8_t* o = out + static_cast<size_t>(row) * stride;
      const int sh = kConstBits + kPass1Bits + 3;
      const int64_t half = int64_t{1} << (sh - 1);
      int64_t z2 = w[2], z3 = w[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = static_cast<int64_t>(static_cast<uint64_t>(int64_t{w[0]} + w[4]) << kConstBits);
      int64_t tmp1 = static_cast<int64_t>(static_cast<uint64_t>(int64_t{w[0]} - w[4]) << kConstBits);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2,
              tmp12 = tmp1 - tmp2;
      tmp0 = w[7];
      tmp1 = w[5];
      tmp2 = w[3];
      tmp3 = w[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      o[0] = range_limit(static_cast<int>((tmp10 + tmp3 + half) >> sh));
      o[7] = range_limit(static_cast<int>((tmp10 - tmp3 + half) >> sh));
      o[1] = range_limit(static_cast<int>((tmp11 + tmp2 + half) >> sh));
      o[6] = range_limit(static_cast<int>((tmp11 - tmp2 + half) >> sh));
      o[2] = range_limit(static_cast<int>((tmp12 + tmp1 + half) >> sh));
      o[5] = range_limit(static_cast<int>((tmp12 - tmp1 + half) >> sh));
      o[3] = range_limit(static_cast<int>((tmp13 + tmp0 + half) >> sh));
      o[4] = range_limit(static_cast<int>((tmp13 - tmp0 + half) >> sh));
    }
  }

  // jdmaster.c's post-IDCT range-limit table, indexed by the sample & 1023
  // (the level shift of +128 folded in): [0,128) -> +128, [128,512) -> 255,
  // [512,896) -> 0, [896,1024) -> -896
  static uint8_t range_limit(int x) {
    x &= 1023;
    if (x < 128) return static_cast<uint8_t>(x + 128);
    if (x < 512) return 255;
    if (x < 896) return 0;
    return static_cast<uint8_t>(x - 896);
  }

  // ------------------------------------------------------------ the frame

  void parse(bool headers_only) {
    if (n < 2 || data[0] != 0xFF || data[1] != 0xD8) fail(kCorrupt, "not a JPEG");
    pos = 2;
    for (;;) {
      int m = next_marker();
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
          progressive = m == 0xC2;
          read_sof(m);
          if (headers_only) return;
          break;
        case 0xC3: fail(kUnsupported, "lossless (SOF3)");
        case 0xC5: case 0xC6: case 0xC7:
          fail(kUnsupported, "hierarchical (SOF" + std::to_string(m - 0xC0) + ")");
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          fail(kUnsupported, "arithmetic-coded (SOF" + std::to_string(m - 0xC0) + ")");
        case 0xCC: fail(kUnsupported, "arithmetic-coded (DAC)");
        case 0xC4: read_dht(); break;
        case 0xDB: read_dqt(); break;
        case 0xDD:
          if (word() != 4) fail(kCorrupt, "bad DRI");
          restart_interval = word();
          break;
        case 0xDA: read_sos(); break;
        case 0xD9: return;
        case 0xD8: fail(kCorrupt, "a second SOI");
        case 0x01: case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5:
        case 0xD6: case 0xD7:
          break;   // no length
        default:
          if (m >= 0xE0 && m <= 0xEF) read_app();
          else skip_segment();
      }
      if (pos >= n) {
        if (have_frame) return;   // no EOI: what was decoded stands
        fail(kCorrupt, "no frame");
      }
    }
  }

  int out_channels() const { return ncomp == 1 ? 1 : 3; }

  bool rgb_space() const {   // jdapimin.c's default_decompress_parms
    if (saw_jfif) return false;
    if (saw_adobe) return adobe_transform == 0;
    return comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
  }

  // one output row of component c, upsampled as jdsample.c does
  void upsample_row(const Component& c, int y, uint8_t* dst, std::vector<int>& colsum) const {
    int hr = max_h / c.h, vr = max_v / c.v;
    int dw = c.downsampled_width, dh = c.downsampled_height;
    const uint8_t* plane = c.plane.data();
    if (hr == 1 && vr == 1) {
      std::memcpy(dst, plane + static_cast<size_t>(y) * c.stride, width);
    } else if (hr == 2 && vr == 1 && dw > 2) {
      const uint8_t* in = plane + static_cast<size_t>(y) * c.stride;
      for (int x = 0; x < width; x++) {
        int i = x >> 1;
        int v3 = in[i] * 3;
        dst[x] = (x & 1) ? static_cast<uint8_t>((v3 + in[std::min(i + 1, dw - 1)] + 2) >> 2)
                         : static_cast<uint8_t>((v3 + in[std::max(i - 1, 0)] + 1) >> 2);
      }
    } else if (hr == 1 && vr == 2) {
      int i = y >> 1;
      int nb = (y & 1) ? std::min(i + 1, dh - 1) : std::max(i - 1, 0);
      int bias = (y & 1) ? 2 : 1;
      const uint8_t* in0 = plane + static_cast<size_t>(i) * c.stride;
      const uint8_t* in1 = plane + static_cast<size_t>(nb) * c.stride;
      for (int x = 0; x < width; x++)
        dst[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
    } else if (hr == 2 && vr == 2 && dw > 2) {
      int i = y >> 1;
      int nb = (y & 1) ? std::min(i + 1, dh - 1) : std::max(i - 1, 0);
      const uint8_t* in0 = plane + static_cast<size_t>(i) * c.stride;
      const uint8_t* in1 = plane + static_cast<size_t>(nb) * c.stride;
      for (int j = 0; j < dw; j++) colsum[j] = in0[j] * 3 + in1[j];
      for (int x = 0; x < width; x++) {
        int j = x >> 1;
        int t3 = colsum[j] * 3;
        dst[x] = (x & 1) ? static_cast<uint8_t>((t3 + colsum[std::min(j + 1, dw - 1)] + 7) >> 4)
                         : static_cast<uint8_t>((t3 + colsum[std::max(j - 1, 0)] + 8) >> 4);
      }
    } else {   // box replication (int_upsample, h2v1_upsample, h2v2_upsample)
      const uint8_t* in = plane + static_cast<size_t>(y / vr) * c.stride;
      for (int x = 0; x < width; x++) dst[x] = in[x / hr];
    }
  }

  void write(uint8_t* out) const {
    int nc = out_channels();
    std::vector<uint8_t> rows(static_cast<size_t>(width) * ncomp);
    std::vector<int> colsum(static_cast<size_t>(width) + 8);
    // jdcolor.c's build_ycc_rgb_table (SCALEBITS 16, ONE_HALF folded into Cb_g)
    int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
    const int64_t one_half = int64_t{1} << 15;
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((int64_t{91881} * x + one_half) >> 16);    // FIX(1.40200)
      cb_b[i] = static_cast<int>((int64_t{116130} * x + one_half) >> 16);   // FIX(1.77200)
      cr_g[i] = static_cast<int>(-int64_t{46802} * x);                      // FIX(0.71414)
      cb_g[i] = static_cast<int>(-int64_t{22554} * x + one_half);           // FIX(0.34414)
    }
    bool rgb = ncomp == 3 && rgb_space();
    auto clamp = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    for (int y = 0; y < height; y++) {
      for (int ci = 0; ci < ncomp; ci++)
        upsample_row(comp[ci], y, rows.data() + static_cast<size_t>(ci) * width, colsum);
      uint8_t* o = out + static_cast<size_t>(y) * width * nc;
      if (ncomp == 1) {
        std::memcpy(o, rows.data(), width);
        continue;
      }
      const uint8_t* c0 = rows.data();
      const uint8_t* c1 = c0 + width;
      const uint8_t* c2 = c1 + width;
      for (int x = 0; x < width; x++) {
        if (rgb) {
          o[3 * x] = c0[x];
          o[3 * x + 1] = c1[x];
          o[3 * x + 2] = c2[x];
        } else {
          int yy = c0[x], cb = c1[x], cr = c2[x];
          o[3 * x] = clamp(yy + cr_r[cr]);
          o[3 * x + 1] = clamp(yy + ((cb_g[cb] + cr_g[cr]) >> 16));
          o[3 * x + 2] = clamp(yy + cb_b[cb]);
        }
      }
    }
  }
};

int report(const Failure& f, char* msg, int msg_len) {
  if (msg && msg_len > 0) {
    std::strncpy(msg, f.msg.c_str(), msg_len - 1);
    msg[msg_len - 1] = 0;
  }
  return f.status;
}

}  // namespace

extern "C" int niw_jpeg_info(const uint8_t* data, size_t n, int* hwc, char* msg, int msg_len) {
  try {
    Decoder d(data, n);
    d.parse(true);
    if (!d.have_frame) fail(kCorrupt, "no frame");
    hwc[0] = d.height;
    hwc[1] = d.width;
    hwc[2] = d.out_channels();
    return kOk;
  } catch (const Failure& f) {
    return report(f, msg, msg_len);
  } catch (const std::bad_alloc&) {
    return report(Failure{kCorrupt, "out of memory"}, msg, msg_len);
  }
}

extern "C" int niw_jpeg_decode(const uint8_t* data, size_t n, uint8_t* out, char* msg,
                               int msg_len) {
  try {
    Decoder d(data, n);
    d.parse(false);
    for (int i = 0; i < d.ncomp; i++)
      if (!d.comp[i].decoded) fail(kCorrupt, "a component in no scan");
    if (d.progressive) d.finish_progressive();
    d.write(out);
    return kOk;
  } catch (const Failure& f) {
    return report(f, msg, msg_len);
  } catch (const std::bad_alloc&) {
    return report(Failure{kCorrupt, "out of memory"}, msg, msg_len);
  }
}
