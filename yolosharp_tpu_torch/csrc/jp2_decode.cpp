// A JPEG 2000 codestream (ITU T.800 / ISO 15444-1) on the host, decoded as
// OpenJPEG 2.5 decodes it for cv2.imread: the main and tile-part headers
// (SIZ, COD, COC, QCD, QCC, RGN, POC, SOT, SOD, EOC; COM, TLM, PLM, PLT and
// CRG skipped), tier-2 packet headers with their tag trees in the five
// progression orders (and POC's), tier-1 EBCOT on the MQ decoder with every
// code-block style (bypass, RESET, TERMALL, vertically causal, predictable
// termination, segmentation symbols), dequantisation, the inverse 5/3
// (integer) and 9/7 (float, OpenJPEG's lifting order and constants) DWT, the
// inverse RCT / ICT, the DC level shift (round half to even) and the clamp.
// The JP2 boxes and cv2's mapping of the components to 8-bit BGR stay in
// Python (yolosharp_tpu_torch/data/jp2.py).
//
// Build: c++ -O2 -std=c++17 -fPIC -shared -ffp-contract=off. The float path
// must not contract a multiply and an add into one: OpenJPEG's SSE code
// rounds each.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kOk = 0;
constexpr int kBad = 1;          // OpenJPEG refuses the codestream
constexpr int kUnsupported = 2;  // a part no decoder here takes
constexpr int kTooLarge = 3;     // the image does not fit its buffer
constexpr int kMaxComps = 16;

// ---------------------------------------------------------------- headers

struct StepSize {
  int expn = 0, mant = 0;
};

struct Tccp {                     // one tile-component's coding parameters
  int csty = 0;                   // bit 0: precinct sizes given
  int numres = 6;
  int cblkw = 6, cblkh = 6;       // log2 of the nominal code-block size
  int cblksty = 0;
  int qmfbid = 1;                 // 1: 5/3 reversible, 0: 9/7
  int prcw[33], prch[33];
  int qntsty = 0, numgbits = 2;
  StepSize steps[97];
  int roishift = 0;
  Tccp() {
    for (int i = 0; i < 33; i++) prcw[i] = prch[i] = 15;
  }
};

struct Poc {
  int resno0, compno0, layno1, resno1, compno1, prg;
};

struct Tcp {                      // a tile's coding parameters
  int csty = 0, prg = 0, numlayers = 1, mct = 0;
  Tccp tccps[kMaxComps];
  std::vector<Poc> pocs;
  std::vector<uint8_t> data;      // the bodies of its tile-parts, in order
  bool seen = false;
};

struct Comp {
  int dx = 1, dy = 1, prec = 8, sgnd = 0;
};

struct Codestream {
  uint32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  uint32_t tx0 = 0, ty0 = 0, tdx = 0, tdy = 0;
  int numcomps = 0, tw = 0, th = 0;
  Comp comps[kMaxComps];
  Tcp defaults;
  std::vector<Tcp> tiles;
};

inline uint32_t ceildiv(uint32_t a, uint32_t b) {
  return static_cast<uint32_t>((static_cast<uint64_t>(a) + b - 1) / b);
}
inline int64_t ceildivpow2(int64_t a, int b) {
  return (a + (int64_t(1) << b) - 1) >> b;
}
inline int64_t floordivpow2(int64_t a, int b) { return a >> b; }

struct Reader {
  const uint8_t* p;
  size_t n, pos = 0;
  bool bad = false;
  Reader(const uint8_t* p_, size_t n_) : p(p_), n(n_) {}
  uint32_t u(int bytes) {
    uint32_t v = 0;
    for (int i = 0; i < bytes; i++) {
      if (pos >= n) {
        bad = true;
        return 0;
      }
      v = v << 8 | p[pos++];
    }
    return v;
  }
  size_t left() const { return pos < n ? n - pos : 0; }
};

// SPcod / SPcoc: levels, code-block size, style, transform, precincts
bool read_spcod(Reader& r, Tccp& t, bool precincts) {
  t.numres = static_cast<int>(r.u(1)) + 1;
  t.cblkw = static_cast<int>(r.u(1)) + 2;
  t.cblkh = static_cast<int>(r.u(1)) + 2;
  t.cblksty = static_cast<int>(r.u(1));
  t.qmfbid = static_cast<int>(r.u(1));
  if (t.numres > 33 || t.cblkw > 10 || t.cblkh > 10 ||
      t.cblkw + t.cblkh > 12 || t.qmfbid > 1) {
    return false;
  }
  t.csty = precincts ? 1 : 0;
  for (int i = 0; i < t.numres; i++) {
    if (precincts) {
      int v = static_cast<int>(r.u(1));
      t.prcw[i] = v & 15;
      t.prch[i] = v >> 4;
      if (i && (t.prcw[i] == 0 || t.prch[i] == 0)) return false;
    } else {
      t.prcw[i] = t.prch[i] = 15;
    }
  }
  return !r.bad;
}

// SQcd / SQcc over `len` bytes; the derived bands' steps (E-5)
bool read_sqcd(Reader& r, Tccp& t, size_t len) {
  if (len < 1) return false;
  int v = static_cast<int>(r.u(1));
  t.qntsty = v & 31;
  t.numgbits = v >> 5;
  len -= 1;
  if (t.qntsty > 2) return false;
  int n;
  if (t.qntsty == 1) {
    n = 1;
    if (len < 2) return false;
  } else {
    n = static_cast<int>(t.qntsty == 0 ? len : len / 2);
    if (n > 97) return false;
  }
  for (int b = 0; b < n; b++) {
    if (t.qntsty == 0) {
      t.steps[b].expn = static_cast<int>(r.u(1)) >> 3;
      t.steps[b].mant = 0;
    } else {
      int s = static_cast<int>(r.u(2));
      t.steps[b].expn = s >> 11;
      t.steps[b].mant = s & 0x7ff;
    }
  }
  if (t.qntsty == 1) {
    for (int b = 1; b < 97; b++) {
      int e = t.steps[0].expn - (b - 1) / 3;
      t.steps[b].expn = e > 0 ? e : 0;
      t.steps[b].mant = t.steps[0].mant;
    }
  }
  return !r.bad;
}

void copy_cod(Tccp& dst, const Tccp& src) {
  dst.csty = src.csty;
  dst.numres = src.numres;
  dst.cblkw = src.cblkw;
  dst.cblkh = src.cblkh;
  dst.cblksty = src.cblksty;
  dst.qmfbid = src.qmfbid;
  std::memcpy(dst.prcw, src.prcw, sizeof dst.prcw);
  std::memcpy(dst.prch, src.prch, sizeof dst.prch);
}

void copy_qcd(Tccp& dst, const Tccp& src) {
  dst.qntsty = src.qntsty;
  dst.numgbits = src.numgbits;
  std::memcpy(dst.steps, src.steps, sizeof dst.steps);
}

// A marker segment of the main header (tcp = the defaults) or of a tile-part
// header (tcp = the tile's, a copy of the defaults at its first SOT): a
// COD or QCD sets every component, a COC or QCC one.
int read_segment(Codestream& cs, Tcp& tcp, int marker, Reader& r,
                 size_t len) {
  const int nc = cs.numcomps;
  const int cbytes = nc <= 256 ? 1 : 2;
  const size_t end = r.pos + len;
  switch (marker) {
    case 0xFF52: {                                   // COD
      int scod = static_cast<int>(r.u(1));
      tcp.csty = scod;
      tcp.prg = static_cast<int>(r.u(1));
      tcp.numlayers = static_cast<int>(r.u(2));
      tcp.mct = static_cast<int>(r.u(1));
      if (tcp.prg > 4 || tcp.numlayers == 0 || tcp.mct > 1) return kBad;
      Tccp t;
      if (!read_spcod(r, t, scod & 1)) return kBad;
      for (int c = 0; c < nc; c++) copy_cod(tcp.tccps[c], t);
      break;
    }
    case 0xFF53: {                                   // COC
      int c = static_cast<int>(r.u(cbytes));
      int scoc = static_cast<int>(r.u(1));
      if (c >= nc) return kBad;
      Tccp t;
      if (!read_spcod(r, t, scoc & 1)) return kBad;
      copy_cod(tcp.tccps[c], t);
      break;
    }
    case 0xFF5C: {                                   // QCD
      Tccp t;
      if (!read_sqcd(r, t, len)) return kBad;
      for (int c = 0; c < nc; c++) copy_qcd(tcp.tccps[c], t);
      break;
    }
    case 0xFF5D: {                                   // QCC
      if (len < static_cast<size_t>(cbytes)) return kBad;
      int c = static_cast<int>(r.u(cbytes));
      if (c >= nc) return kBad;
      Tccp t;
      if (!read_sqcd(r, t, len - cbytes)) return kBad;
      copy_qcd(tcp.tccps[c], t);
      break;
    }
    case 0xFF5E: {                                   // RGN
      int c = static_cast<int>(r.u(cbytes));
      int style = static_cast<int>(r.u(1));
      int shift = static_cast<int>(r.u(1));
      if (c >= nc || style != 0) return kBad;
      tcp.tccps[c].roishift = shift;
      break;
    }
    case 0xFF5F: {                                   // POC
      const size_t each = 5 + 2 * cbytes;
      if (len % each) return kBad;
      for (size_t i = 0; i < len / each; i++) {
        Poc p;
        p.resno0 = static_cast<int>(r.u(1));
        p.compno0 = static_cast<int>(r.u(cbytes));
        p.layno1 = static_cast<int>(r.u(2));
        p.resno1 = static_cast<int>(r.u(1));
        p.compno1 = static_cast<int>(r.u(cbytes));
        p.prg = static_cast<int>(r.u(1));
        if (p.prg > 4) return kBad;
        p.layno1 = std::min(p.layno1, tcp.numlayers);
        p.compno1 = std::min(p.compno1, nc);
        tcp.pocs.push_back(p);
      }
      break;
    }
    case 0xFF60:                                     // PPM
    case 0xFF61:                                     // PPT
      return kUnsupported;
    default:                                         // COM, TLM, PLM, ...
      r.pos = end;
      break;
  }
  // OpenJPEG refuses a segment longer or shorter than its fields
  if (r.bad || r.pos != end) return kBad;
  return kOk;
}

// The main header up to the first SOT, then each tile-part: its header's
// segments and its body appended to its tile's data.
int parse(const uint8_t* data, size_t n, Codestream& cs, bool header_only) {
  Reader r(data, n);
  if (r.u(2) != 0xFF4F) return kBad;
  if (r.u(2) != 0xFF51) return kBad;
  {
    size_t len = r.u(2);
    if (len < 41) return kBad;
    r.u(2);                                          // Rsiz
    cs.x1 = r.u(4);
    cs.y1 = r.u(4);
    cs.x0 = r.u(4);
    cs.y0 = r.u(4);
    cs.tdx = r.u(4);
    cs.tdy = r.u(4);
    cs.tx0 = r.u(4);
    cs.ty0 = r.u(4);
    cs.numcomps = static_cast<int>(r.u(2));
    if (r.bad || cs.numcomps < 1 || cs.numcomps > kMaxComps ||
        len != 38u + 3u * cs.numcomps) {
      return cs.numcomps > kMaxComps ? kUnsupported : kBad;
    }
    for (int c = 0; c < cs.numcomps; c++) {
      int s = static_cast<int>(r.u(1));
      cs.comps[c].sgnd = s >> 7;
      cs.comps[c].prec = (s & 0x7f) + 1;
      cs.comps[c].dx = static_cast<int>(r.u(1));
      cs.comps[c].dy = static_cast<int>(r.u(1));
      if (cs.comps[c].prec > 31 || cs.comps[c].dx == 0 ||
          cs.comps[c].dy == 0) {
        return kBad;
      }
    }
    if (r.bad || cs.x0 >= cs.x1 || cs.y0 >= cs.y1 || cs.tdx == 0 ||
        cs.tdy == 0 || cs.tx0 > cs.x0 || cs.ty0 > cs.y0 ||
        static_cast<uint64_t>(cs.tx0) + cs.tdx <= cs.x0 ||
        static_cast<uint64_t>(cs.ty0) + cs.tdy <= cs.y0) {
      return kBad;
    }
    cs.tw = static_cast<int>(ceildiv(cs.x1 - cs.tx0, cs.tdx));
    cs.th = static_cast<int>(ceildiv(cs.y1 - cs.ty0, cs.tdy));
    if (static_cast<int64_t>(cs.tw) * cs.th > 65535) return kBad;
  }
  if (header_only) return kOk;
  bool cod = false, qcd = false;
  // the main header
  for (;;) {
    if (r.left() < 4) return kBad;
    int marker = static_cast<int>(r.u(2));
    if (marker == 0xFF90) {
      r.pos -= 2;
      break;
    }
    if (marker < 0xFF30) return kBad;
    size_t len = r.u(2);
    if (len < 2 || r.left() < len - 2) return kBad;
    if (marker == 0xFF52) cod = true;
    if (marker == 0xFF5C) qcd = true;
    int s = read_segment(cs, cs.defaults, marker, r, len - 2);
    if (s) return s;
  }
  if (!cod || !qcd) return kBad;
  cs.tiles.assign(static_cast<size_t>(cs.tw) * cs.th, Tcp());
  // tile-parts, each followed by a marker: EOC, or SOT (a lone SOT at the
  // very end ends the codestream too); the data ending anywhere else is
  // an error in OpenJPEG 2.5's strict mode
  for (;;) {
    if (r.left() < 2) return kBad;
    int marker = static_cast<int>(r.u(2));
    if (marker == 0xFFD9) break;                     // EOC
    if (marker != 0xFF90) return kBad;
    if (r.left() == 0) break;
    size_t start = r.pos - 2;
    size_t lsot = r.u(2);
    int isot = static_cast<int>(r.u(2));
    uint32_t psot = r.u(4);
    r.u(1);                                          // TPsot
    r.u(1);                                          // TNsot
    if (r.bad || lsot != 10 || isot >= cs.tw * cs.th) return kBad;
    Tcp& tcp = cs.tiles[isot];
    if (!tcp.seen) {
      tcp = cs.defaults;
      tcp.seen = true;
    }
    size_t end = psot ? start + psot : n;
    if (psot && psot < 14) return kBad;
    if (end > n) return kBad;    // cut short: OpenJPEG 2.5's strict mode
    for (;;) {
      if (r.pos + 2 > end) return kBad;
      int m = static_cast<int>(r.u(2));
      if (m == 0xFF93) break;                        // SOD
      if (r.pos + 2 > end) return kBad;
      size_t len = r.u(2);
      if (len < 2 || r.pos + len - 2 > end) return kBad;
      int s = read_segment(cs, tcp, m, r, len - 2);
      if (s) return s;
    }
    size_t body_end = end;
    if (!psot) {
      // the last tile-part: up to the two bytes that end the data
      if (n - r.pos < 2) return kBad;
      body_end = n - 2;
    }
    if (body_end > r.pos) {
      tcp.data.insert(tcp.data.end(), data + r.pos, data + body_end);
    }
    r.pos = body_end;
  }
  return kOk;
}

// ---------------------------------------------------------------- tier 2

struct TagTree {
  struct Node {
    int parent, value, low;
  };
  std::vector<Node> nodes;
  void build(int w, int h) {
    nodes.clear();
    if (w <= 0 || h <= 0) return;
    std::vector<int> lw, lh;
    int cw = w, ch = h;
    for (;;) {
      lw.push_back(cw);
      lh.push_back(ch);
      if (cw * ch == 1) break;
      cw = (cw + 1) / 2;
      ch = (ch + 1) / 2;
    }
    int total = 0;
    std::vector<int> base;
    for (size_t k = 0; k < lw.size(); k++) {
      base.push_back(total);
      total += lw[k] * lh[k];
    }
    nodes.assign(total, Node{-1, 999, 0});
    for (size_t k = 0; k + 1 < lw.size(); k++) {
      for (int j = 0; j < lh[k]; j++) {
        for (int i = 0; i < lw[k]; i++) {
          nodes[base[k] + j * lw[k] + i].parent =
              base[k + 1] + (j / 2) * lw[k + 1] + i / 2;
        }
      }
    }
  }
};

struct Bio {                       // the packet header's bits (opj_bio)
  const uint8_t* start;
  const uint8_t* bp;
  const uint8_t* end;
  uint32_t buf = 0;
  int ct = 0;
  Bio(const uint8_t* p, size_t n) : start(p), bp(p), end(p + n) {}
  void bytein() {
    buf = (buf << 8) & 0xffff;
    ct = buf == 0xff00 ? 7 : 8;
    if (bp < end) buf |= *bp++;
  }
  uint32_t bit() {
    if (ct == 0) bytein();
    ct--;
    return (buf >> ct) & 1;
  }
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; i--) v |= bit() << i;
    return v;
  }
  void inalign() {
    ct = 0;
    if ((buf & 0xff) == 0xff) {
      bytein();
      ct = 0;
    }
  }
  size_t numbytes() const { return static_cast<size_t>(bp - start); }
};

int tgt_decode(Bio& bio, TagTree& t, int leaf, int threshold) {
  int stk[32];
  int sp = 0;
  int node = leaf;
  while (t.nodes[node].parent >= 0) {
    stk[sp++] = node;
    node = t.nodes[node].parent;
  }
  int low = 0;
  for (;;) {
    TagTree::Node& nd = t.nodes[node];
    if (low > nd.low) {
      nd.low = low;
    } else {
      low = nd.low;
    }
    while (low < threshold && low < nd.value) {
      if (bio.bit()) {
        nd.value = low;
      } else {
        ++low;
      }
    }
    nd.low = low;
    if (sp == 0) break;
    node = stk[--sp];
  }
  return t.nodes[node].value < threshold ? 1 : 0;
}

struct Seg {
  uint32_t len = 0;
  int numpasses = 0, maxpasses = 0, numnewpasses = 0;
  uint32_t newlen = 0;
};

struct Cblk {
  int x0, y0, x1, y1;
  int numbps = 0, numlenbits = 0, numnewpasses = 0;
  int numsegs = 0;
  std::vector<Seg> segs;
  std::vector<uint8_t> data;       // its chunks, in order
  bool corrupt = false;
};

struct Prc {
  int x0, y0, x1, y1;
  int cw = 0, ch = 0;
  TagTree incl, imsb;
  std::vector<Cblk> cblks;
};

struct Band {
  int x0, y0, x1, y1;
  int bandno = 0;
  float stepsize = 0.f;
  int numbps = 0;
  std::vector<Prc> prcs;
  bool empty() const { return x1 <= x0 || y1 <= y0; }
};

struct Res {
  int x0, y0, x1, y1;
  int pw = 0, ph = 0, pdx = 15, pdy = 15;
  int numbands = 1;
  Band bands[3];
};

struct TileComp {
  int x0, y0, x1, y1;
  int numres;
  std::vector<Res> res;
  std::vector<int32_t> idata;      // 5/3 coefficients, then samples
  std::vector<float> fdata;        // 9/7 coefficients, then samples
};

bool init_seg(Cblk& cb, int index, int cblksty, bool first) {
  if (static_cast<int>(cb.segs.size()) <= index) cb.segs.resize(index + 1);
  Seg& s = cb.segs[index];
  s = Seg();
  if (cblksty & 4) {                                 // TERMALL
    s.maxpasses = 1;
  } else if (cblksty & 1) {                          // bypass
    if (first) {
      s.maxpasses = 10;
    } else {
      int prev = cb.segs[index - 1].maxpasses;
      s.maxpasses = (prev == 1 || prev == 10) ? 2 : 1;
    }
  } else {
    s.maxpasses = 109;
  }
  return true;
}

int getnumpasses(Bio& bio) {
  if (!bio.bit()) return 1;
  if (!bio.bit()) return 2;
  int n = static_cast<int>(bio.read(2));
  if (n != 3) return 3 + n;
  n = static_cast<int>(bio.read(5));
  if (n != 31) return 6 + n;
  return 37 + static_cast<int>(bio.read(7));
}

int floorlog2(int v) {
  int l = 0;
  while (v > 1) {
    v >>= 1;
    l++;
  }
  return l;
}

// One packet (layer, resolution, component, precinct) from data + *pos:
// its header (SOP / EPH markers as COD says), then its code-blocks'
// contributions. Returns false where the data ends before it does.
bool read_packet(const std::vector<uint8_t>& data, size_t* pos,
                 const Tcp& tcp, TileComp& tc, int resno, int precno,
                 int layno, int cblksty) {
  size_t p = *pos;
  const size_t n = data.size();
  if ((tcp.csty & 2) && p + 1 < n && data[p] == 0xFF && data[p + 1] == 0x91) {
    p += 6;                                          // SOP
  }
  if (p > n) return false;
  Res& res = tc.res[resno];
  Bio bio(data.data() + p, n - p);
  bool present = bio.bit();
  if (!present) {
    bio.inalign();
    p += bio.numbytes();
    if ((tcp.csty & 4) && p + 1 < n && data[p] == 0xFF &&
        data[p + 1] == 0x92) {
      p += 2;                                        // EPH
    }
    *pos = p;
    return true;
  }
  for (int b = 0; b < res.numbands; b++) {
    Band& band = res.bands[b];
    if (band.empty()) continue;
    Prc& prc = band.prcs[precno];
    const int ncb = prc.cw * prc.ch;
    for (int k = 0; k < ncb; k++) {
      Cblk& cb = prc.cblks[k];
      int included;
      if (!cb.numsegs) {
        included = tgt_decode(bio, prc.incl, k, layno + 1);
      } else {
        included = static_cast<int>(bio.bit());
      }
      if (!included) {
        cb.numnewpasses = 0;
        continue;
      }
      if (!cb.numsegs) {
        int i = 0;
        while (!tgt_decode(bio, prc.imsb, k, i)) {
          ++i;
          if (i > 64) return false;
        }
        cb.numbps = band.numbps + 1 - i;
        cb.numlenbits = 3;
      }
      cb.numnewpasses = getnumpasses(bio);
      int incr = 0;
      while (bio.bit()) {
        if (++incr > 32) return false;
      }
      cb.numlenbits += incr;
      int segno = 0;
      if (!cb.numsegs) {
        init_seg(cb, 0, cblksty, true);
      } else {
        segno = cb.numsegs - 1;
        if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
          ++segno;
          init_seg(cb, segno, cblksty, false);
        }
      }
      int left = cb.numnewpasses;
      do {
        Seg& s = cb.segs[segno];
        s.numnewpasses = std::min(s.maxpasses - s.numpasses, left);
        int bits = cb.numlenbits + floorlog2(s.numnewpasses);
        if (bits > 32) return false;
        s.newlen = bio.read(bits);
        left -= s.numnewpasses;
        if (left > 0) {
          ++segno;
          init_seg(cb, segno, cblksty, false);
        }
      } while (left > 0);
    }
  }
  bio.inalign();
  p += bio.numbytes();
  if ((tcp.csty & 4) && p + 1 < n && data[p] == 0xFF && data[p + 1] == 0x92) {
    p += 2;                                          // EPH
  }
  // the bodies
  bool partial = false;
  for (int b = 0; b < res.numbands; b++) {
    Band& band = res.bands[b];
    if (band.empty()) continue;
    Prc& prc = band.prcs[precno];
    const int ncb = prc.cw * prc.ch;
    for (int k = 0; k < ncb; k++) {
      Cblk& cb = prc.cblks[k];
      if (!cb.numnewpasses) continue;
      int segno;
      if (!cb.numsegs) {
        segno = 0;
        cb.numsegs = 1;
      } else {
        segno = cb.numsegs - 1;
        if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
          ++segno;
          ++cb.numsegs;
        }
      }
      do {
        Seg& s = cb.segs[segno];
        if (partial || p + s.newlen > n) {
          // OpenJPEG skips this code-block and the rest of the packet
          partial = true;
          cb.corrupt = true;
          cb.data.clear();
          break;
        }
        cb.data.insert(cb.data.end(), data.begin() + p,
                       data.begin() + p + s.newlen);
        p += s.newlen;
        s.len += s.newlen;
        s.numpasses += s.numnewpasses;
        cb.numnewpasses -= s.numnewpasses;
        if (cb.numnewpasses > 0) {
          ++segno;
          ++cb.numsegs;
        }
      } while (cb.numnewpasses > 0);
    }
  }
  *pos = std::min(p, n);
  return !partial;
}

// ---------------------------------------------------------------- tier 1

struct MqState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

constexpr MqState kMq[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

constexpr int kCtxSc = 9, kCtxMag = 14, kCtxAgg = 17, kCtxUni = 18;

struct Mq {                        // OpenJPEG's opj_mqc decoder
  const uint8_t* bp;
  uint32_t a = 0, c = 0;
  int ct = 0;
  uint8_t state[19], mps[19];
  void reset_states() {
    std::memset(state, 0, sizeof state);
    std::memset(mps, 0, sizeof mps);
    state[kCtxUni] = 46;
    state[kCtxAgg] = 3;
    state[0] = 4;
  }
  // buf holds the segment's bytes followed by 0xFF 0xFF
  void init(const uint8_t* buf, size_t len) {
    bp = buf;
    c = len == 0 ? 0xffu << 16 : static_cast<uint32_t>(*bp) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void bytein() {
    uint32_t next = bp[1];
    if (*bp == 0xff) {
      if (next > 0x8f) {
        c += 0xff00;
        ct = 8;
      } else {
        bp++;
        c += next << 9;
        ct = 7;
      }
    } else {
      bp++;
      c += next << 8;
      ct = 8;
    }
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      ct--;
    } while (a < 0x8000);
  }
  int decode(int cx) {
    const MqState& s = kMq[state[cx]];
    int d;
    a -= s.qe;
    if ((c >> 16) < s.qe) {
      // LPS exchange
      if (a < s.qe) {
        a = s.qe;
        d = mps[cx];
        state[cx] = s.nmps;
      } else {
        a = s.qe;
        d = !mps[cx];
        if (s.sw) mps[cx] = !mps[cx];
        state[cx] = s.nlps;
      }
      renorm();
    } else {
      c -= static_cast<uint32_t>(s.qe) << 16;
      if ((a & 0x8000) == 0) {
        // MPS exchange
        if (a < s.qe) {
          d = !mps[cx];
          if (s.sw) mps[cx] = !mps[cx];
          state[cx] = s.nlps;
        } else {
          d = mps[cx];
          state[cx] = s.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
  // the raw (bypass) bits
  void raw_init(const uint8_t* buf) {
    bp = buf;
    c = 0;
    ct = 0;
  }
  int raw() {
    if (ct == 0) {
      if (c == 0xff) {
        if (*bp > 0x8f) {
          c = 0xff;
          ct = 8;
        } else {
          c = *bp++;
          ct = 7;
        }
      } else {
        c = *bp++;
        ct = 8;
      }
    }
    ct--;
    return static_cast<int>((c >> ct) & 1);
  }
};

constexpr uint8_t kSig = 1, kNeg = 2, kVisit = 4, kRefined = 8;

struct T1 {
  int w = 0, h = 0, stride = 0;
  int orient = 0;
  bool vsc = false;
  std::vector<int32_t> data;
  std::vector<uint8_t> flags;      // (h + 2) x (w + 2), one a sample
  Mq mq;

  void reset(int w_, int h_) {
    w = w_;
    h = h_;
    stride = w + 2;
    data.assign(static_cast<size_t>(w) * h, 0);
    flags.assign(static_cast<size_t>(stride) * (h + 2), 0);
  }
  uint8_t* f(int x, int y) { return &flags[(y + 1) * stride + x + 1]; }
  // the row below, unless vertically causal and y ends its stripe
  bool below_hidden(int y) const { return vsc && (y & 3) == 3; }

  int zc_ctx(int x, int y) {
    const uint8_t* p = f(x, y);
    const bool hide = below_hidden(y);
    int hh = (p[-1] & kSig) + (p[1] & kSig);
    int vv = (p[-stride] & kSig) + (hide ? 0 : (p[stride] & kSig));
    int dd = (p[-stride - 1] & kSig) + (p[-stride + 1] & kSig) +
             (hide ? 0 : (p[stride - 1] & kSig) + (p[stride + 1] & kSig));
    if (orient == 3) {
      int hv = hh + vv;
      if (dd == 0) return hv == 0 ? 0 : hv == 1 ? 1 : 2;
      if (dd == 1) return hv == 0 ? 3 : hv == 1 ? 4 : 5;
      if (dd == 2) return hv == 0 ? 6 : 7;
      return 8;
    }
    if (orient == 1) std::swap(hh, vv);              // HL
    if (hh == 0) {
      if (vv == 0) return dd == 0 ? 0 : dd == 1 ? 1 : 2;
      return vv == 1 ? 3 : 4;
    }
    if (hh == 1) {
      if (vv == 0) return dd == 0 ? 5 : 6;
      return 7;
    }
    return 8;
  }
  bool any_neighbour(int x, int y) {
    const uint8_t* p = f(x, y);
    int s = p[-1] | p[1] | p[-stride] | p[-stride - 1] | p[-stride + 1];
    if (!below_hidden(y)) s |= p[stride] | p[stride - 1] | p[stride + 1];
    return s & kSig;
  }
  static int contrib(uint8_t g) {
    return (g & kSig) ? ((g & kNeg) ? -1 : 1) : 0;
  }
  // the sign context and its XOR bit
  int sc_ctx(int x, int y, int* xorbit) {
    const uint8_t* p = f(x, y);
    int hc = contrib(p[-1]) + contrib(p[1]);
    int vc = contrib(p[-stride]) +
             (below_hidden(y) ? 0 : contrib(p[stride]));
    hc = std::max(-1, std::min(1, hc));
    vc = std::max(-1, std::min(1, vc));
    if (hc < 0) {
      hc = -hc;
      vc = -vc;
      *xorbit = 1;
    } else if (hc == 0 && vc < 0) {
      vc = -vc;
      *xorbit = 1;
    } else {
      *xorbit = 0;
    }
    if (hc == 0) return kCtxSc + (vc == 0 ? 0 : 1);
    return kCtxSc + (vc == 1 ? 4 : vc == 0 ? 3 : 2);
  }
  void set_sig(int x, int y, int neg, int32_t oneplushalf) {
    *f(x, y) |= kSig | (neg ? kNeg : 0);
    data[y * w + x] = neg ? -oneplushalf : oneplushalf;
  }
  void decode_sign(int x, int y, int32_t oph) {
    int xorbit;
    int cx = sc_ctx(x, y, &xorbit);
    int s = mq.decode(cx) ^ xorbit;
    set_sig(x, y, s, oph);
  }

  void sigpass(int bpno, bool raw) {
    const int32_t one = 1 << bpno, half = one >> 1, oph = one | half;
    for (int k = 0; k < h; k += 4) {
      for (int x = 0; x < w; x++) {
        for (int y = k; y < std::min(k + 4, h); y++) {
          uint8_t* g = f(x, y);
          if ((*g & (kSig | kVisit)) || !any_neighbour(x, y)) continue;
          if (raw) {
            if (mq.raw()) set_sig(x, y, mq.raw(), oph);
          } else if (mq.decode(zc_ctx(x, y))) {
            decode_sign(x, y, oph);
          }
          *g |= kVisit;
        }
      }
    }
  }
  void refpass(int bpno, bool raw) {
    const int32_t poshalf = (1 << bpno) >> 1;
    for (int k = 0; k < h; k += 4) {
      for (int x = 0; x < w; x++) {
        for (int y = k; y < std::min(k + 4, h); y++) {
          uint8_t* g = f(x, y);
          if ((*g & (kSig | kVisit)) != kSig) continue;
          int v;
          if (raw) {
            v = mq.raw();
          } else {
            int cx = (*g & kRefined) ? kCtxMag + 2
                     : any_neighbour(x, y) ? kCtxMag + 1 : kCtxMag;
            v = mq.decode(cx);
          }
          int32_t& d = data[y * w + x];
          d += (v ^ (d < 0)) ? poshalf : -poshalf;
          *g |= kRefined;
        }
      }
    }
  }
  void clnpass(int bpno, bool segsym) {
    const int32_t one = 1 << bpno, half = one >> 1, oph = one | half;
    const int full = h & ~3;
    for (int k = 0; k < h; k += 4) {
      for (int x = 0; x < w; x++) {
        int y0 = k;
        if (k < full) {
          // run-length mode: the four insignificant, unvisited, and no
          // neighbour of theirs significant
          bool quiet = true;
          for (int y = k; y < k + 4 && quiet; y++) {
            if ((*f(x, y) & (kSig | kVisit)) || any_neighbour(x, y)) {
              quiet = false;
            }
          }
          if (quiet) {
            if (!mq.decode(kCtxAgg)) continue;
            int run = mq.decode(kCtxUni);
            run = run << 1 | mq.decode(kCtxUni);
            decode_sign(x, k + run, oph);
            for (int y = k + run + 1; y < k + 4; y++) {
              if (mq.decode(zc_ctx(x, y))) decode_sign(x, y, oph);
            }
            y0 = k + 4;
          }
        }
        for (int y = y0; y < std::min(k + 4, h); y++) {
          uint8_t* g = f(x, y);
          if (*g & (kSig | kVisit)) continue;
          if (mq.decode(zc_ctx(x, y))) decode_sign(x, y, oph);
        }
        for (int y = k; y < std::min(k + 4, h); y++) *f(x, y) &= ~kVisit;
      }
    }
    if (segsym) {
      for (int i = 0; i < 4; i++) mq.decode(kCtxUni);
    }
  }

  // One code-block's segments into data (values at twice their scale, the
  // half bit below), as opj_t1_decode_cblk decodes them.
  void decode(Cblk& cb, int orient_, int roishift, int cblksty) {
    orient = orient_;
    vsc = cblksty & 8;
    reset(cb.x1 - cb.x0, cb.y1 - cb.y0);
    int bpno_plus_one = roishift + cb.numbps;
    if (bpno_plus_one >= 31 || cb.data.empty() || cb.corrupt) return;
    int passtype = 2;
    mq.reset_states();
    std::vector<uint8_t> buf;
    size_t at = 0;
    for (int segno = 0; segno < cb.numsegs; segno++) {
      Seg& s = cb.segs[segno];
      if (at + s.len > cb.data.size()) break;
      bool raw = (bpno_plus_one <= cb.numbps - 4) && passtype < 2 &&
                 (cblksty & 1);
      buf.assign(cb.data.begin() + at, cb.data.begin() + at + s.len);
      buf.push_back(0xFF);
      buf.push_back(0xFF);
      if (raw) {
        mq.raw_init(buf.data());
      } else {
        mq.init(buf.data(), s.len);
      }
      at += s.len;
      for (int pass = 0; pass < s.numpasses && bpno_plus_one >= 1; pass++) {
        if (passtype == 0) {
          sigpass(bpno_plus_one, raw);
        } else if (passtype == 1) {
          refpass(bpno_plus_one, raw);
        } else {
          clnpass(bpno_plus_one, cblksty & 0x20);
        }
        if ((cblksty & 2) && !raw) mq.reset_states();
        if (++passtype == 3) {
          passtype = 0;
          bpno_plus_one--;
        }
      }
    }
  }
};

// ---------------------------------------------------------------- DWT

void idwt53_1d(int32_t* x, int32_t* tmp, int sn, int dn, int cas) {
  const int len = sn + dn;
  if (cas == 0) {
    if (len <= 1) return;
    const int32_t* lo = x;
    const int32_t* hi = x + sn;
    for (int i = 0; i < sn; i++) {
      int32_t hl = hi[i > 0 ? i - 1 : 0];
      int32_t hr = hi[i < dn ? i : dn - 1];
      tmp[2 * i] = lo[i] - ((hl + hr + 2) >> 2);
    }
    for (int i = 0; i < dn; i++) {
      int32_t l = tmp[2 * i];
      int32_t r = 2 * i + 2 < len ? tmp[2 * i + 2] : tmp[2 * i];
      tmp[2 * i + 1] = hi[i] + ((l + r) >> 1);
    }
  } else {
    if (len == 1) {
      x[0] /= 2;
      return;
    }
    const int32_t* lo = x;
    const int32_t* hi = x + sn;
    for (int i = 0; i < sn; i++) {
      int32_t hl = hi[i];
      int32_t hr = hi[i + 1 < dn ? i + 1 : dn - 1];
      tmp[2 * i + 1] = lo[i] - ((hl + hr + 2) >> 2);
    }
    for (int i = 0; i < dn; i++) {
      int32_t l = tmp[i > 0 ? 2 * i - 1 : 1];
      int32_t r = 2 * i + 1 < len ? tmp[2 * i + 1] : tmp[2 * i - 1];
      tmp[2 * i] = hi[i] + ((l + r) >> 1);
    }
  }
  std::memcpy(x, tmp, sizeof(int32_t) * len);
}

// OpenJPEG's 9/7 lifting (dwt.c, opj_v8dwt_decode): the low samples times
// K, the high ones times its constant 1.625732422 (not 2 / K), then four
// lifting steps, each sample plus (left + right) * c, an edge sample plus
// its one neighbour * 2c.
constexpr float kAlpha = -1.586134342f;
constexpr float kBeta = -0.052980118f;
constexpr float kGamma = 0.882911075f;
constexpr float kDelta = 0.443506852f;
constexpr float kK = 1.230174105f;
constexpr float kHigh = 1.625732422f;

void lift(float* x, int l, int w, int end, int m, float c) {
  const int imax = std::min(end, m);
  int fl = l, fw = w;
  for (int i = 0; i < imax; i++) {
    x[fw - 1] = x[fw - 1] + (x[fl] + x[fw]) * c;
    fl = fw;
    fw += 2;
  }
  if (m < end) {
    c += c;
    x[fw - 1] = x[fw - 1] + x[fl] * c;
  }
}

void idwt97_1d(float* in, float* x, int sn, int dn, int cas) {
  const int len = sn + dn;
  for (int i = 0; i < sn; i++) x[cas + 2 * i] = in[i];
  for (int i = 0; i < dn; i++) x[1 - cas + 2 * i] = in[sn + i];
  int a, b;
  if (cas == 0) {
    if (!(dn > 0 || sn > 1)) {
      std::memcpy(in, x, sizeof(float) * len);
      return;
    }
    a = 0;
    b = 1;
  } else {
    if (!(sn > 0 || dn > 1)) {
      std::memcpy(in, x, sizeof(float) * len);
      return;
    }
    a = 1;
    b = 0;
  }
  for (int i = 0; i < sn; i++) x[a + 2 * i] = x[a + 2 * i] * kK;
  for (int i = 0; i < dn; i++) x[b + 2 * i] = x[b + 2 * i] * kHigh;
  lift(x, b, a + 1, sn, std::min(sn, dn - a), -kDelta);
  lift(x, a, b + 1, dn, std::min(dn, sn - b), -kGamma);
  lift(x, b, a + 1, sn, std::min(sn, dn - a), -kBeta);
  lift(x, a, b + 1, dn, std::min(dn, sn - b), -kAlpha);
  std::memcpy(in, x, sizeof(float) * len);
}

// The 2-D inverse over the tile-component: each resolution's rows, then
// its columns.
template <typename T, typename F>
void idwt_2d(TileComp& tc, std::vector<T>& d, F one_d) {
  const int stride = tc.x1 - tc.x0;
  if (tc.numres <= 1) return;
  int rw = tc.res[0].x1 - tc.res[0].x0;
  int rh = tc.res[0].y1 - tc.res[0].y0;
  const int maxlen = std::max(tc.x1 - tc.x0, tc.y1 - tc.y0) + 2;
  std::vector<T> line(maxlen), tmp(maxlen);
  for (int r = 1; r < tc.numres; r++) {
    const Res& res = tc.res[r];
    const int nw = res.x1 - res.x0, nh = res.y1 - res.y0;
    const int hsn = rw, hdn = nw - rw, hcas = res.x0 & 1;
    const int vsn = rh, vdn = nh - rh, vcas = res.y0 & 1;
    for (int j = 0; j < nh; j++) {
      T* row = d.data() + static_cast<size_t>(j) * stride;
      std::copy(row, row + nw, line.begin());
      one_d(line.data(), tmp.data(), hsn, hdn, hcas);
      std::copy(line.begin(), line.begin() + nw, row);
    }
    for (int i = 0; i < nw; i++) {
      for (int j = 0; j < nh; j++) line[j] = d[static_cast<size_t>(j) * stride + i];
      one_d(line.data(), tmp.data(), vsn, vdn, vcas);
      for (int j = 0; j < nh; j++) d[static_cast<size_t>(j) * stride + i] = line[j];
    }
    rw = nw;
    rh = nh;
  }
}

// ---------------------------------------------------------------- tiles

// The tile's components, resolutions, bands, precincts and code-blocks
// (opj_tcd_init_tile).
bool init_tile(const Codestream& cs, const Tcp& tcp, int tileno,
               std::vector<TileComp>& comps) {
  const int p = tileno % cs.tw, q = tileno / cs.tw;
  const uint32_t tx0 = std::max<uint64_t>(cs.tx0 + uint64_t(p) * cs.tdx, cs.x0);
  const uint32_t ty0 = std::max<uint64_t>(cs.ty0 + uint64_t(q) * cs.tdy, cs.y0);
  const uint32_t tx1 = std::min<uint64_t>(cs.tx0 + uint64_t(p + 1) * cs.tdx, cs.x1);
  const uint32_t ty1 = std::min<uint64_t>(cs.ty0 + uint64_t(q + 1) * cs.tdy, cs.y1);
  comps.assign(cs.numcomps, TileComp());
  for (int c = 0; c < cs.numcomps; c++) {
    const Tccp& tccp = tcp.tccps[c];
    const Comp& comp = cs.comps[c];
    TileComp& tc = comps[c];
    tc.x0 = static_cast<int>(ceildiv(tx0, comp.dx));
    tc.y0 = static_cast<int>(ceildiv(ty0, comp.dy));
    tc.x1 = static_cast<int>(ceildiv(tx1, comp.dx));
    tc.y1 = static_cast<int>(ceildiv(ty1, comp.dy));
    tc.numres = tccp.numres;
    tc.res.assign(tc.numres, Res());
    const size_t area = static_cast<size_t>(tc.x1 - tc.x0) * (tc.y1 - tc.y0);
    if (tccp.qmfbid == 1) {
      tc.idata.assign(area, 0);
    } else {
      tc.fdata.assign(area, 0.f);
    }
    for (int r = 0; r < tc.numres; r++) {
      Res& res = tc.res[r];
      const int level = tc.numres - 1 - r;
      res.x0 = static_cast<int>(ceildivpow2(tc.x0, level));
      res.y0 = static_cast<int>(ceildivpow2(tc.y0, level));
      res.x1 = static_cast<int>(ceildivpow2(tc.x1, level));
      res.y1 = static_cast<int>(ceildivpow2(tc.y1, level));
      res.pdx = tccp.prcw[r];
      res.pdy = tccp.prch[r];
      const int64_t px0 = floordivpow2(res.x0, res.pdx) << res.pdx;
      const int64_t py0 = floordivpow2(res.y0, res.pdy) << res.pdy;
      const int64_t px1 = ceildivpow2(res.x1, res.pdx) << res.pdx;
      const int64_t py1 = ceildivpow2(res.y1, res.pdy) << res.pdy;
      res.pw = res.x0 == res.x1 ? 0 : static_cast<int>((px1 - px0) >> res.pdx);
      res.ph = res.y0 == res.y1 ? 0 : static_cast<int>((py1 - py0) >> res.pdy);
      if (static_cast<int64_t>(res.pw) * res.ph > (1 << 24)) return false;
      int64_t cbgx0, cbgy0;
      int cbgw, cbgh;
      if (r == 0) {
        cbgx0 = px0;
        cbgy0 = py0;
        cbgw = res.pdx;
        cbgh = res.pdy;
        res.numbands = 1;
      } else {
        cbgx0 = ceildivpow2(px0, 1);
        cbgy0 = ceildivpow2(py0, 1);
        cbgw = res.pdx - 1;
        cbgh = res.pdy - 1;
        res.numbands = 3;
      }
      const int cblkw = std::min(tccp.cblkw, cbgw);
      const int cblkh = std::min(tccp.cblkh, cbgh);
      for (int b = 0; b < res.numbands; b++) {
        Band& band = res.bands[b];
        band.bandno = r == 0 ? 0 : b + 1;
        if (r == 0) {
          band.x0 = static_cast<int>(ceildivpow2(tc.x0, level));
          band.y0 = static_cast<int>(ceildivpow2(tc.y0, level));
          band.x1 = static_cast<int>(ceildivpow2(tc.x1, level));
          band.y1 = static_cast<int>(ceildivpow2(tc.y1, level));
        } else {
          const int64_t xo = band.bandno & 1, yo = band.bandno >> 1;
          band.x0 = static_cast<int>(ceildivpow2(tc.x0 - (xo << level), level + 1));
          band.y0 = static_cast<int>(ceildivpow2(tc.y0 - (yo << level), level + 1));
          band.x1 = static_cast<int>(ceildivpow2(tc.x1 - (xo << level), level + 1));
          band.y1 = static_cast<int>(ceildivpow2(tc.y1 - (yo << level), level + 1));
        }
        const int stepno = r == 0 ? 0 : 3 * (r - 1) + b + 1;
        const StepSize& st = tccp.steps[stepno];
        const int gain = tccp.qmfbid == 0 ? 0
                         : band.bandno == 0 ? 0 : band.bandno == 3 ? 2 : 1;
        const int numbps = comp.prec + gain;
        band.stepsize = static_cast<float>(
            (1.0 + st.mant / 2048.0) * std::pow(2.0, numbps - st.expn));
        band.numbps = st.expn + tccp.numgbits - 1;
        band.prcs.assign(static_cast<size_t>(res.pw) * res.ph, Prc());
        for (int pn = 0; pn < res.pw * res.ph; pn++) {
          Prc& prc = band.prcs[pn];
          const int64_t sx = cbgx0 + int64_t(pn % res.pw) * (int64_t(1) << cbgw);
          const int64_t sy = cbgy0 + int64_t(pn / res.pw) * (int64_t(1) << cbgh);
          prc.x0 = static_cast<int>(std::max<int64_t>(sx, band.x0));
          prc.y0 = static_cast<int>(std::max<int64_t>(sy, band.y0));
          prc.x1 = static_cast<int>(std::min<int64_t>(sx + (int64_t(1) << cbgw), band.x1));
          prc.y1 = static_cast<int>(std::min<int64_t>(sy + (int64_t(1) << cbgh), band.y1));
          if (prc.x1 <= prc.x0 || prc.y1 <= prc.y0) {
            prc.cw = prc.ch = 0;
            continue;
          }
          const int64_t bx0 = floordivpow2(prc.x0, cblkw) << cblkw;
          const int64_t by0 = floordivpow2(prc.y0, cblkh) << cblkh;
          const int64_t bx1 = ceildivpow2(prc.x1, cblkw) << cblkw;
          const int64_t by1 = ceildivpow2(prc.y1, cblkh) << cblkh;
          prc.cw = static_cast<int>((bx1 - bx0) >> cblkw);
          prc.ch = static_cast<int>((by1 - by0) >> cblkh);
          prc.incl.build(prc.cw, prc.ch);
          prc.imsb.build(prc.cw, prc.ch);
          prc.cblks.resize(static_cast<size_t>(prc.cw) * prc.ch);
          for (int k = 0; k < prc.cw * prc.ch; k++) {
            Cblk& cb = prc.cblks[k];
            const int64_t cx = bx0 + int64_t(k % prc.cw) * (int64_t(1) << cblkw);
            const int64_t cy = by0 + int64_t(k / prc.cw) * (int64_t(1) << cblkh);
            cb.x0 = static_cast<int>(std::max<int64_t>(cx, prc.x0));
            cb.y0 = static_cast<int>(std::max<int64_t>(cy, prc.y0));
            cb.x1 = static_cast<int>(std::min<int64_t>(cx + (int64_t(1) << cblkw), prc.x1));
            cb.y1 = static_cast<int>(std::min<int64_t>(cy + (int64_t(1) << cblkh), prc.y1));
          }
        }
      }
    }
  }
  return true;
}

struct Packet {
  int layno, resno, compno, precno;
};

// Packets in a progression order over [resno0, resno1) x [compno0,
// compno1) x [0, layno1), each at most once (opj_pi_next_*).
void progression(const Codestream& cs, const std::vector<TileComp>& comps,
                 int tileno, const Poc& poc, std::vector<uint8_t>& include,
                 std::vector<Packet>& out, int maxres, int maxprec) {
  const int nc = cs.numcomps;
  auto emit = [&](int l, int r, int c, int pr) {
    size_t index = ((static_cast<size_t>(l) * maxres + r) * nc + c) * maxprec +
                   pr;
    if (!include[index]) {
      include[index] = 1;
      out.push_back(Packet{l, r, c, pr});
    }
  };
  const int p = tileno % cs.tw, q = tileno / cs.tw;
  const uint32_t tx0 = std::max<uint64_t>(cs.tx0 + uint64_t(p) * cs.tdx, cs.x0);
  const uint32_t ty0 = std::max<uint64_t>(cs.ty0 + uint64_t(q) * cs.tdy, cs.y0);
  const uint32_t tx1 = std::min<uint64_t>(cs.tx0 + uint64_t(p + 1) * cs.tdx, cs.x1);
  const uint32_t ty1 = std::min<uint64_t>(cs.ty0 + uint64_t(q + 1) * cs.tdy, cs.y1);
  const int c1 = std::min(poc.compno1, nc);
  if (poc.prg == 0 || poc.prg == 1) {                // LRCP, RLCP
    const bool lrcp = poc.prg == 0;
    const int outer = lrcp ? poc.layno1 : poc.resno1;
    const int inner0 = lrcp ? poc.resno0 : 0;
    const int inner1 = lrcp ? poc.resno1 : poc.layno1;
    for (int o = lrcp ? 0 : poc.resno0; o < outer; o++) {
      for (int i = inner0; i < inner1; i++) {
        const int l = lrcp ? o : i, r = lrcp ? i : o;
        for (int c = poc.compno0; c < c1; c++) {
          if (r >= comps[c].numres) continue;
          const Res& res = comps[c].res[r];
          for (int pr = 0; pr < res.pw * res.ph; pr++) emit(l, r, c, pr);
        }
      }
    }
    return;
  }
  // the position orders: a grid of the smallest precinct step
  auto steps = [&](int cfrom, int cto, uint32_t* dx, uint32_t* dy) {
    *dx = *dy = 0;
    for (int c = cfrom; c < cto; c++) {
      const TileComp& tc = comps[c];
      for (int r = 0; r < tc.numres; r++) {
        const Res& res = tc.res[r];
        const int sx = res.pdx + tc.numres - 1 - r;
        const int sy = res.pdy + tc.numres - 1 - r;
        if (sx < 32 && uint64_t(cs.comps[c].dx) << sx <= 0xFFFFFFFFu) {
          uint32_t v = static_cast<uint32_t>(uint64_t(cs.comps[c].dx) << sx);
          *dx = *dx ? std::min(*dx, v) : v;
        }
        if (sy < 32 && uint64_t(cs.comps[c].dy) << sy <= 0xFFFFFFFFu) {
          uint32_t v = static_cast<uint32_t>(uint64_t(cs.comps[c].dy) << sy);
          *dy = *dy ? std::min(*dy, v) : v;
        }
      }
    }
  };
  // the precinct at (x, y) of component c, resolution r, or -1
  auto precinct = [&](int c, int r, uint32_t x, uint32_t y) -> int {
    const TileComp& tc = comps[c];
    if (r >= tc.numres) return -1;
    const Res& res = tc.res[r];
    const int levelno = tc.numres - 1 - r;
    const uint64_t cdx = uint64_t(cs.comps[c].dx) << levelno;
    const uint64_t cdy = uint64_t(cs.comps[c].dy) << levelno;
    const uint64_t trx0 = (tx0 + cdx - 1) / cdx, try0 = (ty0 + cdy - 1) / cdy;
    const uint64_t trx1 = (tx1 + cdx - 1) / cdx, try1 = (ty1 + cdy - 1) / cdy;
    const int rpx = res.pdx + levelno, rpy = res.pdy + levelno;
    if (rpx >= 63 || rpy >= 63) return -1;
    if (!((y % (uint64_t(cs.comps[c].dy) << rpy) == 0) ||
          (y == ty0 && ((try0 << levelno) % (uint64_t(1) << rpy))))) {
      return -1;
    }
    if (!((x % (uint64_t(cs.comps[c].dx) << rpx) == 0) ||
          (x == tx0 && ((trx0 << levelno) % (uint64_t(1) << rpx))))) {
      return -1;
    }
    if (res.pw == 0 || res.ph == 0) return -1;
    if (trx0 == trx1 || try0 == try1) return -1;
    const uint64_t prci = (((x + cdx - 1) / cdx) >> res.pdx) - (trx0 >> res.pdx);
    const uint64_t prcj = (((y + cdy - 1) / cdy) >> res.pdy) - (try0 >> res.pdy);
    return static_cast<int>(prci + prcj * res.pw);
  };
  auto layers = [&](int r, int c, int pr) {
    if (pr < 0) return;
    for (int l = 0; l < poc.layno1; l++) emit(l, r, c, pr);
  };
  uint32_t dx, dy;
  if (poc.prg == 2) {                                // RPCL
    steps(0, nc, &dx, &dy);
    if (!dx || !dy) return;
    for (int r = poc.resno0; r < poc.resno1; r++) {
      for (uint32_t y = ty0; y < ty1; y += dy - (y % dy)) {
        for (uint32_t x = tx0; x < tx1; x += dx - (x % dx)) {
          for (int c = poc.compno0; c < c1; c++) layers(r, c, precinct(c, r, x, y));
        }
      }
    }
  } else if (poc.prg == 3) {                         // PCRL
    steps(0, nc, &dx, &dy);
    if (!dx || !dy) return;
    for (uint32_t y = ty0; y < ty1; y += dy - (y % dy)) {
      for (uint32_t x = tx0; x < tx1; x += dx - (x % dx)) {
        for (int c = poc.compno0; c < c1; c++) {
          const int rend = std::min(poc.resno1, comps[c].numres);
          for (int r = poc.resno0; r < rend; r++) layers(r, c, precinct(c, r, x, y));
        }
      }
    }
  } else {                                           // CPRL
    for (int c = poc.compno0; c < c1; c++) {
      steps(c, c + 1, &dx, &dy);
      if (!dx || !dy) return;
      for (uint32_t y = ty0; y < ty1; y += dy - (y % dy)) {
        for (uint32_t x = tx0; x < tx1; x += dx - (x % dx)) {
          const int rend = std::min(poc.resno1, comps[c].numres);
          for (int r = poc.resno0; r < rend; r++) layers(r, c, precinct(c, r, x, y));
        }
      }
    }
  }
}

// One tile: its packets, its code-blocks, the inverse DWT, MCT and the DC
// level shift, written into the image's components.
int decode_tile(const Codestream& cs, Tcp& tcp, int tileno,
                const std::vector<int32_t*>& planes) {
  std::vector<TileComp> comps;
  if (!init_tile(cs, tcp, tileno, comps)) return kBad;
  const int nc = cs.numcomps;
  for (int c = 0; c < nc; c++) {
    if (tcp.tccps[c].cblksty & 0x40) return kUnsupported;   // HTJ2K
  }
  int maxres = 0, maxprec = 1;
  for (const TileComp& tc : comps) {
    maxres = std::max(maxres, tc.numres);
    for (const Res& r : tc.res) maxprec = std::max(maxprec, r.pw * r.ph);
  }
  std::vector<Poc> pocs = tcp.pocs;
  if (pocs.empty()) {
    pocs.push_back(Poc{0, 0, tcp.numlayers, maxres, nc, tcp.prg});
  }
  std::vector<uint8_t> include(
      static_cast<size_t>(tcp.numlayers) * maxres * nc * maxprec, 0);
  std::vector<Packet> packets;
  for (Poc poc : pocs) {
    poc.layno1 = std::min(poc.layno1, tcp.numlayers);
    poc.resno1 = std::min(poc.resno1, maxres);
    progression(cs, comps, tileno, poc, include, packets, maxres, maxprec);
  }
  size_t pos = 0;
  for (const Packet& pk : packets) {
    if (pos >= tcp.data.size()) break;
    if (!read_packet(tcp.data, &pos, tcp, comps[pk.compno], pk.resno,
                     pk.precno, pk.layno, tcp.tccps[pk.compno].cblksty)) {
      return kBad;       // a packet the data cuts: OpenJPEG's strict mode
    }
  }
  // tier 1 and dequantisation into each tile-component
  T1 t1;
  for (int c = 0; c < nc; c++) {
    TileComp& tc = comps[c];
    const Tccp& tccp = tcp.tccps[c];
    const int stride = tc.x1 - tc.x0;
    for (int r = 0; r < tc.numres; r++) {
      Res& res = tc.res[r];
      for (int b = 0; b < res.numbands; b++) {
        Band& band = res.bands[b];
        if (band.empty()) continue;
        int xoff = 0, yoff = 0;
        if (band.bandno & 1) xoff = tc.res[r - 1].x1 - tc.res[r - 1].x0;
        if (band.bandno & 2) yoff = tc.res[r - 1].y1 - tc.res[r - 1].y0;
        for (Prc& prc : band.prcs) {
          for (Cblk& cb : prc.cblks) {
            if (cb.x1 <= cb.x0 || cb.y1 <= cb.y0 || !cb.numsegs) continue;
            t1.decode(cb, band.bandno, tccp.roishift, tccp.cblksty);
            const int cw = cb.x1 - cb.x0, ch = cb.y1 - cb.y0;
            if (tccp.roishift) {
              if (tccp.roishift >= 31) {
                std::fill(t1.data.begin(), t1.data.end(), 0);
              } else {
                const int32_t thresh = 1 << tccp.roishift;
                for (int32_t& v : t1.data) {
                  int32_t mag = v < 0 ? -v : v;
                  if (mag >= thresh) {
                    mag >>= tccp.roishift;
                    v = v < 0 ? -mag : mag;
                  }
                }
              }
            }
            const int x = cb.x0 - band.x0 + xoff, y = cb.y0 - band.y0 + yoff;
            if (tccp.qmfbid == 1) {
              for (int j = 0; j < ch; j++) {
                int32_t* dst = &tc.idata[static_cast<size_t>(y + j) * stride + x];
                for (int i = 0; i < cw; i++) dst[i] = t1.data[j * cw + i] / 2;
              }
            } else {
              const float step = 0.5f * band.stepsize;
              for (int j = 0; j < ch; j++) {
                float* dst = &tc.fdata[static_cast<size_t>(y + j) * stride + x];
                for (int i = 0; i < cw; i++) {
                  dst[i] = static_cast<float>(t1.data[j * cw + i]) * step;
                }
              }
            }
          }
        }
      }
    }
    if (tccp.qmfbid == 1) {
      idwt_2d(tc, tc.idata, idwt53_1d);
    } else {
      idwt_2d(tc, tc.fdata, idwt97_1d);
    }
  }
  // the inverse component transform
  if (tcp.mct && nc >= 3) {
    const size_t n0 = comps[0].idata.size() + comps[0].fdata.size();
    for (int c = 1; c < 3; c++) {
      if (comps[c].numres != comps[0].numres ||
          comps[c].idata.size() + comps[c].fdata.size() != n0) {
        return kBad;
      }
    }
    if (tcp.tccps[0].qmfbid == 1) {
      if (comps[1].idata.size() != n0 || comps[2].idata.size() != n0) {
        return kBad;
      }
      int32_t *c0 = comps[0].idata.data(), *c1 = comps[1].idata.data(),
              *c2 = comps[2].idata.data();
      for (size_t i = 0; i < n0; i++) {
        int32_t y = c0[i], u = c1[i], v = c2[i];
        int32_t g = y - ((u + v) >> 2);
        c0[i] = v + g;
        c1[i] = g;
        c2[i] = u + g;
      }
    } else {
      if (comps[1].fdata.size() != n0 || comps[2].fdata.size() != n0) {
        return kBad;
      }
      float *c0 = comps[0].fdata.data(), *c1 = comps[1].fdata.data(),
            *c2 = comps[2].fdata.data();
      for (size_t i = 0; i < n0; i++) {
        float y = c0[i], u = c1[i], v = c2[i];
        float r = y + (v * 1.402f);
        float g = y - (u * 0.34413f) - (v * 0.71414f);
        float b = y + (u * 1.772f);
        c0[i] = r;
        c1[i] = g;
        c2[i] = b;
      }
    }
  }
  // the DC level shift and the clamp, into the image
  for (int c = 0; c < nc; c++) {
    const TileComp& tc = comps[c];
    const Comp& comp = cs.comps[c];
    const Tccp& tccp = tcp.tccps[c];
    int64_t lo, hi;
    if (comp.sgnd) {
      lo = -(int64_t(1) << (comp.prec - 1));
      hi = (int64_t(1) << (comp.prec - 1)) - 1;
    } else {
      lo = 0;
      hi = (int64_t(1) << comp.prec) - 1;
    }
    const int64_t shift = comp.sgnd ? 0 : int64_t(1) << (comp.prec - 1);
    const int cx0 = static_cast<int>(ceildiv(cs.x0, comp.dx));
    const int cy0 = static_cast<int>(ceildiv(cs.y0, comp.dy));
    const int cw = static_cast<int>(ceildiv(cs.x1, comp.dx)) - cx0;
    const int stride = tc.x1 - tc.x0;
    for (int j = 0; j < tc.y1 - tc.y0; j++) {
      int32_t* dst = planes[c] + static_cast<size_t>(tc.y0 - cy0 + j) * cw +
                     (tc.x0 - cx0);
      for (int i = 0; i < stride; i++) {
        const size_t k = static_cast<size_t>(j) * stride + i;
        int64_t v;
        if (tccp.qmfbid == 1) {
          v = int64_t(tc.idata[k]) + shift;
        } else {
          float f = tc.fdata[k];
          if (f > static_cast<float>(INT32_MAX)) {
            dst[i] = static_cast<int32_t>(hi);
            continue;
          }
          if (f < static_cast<float>(INT32_MIN)) {
            dst[i] = static_cast<int32_t>(lo);
            continue;
          }
          v = static_cast<int64_t>(std::lrintf(f)) + shift;
        }
        dst[i] = static_cast<int32_t>(std::min(hi, std::max(lo, v)));
      }
    }
  }
  return kOk;
}

}  // namespace

extern "C" {

// The image of a codestream (data, n bytes): hdr[0..4] x0, y0, x1, y1 (the
// SIZ's unsigned 32-bit values) and the number of components, then for
// each component dx, dy, precision and signedness. Returns 0, kBad or
// kUnsupported.
int ys_j2k_header(const uint8_t* data, int64_t n, int64_t* hdr) {
  Codestream cs;
  int s = parse(data, static_cast<size_t>(n), cs, true);
  if (s) return s;
  hdr[0] = cs.x0;
  hdr[1] = cs.y0;
  hdr[2] = cs.x1;
  hdr[3] = cs.y1;
  hdr[4] = cs.numcomps;
  for (int c = 0; c < cs.numcomps; c++) {
    hdr[5 + 4 * c] = cs.comps[c].dx;
    hdr[6 + 4 * c] = cs.comps[c].dy;
    hdr[7 + 4 * c] = cs.comps[c].prec;
    hdr[8 + 4 * c] = cs.comps[c].sgnd;
  }
  return kOk;
}

// Every tile of the codestream into out (out_n samples): the components
// one after another, each ceil(x1 / dx) - ceil(x0 / dx) wide and as many
// rows as its height, the samples as OpenJPEG's opj_decode leaves them (a
// tile the codestream lacks stays 0). Returns 0, kBad, kUnsupported, or
// kTooLarge where the image reaches past 2^31 - 1 or its components do not
// fit in out_n samples.
int ys_j2k_decode(const uint8_t* data, int64_t n, int32_t* out,
                  int64_t out_n) {
  Codestream cs;
  int s = parse(data, static_cast<size_t>(n), cs, false);
  if (s) return s;
  if (cs.x1 > uint32_t(INT32_MAX) || cs.y1 > uint32_t(INT32_MAX)) {
    return kTooLarge;
  }
  std::vector<uint64_t> sizes(cs.numcomps);
  uint64_t total = 0;
  for (int c = 0; c < cs.numcomps; c++) {
    const Comp& comp = cs.comps[c];
    const uint64_t w = ceildiv(cs.x1, comp.dx) - ceildiv(cs.x0, comp.dx);
    const uint64_t h = ceildiv(cs.y1, comp.dy) - ceildiv(cs.y0, comp.dy);
    sizes[c] = w * h;
    total += sizes[c];
  }
  if (out_n < 0 || total > static_cast<uint64_t>(out_n)) return kTooLarge;
  std::vector<int32_t*> planes(cs.numcomps);
  int32_t* at = out;
  for (int c = 0; c < cs.numcomps; c++) {
    planes[c] = at;
    std::memset(at, 0, sizeof(int32_t) * sizes[c]);
    at += sizes[c];
  }
  for (int t = 0; t < cs.tw * cs.th; t++) {
    Tcp& tcp = cs.tiles[t];
    if (!tcp.seen) continue;
    s = decode_tile(cs, tcp, t, planes);
    if (s) return s;
  }
  return kOk;
}

}  // extern "C"
