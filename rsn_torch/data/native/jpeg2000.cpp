// A JPEG 2000 codestream as OpenJPEG 2.5.4 decodes it for PIL 12.1.0
// (Jpeg2KDecode.c reads it tile by tile: opj_read_tile_header, then
// opj_decode_tile_data), for rsn_torch.data.jpeg2000.
//
// - Markers: SIZ, COD, COC, QCD, QCC, RGN, POC, PPM, PPT, CRG, COM, TLM,
//   PLM, PLT; SOT with tile-parts of several tiles interleaved, SOD, EOC;
//   an unknown marker is passed over as opj_j2k_read_unk does (2-byte
//   words up to the next known marker).
// - T2: packet headers (tag trees, pass counts, Lblock, segments),
//   SOP (optional) / EPH (required), the five progressions and POC as
//   opj_pi_next_* walks them.
// - T1: EBCOT with the MQ decoder, raw (bypass) passes, reset, termall,
//   vertically causal contexts, segmentation symbols; OpenJPEG's values:
//   a coefficient found significant at bit-plane p is 1.5 * 2^p (in units
//   of half the least bit), each refinement adds or takes away half of
//   the plane's bit.  ROI maxshift as opj_t1_clbl_decode_processor undoes it.
// - Dequantisation: reversible (the value / 2), scalar derived and
//   expounded (value * 0.5f * stepsize, the step size from
//   opj_tcd_init_tile's double expression rounded to float).
// - The inverse 5/3 in integers, the 9/7 in float as opj_v8dwt_decode
//   runs it (K and 1.625732422 scaling, then delta, gamma, beta, alpha
//   lifting; a line of one sample left as it is), the inverse RCT / ICT,
//   the DC level shift with lrintf's rounding and the clamp.
//
// It has to be built with floating-point contraction off
// (-ffp-contract=off): OpenJPEG as PIL ships it is SSE code without FMAs.
//
// Not ported (NotImplementedError): HTJ2K code blocks (Part 15; its CAP
// and CPF markers are passed over, as OpenJPEG passes over them) and the
// Part 2 markers MCT, MCC, MCO and CBD.
#include <algorithm>
#include <cmath>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Refused {
  std::string msg;
};
struct Unported {
  std::string msg;
};

[[noreturn]] void refuse(const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw Refused{buf};
}

[[noreturn]] void unported(const char* what) { throw Unported{what}; }

int ceildiv(int64_t a, int64_t b) { return (int)((a + b - 1) / b); }
int ceildivpow2(int64_t a, int b) { return (int)((a + (((int64_t)1) << b) - 1) >> b); }
int floordivpow2(int64_t a, int b) { return (int)(a >> b); }

// ---- markers -----------------------------------------------------------

enum {
  SOC = 0xff4f, CAP = 0xff50, SIZ = 0xff51, COD = 0xff52, COC = 0xff53,
  TLM = 0xff55, PLM = 0xff57, PLT = 0xff58, CPF = 0xff59, QCD = 0xff5c,
  QCC = 0xff5d, RGN = 0xff5e, POC = 0xff5f, PPM = 0xff60, PPT = 0xff61,
  CRG = 0xff63, COM = 0xff64, MCT = 0xff74, MCC = 0xff75,
  MCO = 0xff77, CBD = 0xff78, SOT = 0xff90, SOP = 0xff91, EPH = 0xff92,
  SOD = 0xff93, EOC = 0xffd9
};
enum { MH = 1, TPH = 2 };

// opj_j2k_get_marker_handler's table: the states each marker may be in
int marker_states(int m) {
  switch (m) {
    case SOT: return MH | TPH;
    case COD: case COC: case RGN: case QCD: case QCC: case POC: case COM:
    case MCT: case MCC: case MCO:
      return MH | TPH;
    case SIZ: return 0;  // only right after SOC
    case TLM: case PLM: case PPM: case CRG: case CBD: case CAP: case CPF:
      return MH;
    case PLT: case PPT: return TPH;
    case SOP: return 0;
    default: return -1;  // unknown
  }
}

struct Reader {
  const uint8_t* p;
  size_t n, pos = 0;
  Reader(const uint8_t* p_, size_t n_) : p(p_), n(n_) {}
  size_t left() const { return n - pos; }
  uint32_t get(int bytes) {
    if (pos + bytes > n) refuse("Stream too short");
    uint32_t v = 0;
    for (int i = 0; i < bytes; i++) v = (v << 8) | p[pos++];
    return v;
  }
};

struct Comp {
  int dx, dy, prec, sgnd;
};

struct Tccp {
  int csty = 0, numres = 0, cblkw = 0, cblkh = 0, cblksty = 0, qmfbid = 0;
  int prcw[33], prch[33];
  int qntsty = 0, numgbits = 0;
  int expn[97], mant[97];
  int roishift = 0;
  Tccp() {
    for (int i = 0; i < 33; i++) prcw[i] = prch[i] = 15;
    for (int i = 0; i < 97; i++) expn[i] = mant[i] = 0;
  }
};

struct Poc {
  int resno0, compno0, layno1, resno1, compno1, prg;
};

struct Tcp {
  int csty = 0, prg = 0, numlayers = 0, mct = 0;
  bool cod = false;
  std::vector<Tccp> tccps;
  std::vector<Poc> pocs;
  std::vector<std::vector<uint8_t>> ppt;  // by Zppt
  bool has_ppt = false;
  std::vector<uint8_t> data;               // the tile-parts' bodies
  int nb_parts = 0;
  bool seen = false, decoded = false;
};

struct Codestream {
  uint32_t X1, Y1, X0, Y0, TW, TH, TX0, TY0;
  int nc = 0, tw = 0, th = 0;
  std::vector<Comp> comps;
  Tcp def;
  std::vector<Tcp> tcps;
  bool has_ppm = false;
  std::vector<std::vector<uint8_t>> ppm;  // by Zppm
  std::vector<uint8_t> ppm_data;
  size_t ppm_pos = 0;
};

void read_siz(Codestream& cs, Reader r) {
  if (r.left() < 36) refuse("Error with SIZ marker size");
  int rsiz = r.get(2);
  (void)rsiz;
  cs.X1 = r.get(4); cs.Y1 = r.get(4); cs.X0 = r.get(4); cs.Y0 = r.get(4);
  cs.TW = r.get(4); cs.TH = r.get(4); cs.TX0 = r.get(4); cs.TY0 = r.get(4);
  int nc = r.get(2);
  if ((int)r.left() != 3 * nc || nc < 1 || nc > 16384)
    refuse("Error with SIZ marker: number of component is illegal -> %d", nc);
  if (cs.X0 >= cs.X1 || cs.Y0 >= cs.Y1)
    refuse("Error with SIZ marker: negative or zero image size");
  if (cs.TW == 0 || cs.TH == 0) refuse("Error with SIZ marker: invalid tile size");
  if (cs.TX0 > cs.X0 || cs.TY0 > cs.Y0 ||
      (uint64_t)cs.TX0 + cs.TW <= cs.X0 || (uint64_t)cs.TY0 + cs.TH <= cs.Y0)
    refuse("Error with SIZ marker: illegal tile offset");
  cs.nc = nc;
  for (int i = 0; i < nc; i++) {
    int s = r.get(1);
    Comp c;
    c.prec = (s & 0x7f) + 1;
    c.sgnd = s >> 7;
    c.dx = r.get(1);
    c.dy = r.get(1);
    if (c.dx < 1 || c.dx > 255 || c.dy < 1 || c.dy > 255)
      refuse("Invalid values for comp = %d : dx=%u dy=%u", i, c.dx, c.dy);
    if (c.prec > 31) refuse("Invalid values for comp = %d : prec=%u", i, c.prec);
    cs.comps.push_back(c);
  }
  cs.tw = ceildiv((int64_t)cs.X1 - cs.TX0, cs.TW);
  cs.th = ceildiv((int64_t)cs.Y1 - cs.TY0, cs.TH);
  if (cs.tw == 0 || cs.th == 0 || cs.tw > 65535 / cs.th)
    refuse("Invalid number of tiles : %u x %u", cs.tw, cs.th);
  cs.def.tccps.assign(nc, Tccp());
}

// SPCod / SPCoc (opj_j2k_read_SPCod_SPCoc)
void read_spcod(Tccp& t, Reader& r) {
  if (r.left() < 5) refuse("Error reading SPCod SPCoc element");
  t.numres = r.get(1) + 1;
  if (t.numres > 33) refuse("Invalid value for numresolutions : %d", t.numres);
  t.cblkw = r.get(1) + 2;
  t.cblkh = r.get(1) + 2;
  if (t.cblkw > 10 || t.cblkh > 10 || t.cblkw + t.cblkh > 12)
    refuse("Error reading SPCod SPCoc element, Invalid cblkw/cblkh combination");
  t.cblksty = r.get(1);
  if (t.cblksty & 0x80)
    refuse("Unsupported Mixed HT code-block style found");
  if (t.cblksty & 0x40)
    unported("HTJ2K code blocks (JPEG 2000 Part 15, code-block style 0x40)");
  t.qmfbid = r.get(1);
  if (t.qmfbid > 1) refuse("Invalid transformation found");
  if (t.csty & 1) {
    if ((int)r.left() < t.numres) refuse("Error reading SPCod SPCoc element");
    for (int i = 0; i < t.numres; i++) {
      int v = r.get(1);
      if (i != 0 && ((v & 0xf) == 0 || (v >> 4) == 0)) refuse("Invalid precinct size");
      t.prcw[i] = v & 0xf;
      t.prch[i] = v >> 4;
    }
  } else {
    for (int i = 0; i < t.numres; i++) t.prcw[i] = t.prch[i] = 15;
  }
}

void read_cod(Codestream& cs, Tcp& tcp, Reader r, bool tile) {
  if (tile && tcp.cod)
    refuse("COD marker already read. No more than one COD marker per tile.");
  tcp.cod = true;
  if (r.left() < 5) refuse("Error reading COD marker");
  tcp.csty = r.get(1);
  if (tcp.csty & ~7) refuse("Unknown Scod value in COD marker");
  tcp.prg = r.get(1);
  if (tcp.prg > 4) tcp.prg = -1;  // an error message, then opj_pi refuses
  tcp.numlayers = r.get(2);
  if (tcp.numlayers < 1) refuse("Invalid number of layers in COD marker : %d", tcp.numlayers);
  tcp.mct = r.get(1);
  if (tcp.mct > 1) refuse("Invalid multiple component transformation");
  Tccp& t0 = tcp.tccps[0];
  t0.csty = tcp.csty & 1;
  read_spcod(t0, r);
  if (r.left()) refuse("Error reading COD marker");
  for (int i = 1; i < cs.nc; i++) {
    Tccp& t = tcp.tccps[i];
    t.csty = t0.csty; t.numres = t0.numres; t.cblkw = t0.cblkw;
    t.cblkh = t0.cblkh; t.cblksty = t0.cblksty; t.qmfbid = t0.qmfbid;
    memcpy(t.prcw, t0.prcw, sizeof t.prcw);
    memcpy(t.prch, t0.prch, sizeof t.prch);
  }
}

int read_compno(const Codestream& cs, Reader& r) {
  return r.get(cs.nc <= 256 ? 1 : 2);
}

void read_coc(Codestream& cs, Tcp& tcp, Reader r) {
  int c = read_compno(cs, r);
  if (c >= cs.nc) refuse("Error reading COC marker (bad number of components)");
  Tccp& t = tcp.tccps[c];
  t.csty = r.get(1);
  read_spcod(t, r);
  if (r.left()) refuse("Error reading COC marker");
}

// opj_j2k_read_SQcd_SQcc
void read_sqcd(Tccp& t, Reader& r) {
  if (r.left() < 1) refuse("Error reading SQcd or SQcc element");
  int v = r.get(1);
  t.qntsty = v & 0x1f;
  t.numgbits = v >> 5;
  int nb;
  if (t.qntsty == 1) {
    nb = 1;
  } else {
    nb = t.qntsty == 0 ? (int)r.left() : (int)r.left() / 2;
  }
  if (t.qntsty == 0) {
    for (int b = 0; b < nb; b++) {
      int e = r.get(1);
      if (b < 97) { t.expn[b] = e >> 3; t.mant[b] = 0; }
    }
  } else {
    for (int b = 0; b < nb; b++) {
      int e = r.get(2);
      if (b < 97) { t.expn[b] = e >> 11; t.mant[b] = e & 0x7ff; }
    }
  }
  if (t.qntsty == 1) {
    for (int b = 1; b < 97; b++) {
      int e = t.expn[0] - (b - 1) / 3;
      t.expn[b] = e > 0 ? e : 0;
      t.mant[b] = t.mant[0];
    }
  }
}

void read_qcd(Codestream& cs, Tcp& tcp, Reader r) {
  Tccp& t0 = tcp.tccps[0];
  read_sqcd(t0, r);
  if (r.left()) refuse("Error reading QCD marker");
  for (int i = 1; i < cs.nc; i++) {
    Tccp& t = tcp.tccps[i];
    t.qntsty = t0.qntsty; t.numgbits = t0.numgbits;
    memcpy(t.expn, t0.expn, sizeof t.expn);
    memcpy(t.mant, t0.mant, sizeof t.mant);
  }
}

void read_qcc(Codestream& cs, Tcp& tcp, Reader r) {
  int c = read_compno(cs, r);
  if (c >= cs.nc) refuse("Invalid component number: %d", c);
  read_sqcd(tcp.tccps[c], r);
  if (r.left()) refuse("Error reading QCC marker");
}

void read_rgn(Codestream& cs, Tcp& tcp, Reader r) {
  if ((int)r.left() != (cs.nc <= 256 ? 3 : 4)) refuse("Error reading RGN marker");
  int c = read_compno(cs, r);
  r.get(1);  // Srgn
  if (c >= cs.nc) refuse("bad component number in RGN (%d when there are only %d)", c, cs.nc);
  tcp.tccps[c].roishift = r.get(1);
}

void read_poc(Codestream& cs, Tcp& tcp, Reader r) {
  int room = cs.nc <= 256 ? 1 : 2;
  int chunk = 5 + 2 * room;
  if (r.left() % chunk || r.left() == 0) refuse("Error reading POC marker");
  int n = (int)r.left() / chunk;
  if ((int)tcp.pocs.size() + n >= 32) refuse("Too many POCs %d", (int)tcp.pocs.size() + n);
  for (int i = 0; i < n; i++) {
    Poc p;
    p.resno0 = r.get(1);
    p.compno0 = r.get(room);
    p.layno1 = r.get(2);
    if (p.layno1 > tcp.numlayers) p.layno1 = tcp.numlayers;
    p.resno1 = r.get(1);
    p.compno1 = r.get(room);
    if (p.compno1 > cs.nc) p.compno1 = cs.nc;
    p.prg = r.get(1);
    tcp.pocs.push_back(p);
  }
}

void read_crg(Codestream& cs, Reader r) {
  if ((int)r.left() != cs.nc * 4) refuse("Error reading CRG marker");
}

void read_tlm(Reader r) {
  if (r.left() < 2) refuse("Error reading TLM marker");
  r.get(1);
  int stlm = r.get(1);
  int st = (stlm >> 4) & 3, sp = (stlm >> 6) & 1;
  if (st == 3) refuse("Error reading TLM marker");
  int q = (sp + 1) * 2 + st;
  if (r.left() % q) refuse("Error reading TLM marker");
}

void read_plm(Reader r) {
  if (r.left() < 1) refuse("Error reading PLM marker");
}

void read_plt(Reader r) {
  if (r.left() < 1) refuse("Error reading PLT marker");
  r.get(1);
  int packet_len = 0;
  while (r.left()) {
    int v = r.get(1);
    packet_len = (packet_len << 7) | (v & 0x7f);
    if (v & 0x80) continue;
    packet_len = 0;
  }
  if (packet_len != 0) refuse("Error reading PLT marker");
}

void read_ppm(Codestream& cs, Reader r) {
  if (r.left() < 2) refuse("Error reading PPM marker");
  cs.has_ppm = true;
  int z = r.get(1);
  if ((int)cs.ppm.size() <= z) cs.ppm.resize(z + 1);
  if (!cs.ppm[z].empty()) refuse("Zppm %u already read", z);
  cs.ppm[z].assign(r.p + r.pos, r.p + r.n);
}

// opj_j2k_merge_ppm: the Zppm segments in order, Nppm fields dropped
void merge_ppm(Codestream& cs) {
  uint32_t remaining = 0;
  for (auto& seg : cs.ppm) {
    const uint8_t* d = seg.data();
    size_t n = seg.size();
    if (remaining >= n) { remaining -= (uint32_t)n; continue; }
    cs.ppm_data.insert(cs.ppm_data.end(), d, d + remaining);
    d += remaining; n -= remaining; remaining = 0;
    while (n > 0) {
      if (n < 4) refuse("Not enough bytes to read Nppm");
      uint32_t N = (uint32_t)d[0] << 24 | d[1] << 16 | d[2] << 8 | d[3];
      d += 4; n -= 4;
      if (n >= N) {
        cs.ppm_data.insert(cs.ppm_data.end(), d, d + N);
        d += N; n -= N;
      } else {
        cs.ppm_data.insert(cs.ppm_data.end(), d, d + n);
        remaining = N - (uint32_t)n;
        n = 0;
      }
    }
  }
}

void read_ppt(Codestream& cs, Tcp& tcp, Reader r) {
  if (cs.has_ppm)
    refuse("Error reading PPT marker: packet header have been previously found in the main header (PPM marker).");
  if (r.left() < 2) refuse("Error reading PPT marker");
  tcp.has_ppt = true;
  int z = r.get(1);
  if ((int)tcp.ppt.size() <= z) tcp.ppt.resize(z + 1);
  if (!tcp.ppt[z].empty()) refuse("Zppt %u already read", z);
  tcp.ppt[z].assign(r.p + r.pos, r.p + r.n);
}

}  // namespace

namespace {

// ---- packet headers: opj_bio, opj_tgt ------------------------------------

struct Bio {
  const uint8_t *start, *bp, *end;
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
  size_t numbytes() const { return (size_t)(bp - start); }
};

struct TagTree {
  std::vector<int> parent, value, low;
  void create(int w, int h) {
    parent.clear();
    if (w * h == 0) return;
    std::vector<int> lw{w}, lh{h}, off{0};
    int total = 0;
    for (;;) {
      int n = lw.back() * lh.back();
      total += n;
      if (n <= 1) break;
      off.push_back(total);
      lw.push_back((lw.back() + 1) / 2);
      lh.push_back((lh.back() + 1) / 2);
    }
    parent.assign(total, -1);
    for (size_t l = 0; l + 1 < lw.size(); l++)
      for (int y = 0; y < lh[l]; y++)
        for (int x = 0; x < lw[l]; x++)
          parent[off[l] + y * lw[l] + x] = off[l + 1] + (y / 2) * lw[l + 1] + x / 2;
    reset();
  }
  void reset() {
    value.assign(parent.size(), 999);
    low.assign(parent.size(), 0);
  }
  // opj_tgt_decode
  int decode(Bio& bio, int leaf, int threshold) {
    int stk[64], n = 0;
    int node = leaf;
    while (parent[node] >= 0) {
      stk[n++] = node;
      node = parent[node];
    }
    int lo = 0;
    for (;;) {
      if (lo > low[node]) low[node] = lo;
      else lo = low[node];
      while (lo < threshold && lo < value[node]) {
        if (bio.read(1)) value[node] = lo;
        else ++lo;
      }
      low[node] = lo;
      if (n == 0) break;
      node = stk[--n];
    }
    return value[node] < threshold ? 1 : 0;
  }
};

// ---- the tile's structure: opj_tcd_init_tile ----------------------------

struct Seg {
  int len = 0, numpasses = 0, maxpasses = 0, newlen = 0, numnewpasses = 0;
};

struct Cblk {
  int x0, y0, x1, y1;
  int numbps = 0, numlenbits = 0, numsegs = 0, numnewpasses = 0;
  std::vector<Seg> segs;
  std::vector<uint8_t> data;
};

struct Prec {
  int x0, y0, x1, y1, cw, ch;
  std::vector<Cblk> cblks;
  TagTree incl, imsb;
};

struct Band {
  int bandno, x0, y0, x1, y1, numbps;
  float stepsize;
  std::vector<Prec> precs;
  bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};

struct Res {
  int x0, y0, x1, y1, pw, ph, pdx, pdy, numbands;
  Band bands[3];
};

struct TileComp {
  int x0, y0, x1, y1, numres;
  std::vector<Res> res;
  std::vector<int32_t> idata;
  std::vector<float> fdata;
};

struct Tile {
  int index, x0, y0, x1, y1;
  std::vector<TileComp> comps;
};

void init_tile(const Codestream& cs, const Tcp& tcp, Tile& tile, int index) {
  int p = index % cs.tw, q = index / cs.tw;
  tile.index = index;
  tile.x0 = (int)std::max<int64_t>((int64_t)cs.TX0 + (int64_t)p * cs.TW, cs.X0);
  tile.y0 = (int)std::max<int64_t>((int64_t)cs.TY0 + (int64_t)q * cs.TH, cs.Y0);
  tile.x1 = (int)std::min<int64_t>((int64_t)cs.TX0 + (int64_t)(p + 1) * cs.TW, cs.X1);
  tile.y1 = (int)std::min<int64_t>((int64_t)cs.TY0 + (int64_t)(q + 1) * cs.TH, cs.Y1);
  tile.comps.assign(cs.nc, TileComp());
  for (int c = 0; c < cs.nc; c++) {
    const Comp& ic = cs.comps[c];
    const Tccp& t = tcp.tccps[c];
    TileComp& tc = tile.comps[c];
    tc.x0 = ceildiv(tile.x0, ic.dx);
    tc.y0 = ceildiv(tile.y0, ic.dy);
    tc.x1 = ceildiv(tile.x1, ic.dx);
    tc.y1 = ceildiv(tile.y1, ic.dy);
    tc.numres = t.numres;
    tc.res.assign(t.numres, Res());
    for (int r = 0; r < t.numres; r++) {
      Res& res = tc.res[r];
      int level = t.numres - 1 - r;
      res.x0 = ceildivpow2(tc.x0, level);
      res.y0 = ceildivpow2(tc.y0, level);
      res.x1 = ceildivpow2(tc.x1, level);
      res.y1 = ceildivpow2(tc.y1, level);
      int pdx = t.prcw[r], pdy = t.prch[r];
      res.pdx = pdx;
      res.pdy = pdy;
      int px0 = floordivpow2(res.x0, pdx) << pdx;
      int py0 = floordivpow2(res.y0, pdy) << pdy;
      int64_t px1 = (int64_t)ceildivpow2(res.x1, pdx) << pdx;
      int64_t py1 = (int64_t)ceildivpow2(res.y1, pdy) << pdy;
      res.pw = res.x0 == res.x1 ? 0 : (int)((px1 - px0) >> pdx);
      res.ph = res.y0 == res.y1 ? 0 : (int)((py1 - py0) >> pdy);
      if ((int64_t)res.pw * res.ph > (1 << 26)) refuse("Size of tile data exceeds system limits");
      int64_t cbgx0, cbgy0;
      int cbgw, cbgh;
      if (r == 0) {
        cbgx0 = px0; cbgy0 = py0; cbgw = pdx; cbgh = pdy;
        res.numbands = 1;
      } else {
        cbgx0 = ceildivpow2(px0, 1); cbgy0 = ceildivpow2(py0, 1);
        cbgw = pdx - 1; cbgh = pdy - 1;
        res.numbands = 3;
      }
      int cbw = std::min(t.cblkw, cbgw), cbh = std::min(t.cblkh, cbgh);
      for (int b = 0; b < res.numbands; b++) {
        Band& band = res.bands[b];
        if (r == 0) {
          band.bandno = 0;
          band.x0 = res.x0; band.y0 = res.y0; band.x1 = res.x1; band.y1 = res.y1;
        } else {
          band.bandno = b + 1;
          int xob = band.bandno & 1, yob = band.bandno >> 1;
          band.x0 = ceildivpow2((int64_t)tc.x0 - ((int64_t)xob << level), level + 1);
          band.y0 = ceildivpow2((int64_t)tc.y0 - ((int64_t)yob << level), level + 1);
          band.x1 = ceildivpow2((int64_t)tc.x1 - ((int64_t)xob << level), level + 1);
          band.y1 = ceildivpow2((int64_t)tc.y1 - ((int64_t)yob << level), level + 1);
        }
        int si = r == 0 ? 0 : 3 * (r - 1) + b + 1;
        int gain = t.qmfbid == 0 ? 0 : (band.bandno == 0 ? 0 : band.bandno == 3 ? 2 : 1);
        int numbps = ic.prec + gain;
        band.stepsize = (float)((1.0 + t.mant[si] / 2048.0) * pow(2.0, numbps - t.expn[si]));
        band.numbps = t.expn[si] + t.numgbits - 1;
        band.precs.assign((size_t)res.pw * res.ph, Prec());
        for (int pn = 0; pn < res.pw * res.ph; pn++) {
          Prec& pr = band.precs[pn];
          int64_t sx = cbgx0 + (int64_t)(pn % res.pw) * (1LL << cbgw);
          int64_t sy = cbgy0 + (int64_t)(pn / res.pw) * (1LL << cbgh);
          pr.x0 = (int)std::max<int64_t>(sx, band.x0);
          pr.y0 = (int)std::max<int64_t>(sy, band.y0);
          pr.x1 = (int)std::min<int64_t>(sx + (1LL << cbgw), band.x1);
          pr.y1 = (int)std::min<int64_t>(sy + (1LL << cbgh), band.y1);
          int64_t bx0 = (int64_t)floordivpow2(pr.x0, cbw) << cbw;
          int64_t by0 = (int64_t)floordivpow2(pr.y0, cbh) << cbh;
          int64_t bx1 = (int64_t)ceildivpow2(pr.x1, cbw) << cbw;
          int64_t by1 = (int64_t)ceildivpow2(pr.y1, cbh) << cbh;
          pr.cw = bx1 > bx0 ? (int)((bx1 - bx0) >> cbw) : 0;
          pr.ch = by1 > by0 ? (int)((by1 - by0) >> cbh) : 0;
          pr.cblks.assign((size_t)pr.cw * pr.ch, Cblk());
          for (int k = 0; k < pr.cw * pr.ch; k++) {
            Cblk& cb = pr.cblks[k];
            int64_t cx = bx0 + ((int64_t)(k % pr.cw) << cbw);
            int64_t cy = by0 + ((int64_t)(k / pr.cw) << cbh);
            cb.x0 = (int)std::max<int64_t>(cx, pr.x0);
            cb.y0 = (int)std::max<int64_t>(cy, pr.y0);
            cb.x1 = (int)std::min<int64_t>(cx + (1LL << cbw), pr.x1);
            cb.y1 = (int)std::min<int64_t>(cy + (1LL << cbh), pr.y1);
          }
          pr.incl.create(pr.cw, pr.ch);
          pr.imsb.create(pr.cw, pr.ch);
        }
      }
    }
    size_t n = (size_t)(tc.x1 - tc.x0) * (tc.y1 - tc.y0);
    if (t.qmfbid == 1) tc.idata.assign(n, 0);
    else tc.fdata.assign(n, 0.0f);
  }
}

// ---- the packets in order: opj_pi_create_decode, opj_pi_next_* -----------

struct Packet {
  int layno, resno, compno, precno;
};

std::vector<Packet> packet_order(const Codestream& cs, const Tcp& tcp, const Tile& tile) {
  int max_res = 0, max_prec = 0;
  for (int c = 0; c < cs.nc; c++) {
    const TileComp& tc = tile.comps[c];
    max_res = std::max(max_res, tc.numres);
    for (const Res& r : tc.res) max_prec = std::max(max_prec, r.pw * r.ph);
  }
  int64_t step_p = 1, step_c = (int64_t)max_prec * step_p, step_r = cs.nc * step_c,
          step_l = max_res * step_r;
  int64_t include_size = (tcp.numlayers + 1) * step_l;
  std::vector<uint8_t> include((size_t)include_size, 0);
  std::vector<Packet> out;
  std::vector<Poc> progs;
  if (!tcp.pocs.empty()) {
    progs = tcp.pocs;
  } else {
    progs.push_back(Poc{0, 0, tcp.numlayers, max_res, cs.nc, tcp.prg});
  }
  auto take = [&](int l, int r, int c, int p) -> int {
    int64_t idx = l * step_l + r * step_r + c * step_c + p * step_p;
    if (idx >= include_size || idx < 0) return -1;  // "Invalid access to pi->include"
    if (!include[idx]) {
      include[idx] = 1;
      out.push_back(Packet{l, r, c, p});
    }
    return 0;
  };
  for (const Poc& poc : progs) {
    int prg = poc.prg;
    if (prg < 0) refuse("Unknown progression order in COD marker");
    if (prg > 4) continue;  // opj_pi_next of an order it does not know: no packets
    int l0 = 0, l1 = poc.layno1, r0 = poc.resno0, r1 = poc.resno1, c0 = poc.compno0,
        c1 = poc.compno1;
    bool stop = false;
    if (prg == 0) {  // LRCP
      for (int l = l0; l < l1 && !stop; l++)
        for (int r = r0; r < r1 && !stop; r++)
          for (int c = c0; c < c1 && !stop; c++) {
            const TileComp& tc = tile.comps[c];
            if (r >= tc.numres) continue;
            const Res& res = tc.res[r];
            for (int p = 0; p < res.pw * res.ph && !stop; p++) stop = take(l, r, c, p) < 0;
          }
    } else if (prg == 1) {  // RLCP
      for (int r = r0; r < r1 && !stop; r++)
        for (int l = l0; l < l1 && !stop; l++)
          for (int c = c0; c < c1 && !stop; c++) {
            const TileComp& tc = tile.comps[c];
            if (r >= tc.numres) continue;
            const Res& res = tc.res[r];
            for (int p = 0; p < res.pw * res.ph && !stop; p++) stop = take(l, r, c, p) < 0;
          }
    } else {
      // RPCL, PCRL, CPRL walk the reference grid in steps of the smallest
      // precinct of the components they cover
      auto min_step = [&](int cfrom, int cto, uint32_t& dx, uint32_t& dy) {
        dx = dy = 0;
        for (int c = cfrom; c < cto; c++) {
          const TileComp& tc = tile.comps[c];
          for (int r = 0; r < tc.numres; r++) {
            const Res& res = tc.res[r];
            int sx = res.pdx + tc.numres - 1 - r, sy = res.pdy + tc.numres - 1 - r;
            if (sx < 32 && (uint32_t)cs.comps[c].dx <= UINT32_MAX / (1u << sx)) {
              uint32_t d = cs.comps[c].dx * (1u << sx);
              dx = !dx ? d : std::min(dx, d);
            }
            if (sy < 32 && (uint32_t)cs.comps[c].dy <= UINT32_MAX / (1u << sy)) {
              uint32_t d = cs.comps[c].dy * (1u << sy);
              dy = !dy ? d : std::min(dy, d);
            }
          }
        }
      };
      // the packets of (r, c) at grid position (x, y), if any
      auto at = [&](int r, int c, int64_t x, int64_t y) -> int {
        const TileComp& tc = tile.comps[c];
        if (r >= tc.numres) return 1;
        const Res& res = tc.res[r];
        uint32_t cdx = cs.comps[c].dx, cdy = cs.comps[c].dy;
        int level = tc.numres - 1 - r;
        if (level >= 32 || ((cdx << level) >> level) != cdx || ((cdy << level) >> level) != cdy)
          return 1;
        int64_t sdx = (int64_t)cdx << level, sdy = (int64_t)cdy << level;
        int64_t trx0 = ceildiv(tile.x0, sdx), try0 = ceildiv(tile.y0, sdy);
        int64_t trx1 = ceildiv(tile.x1, sdx), try1 = ceildiv(tile.y1, sdy);
        int rpx = res.pdx + level, rpy = res.pdy + level;
        if (rpx >= 31 || ((cdx << rpx) >> rpx) != cdx || rpy >= 31 || ((cdy << rpy) >> rpy) != cdy)
          return 1;
        if (!(((uint64_t)y % ((uint64_t)cdy << rpy) == 0) ||
              ((y == tile.y0) && (((uint64_t)try0 << level) % ((uint64_t)1 << rpy)))))
          return 1;
        if (!(((uint64_t)x % ((uint64_t)cdx << rpx) == 0) ||
              ((x == tile.x0) && (((uint64_t)trx0 << level) % ((uint64_t)1 << rpx)))))
          return 1;
        if (res.pw == 0 || res.ph == 0) return 1;
        if (trx0 == trx1 || try0 == try1) return 1;
        int prci = floordivpow2(ceildiv(x, sdx), res.pdx) - floordivpow2(trx0, res.pdx);
        int prcj = floordivpow2(ceildiv(y, sdy), res.pdy) - floordivpow2(try0, res.pdy);
        int p = prci + prcj * res.pw;
        for (int l = l0; l < l1; l++)
          if (take(l, r, c, p) < 0) return -1;
        return 1;
      };
      uint32_t dx, dy;
      if (prg == 2) {  // RPCL
        min_step(0, cs.nc, dx, dy);
        if (!dx || !dy) continue;
        for (int r = r0; r < r1 && !stop; r++)
          for (int64_t y = tile.y0; y < tile.y1 && !stop; y += dy - (y % dy))
            for (int64_t x = tile.x0; x < tile.x1 && !stop; x += dx - (x % dx))
              for (int c = c0; c < c1 && !stop; c++) stop = at(r, c, x, y) < 0;
      } else if (prg == 3) {  // PCRL
        min_step(0, cs.nc, dx, dy);
        if (!dx || !dy) continue;
        for (int64_t y = tile.y0; y < tile.y1 && !stop; y += dy - (y % dy))
          for (int64_t x = tile.x0; x < tile.x1 && !stop; x += dx - (x % dx))
            for (int c = c0; c < c1 && !stop; c++)
              for (int r = r0; r < r1 && !stop; r++) stop = at(r, c, x, y) < 0;
      } else {  // CPRL
        for (int c = c0; c < c1 && !stop; c++) {
          min_step(c, c + 1, dx, dy);
          if (!dx || !dy) break;
          int rmax = std::min(r1, tile.comps[c].numres);
          for (int64_t y = tile.y0; y < tile.y1 && !stop; y += dy - (y % dy))
            for (int64_t x = tile.x0; x < tile.x1 && !stop; x += dx - (x % dx))
              for (int r = r0; r < rmax && !stop; r++) stop = at(r, c, x, y) < 0;
        }
      }
    }
  }
  return out;
}

// ---- T2: opj_t2_read_packet_header / opj_t2_read_packet_data -------------

void init_seg(Cblk& cb, int index, int cblksty, bool first) {
  if ((int)cb.segs.size() <= index) cb.segs.resize(index + 1);
  Seg& s = cb.segs[index];
  s = Seg();
  if (cblksty & 4) {
    s.maxpasses = 1;
  } else if (cblksty & 1) {
    if (first) {
      s.maxpasses = 10;
    } else {
      int prev = cb.segs[index - 1].maxpasses;
      s.maxpasses = (prev == 1 || prev == 10) ? 2 : 1;
    }
  } else {
    s.maxpasses = 109;
  }
}

int getnumpasses(Bio& bio) {
  if (!bio.read(1)) return 1;
  if (!bio.read(1)) return 2;
  int n = bio.read(2);
  if (n != 3) return 3 + n;
  n = bio.read(5);
  if (n != 31) return 6 + n;
  return 37 + bio.read(7);
}

int floorlog2(uint32_t v) {
  int l = 0;
  while (v > 1) { v >>= 1; l++; }
  return l;
}

struct HeaderSource {
  const uint8_t* p;
  size_t n, pos;
};

void read_packet(const Tcp& tcp, Tile& tile, const Packet& pk,
                 const std::vector<uint8_t>& data, size_t& pos, HeaderSource* hs) {
  TileComp& tc = tile.comps[pk.compno];
  Res& res = tc.res[pk.resno];
  const Tccp& tccp = tcp.tccps[pk.compno];
  if (pk.layno == 0) {
    for (int b = 0; b < res.numbands; b++) {
      Band& band = res.bands[b];
      if (band.empty()) continue;
      if (pk.precno >= (int)band.precs.size()) refuse("Invalid precinct");
      Prec& pr = band.precs[pk.precno];
      if (!pr.incl.parent.empty()) pr.incl.reset();
      if (!pr.imsb.parent.empty()) pr.imsb.reset();
      for (Cblk& cb : pr.cblks) cb.numsegs = 0;
    }
  }
  size_t end = data.size();
  if (tcp.csty & 2) {  // SOP: optional, a warning when it is not there
    if (end - pos >= 6 && data[pos] == 0xff && data[pos + 1] == 0x91) pos += 6;
  }
  HeaderSource own{data.data(), end, pos};
  HeaderSource& h = hs ? *hs : own;
  Bio bio(h.p + h.pos, h.n - h.pos);
  auto eph = [&](size_t& hp) {  // required, where SOP is not
    if (tcp.csty & 4) {
      if (h.n - hp < 2) refuse("Not enough space for required EPH marker");
      if (h.p[hp] != 0xff || h.p[hp + 1] != 0x92) refuse("Expected EPH marker");
      hp += 2;
    }
  };
  if (!bio.read(1)) {
    bio.inalign();
    size_t hp = h.pos + bio.numbytes();
    eph(hp);
    h.pos = hp;
    if (!hs) pos = hp;
    return;
  }
  for (int b = 0; b < res.numbands; b++) {
    Band& band = res.bands[b];
    if (band.empty()) continue;
    if (pk.precno >= (int)band.precs.size()) refuse("Invalid precinct");
    Prec& pr = band.precs[pk.precno];
    for (int k = 0; k < (int)pr.cblks.size(); k++) {
      Cblk& cb = pr.cblks[k];
      int included = !cb.numsegs ? pr.incl.decode(bio, k, pk.layno + 1) : (int)bio.read(1);
      if (!included) {
        cb.numnewpasses = 0;
        continue;
      }
      if (!cb.numsegs) {
        int i = 0;
        while (!pr.imsb.decode(bio, k, i)) ++i;
        cb.numbps = band.numbps + 1 - i;
        cb.numlenbits = 3;
      }
      cb.numnewpasses = getnumpasses(bio);
      int incr = 0;
      while (bio.read(1)) ++incr;
      cb.numlenbits += incr;
      int segno = 0;
      if (!cb.numsegs) {
        init_seg(cb, 0, tccp.cblksty, true);
      } else {
        segno = cb.numsegs - 1;
        if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
          ++segno;
          init_seg(cb, segno, tccp.cblksty, false);
        }
      }
      int n = cb.numnewpasses;
      do {
        Seg& s = cb.segs[segno];
        s.numnewpasses = std::min(s.maxpasses - s.numpasses, n);
        int bits = cb.numlenbits + floorlog2((uint32_t)s.numnewpasses);
        if (bits > 32) refuse("Invalid bit number %d in opj_t2_read_packet_header()", bits);
        s.newlen = (int)bio.read(bits);
        n -= s.numnewpasses;
        if (n > 0) {
          ++segno;
          init_seg(cb, segno, tccp.cblksty, false);
        }
      } while (n > 0);
    }
  }
  bio.inalign();
  size_t hp = h.pos + bio.numbytes();
  eph(hp);
  if (hp == h.pos) refuse("packet header of length 0");
  h.pos = hp;
  if (!hs) pos = hp;
  // the packet's body
  for (int b = 0; b < res.numbands; b++) {
    Band& band = res.bands[b];
    if (band.empty()) continue;
    Prec& pr = band.precs[pk.precno];
    for (int k = 0; k < (int)pr.cblks.size(); k++) {
      Cblk& cb = pr.cblks[k];
      if (!cb.numnewpasses) continue;
      int si;
      if (!cb.numsegs) {
        si = 0;
        cb.numsegs = 1;
      } else {
        si = cb.numsegs - 1;
        if (cb.segs[si].numpasses == cb.segs[si].maxpasses) {
          ++si;
          ++cb.numsegs;
        }
      }
      do {
        Seg& s = cb.segs[si];
        if ((size_t)s.newlen > end - pos)
          refuse("read: segment too long (%d) with max (%d) for codeblock %d (p=%d, b=%d, r=%d, c=%d)",
                 s.newlen, (int)(end - pos), k, pk.precno, b, pk.resno, pk.compno);
        cb.data.insert(cb.data.end(), data.begin() + pos, data.begin() + pos + s.newlen);
        pos += s.newlen;
        s.len += s.newlen;
        s.numpasses += s.numnewpasses;
        cb.numnewpasses -= s.numnewpasses;
        if (cb.numnewpasses > 0) {
          ++si;
          ++cb.numsegs;
        }
      } while (cb.numnewpasses > 0);
    }
  }
}

}  // namespace

namespace {

// ---- T1: the MQ decoder (opj_mqc_*) ----------------------------------------

const uint16_t QE[47] = {
    0x5601, 0x3401, 0x1801, 0x0ac1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801,
    0x3001, 0x2401, 0x1c01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401,
    0x3001, 0x2801, 0x2401, 0x2201, 0x1c01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101,
    0x0ac1, 0x09c1, 0x08a1, 0x0521, 0x0441, 0x02a1, 0x0221, 0x0141, 0x0111, 0x0085,
    0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601};
const uint8_t NMPS[47] = {1,  2,  3,  4,  5,  38, 7,  8,  9,  10, 11, 12, 13, 29, 15, 16,
                          17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
                          33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
const uint8_t NLPS[47] = {1,  6,  9,  12, 29, 33, 6,  14, 14, 14, 17, 18, 20, 21, 14, 14,
                          15, 16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
                          30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
const uint8_t SWITCH[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0,
                            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

enum { CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18, NCTX = 19 };

struct Mqc {
  const uint8_t* bp;
  uint32_t a, c;
  int ct;
  uint8_t st[NCTX], mps[NCTX];
  void reset_states() {
    memset(st, 0, sizeof st);
    memset(mps, 0, sizeof mps);
    st[CTX_UNI] = 46;
    st[CTX_AGG] = 3;
    st[0] = 4;
  }
  // buf holds the segment followed by 0xff 0xff
  void init(const uint8_t* buf, size_t len) {
    bp = buf;
    c = len == 0 ? 0xffu << 16 : (uint32_t)buf[0] << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void init_raw(const uint8_t* buf) {
    bp = buf;
    c = 0;
    ct = 0;
  }
  void bytein() {
    uint32_t next = bp[1];
    if (bp[0] == 0xff) {
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
    int s = st[cx];
    uint32_t q = QE[s];
    int d;
    a -= q;
    if ((c >> 16) < q) {
      if (a < q) {
        d = mps[cx];
        st[cx] = NMPS[s];
      } else {
        d = !mps[cx];
        if (SWITCH[s]) mps[cx] = !mps[cx];
        st[cx] = NLPS[s];
      }
      a = q;
      renorm();
    } else {
      c -= q << 16;
      if ((a & 0x8000) == 0) {
        if (a < q) {
          d = !mps[cx];
          if (SWITCH[s]) mps[cx] = !mps[cx];
          st[cx] = NLPS[s];
        } else {
          d = mps[cx];
          st[cx] = NMPS[s];
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
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
    return (c >> ct) & 1;
  }
};

// ---- T1: the passes ----------------------------------------------------------

// each coefficient's state word: its 8 neighbours' significance, the
// signs of its 4 direct neighbours, its own significance, visit (this
// bit-plane's significance pass), refinement and sign
enum : uint16_t {
  NW = 1, N = 2, NE = 4, W = 8, E = 16, SW = 32, S = 64, SE = 128,
  NEG_N = 256, NEG_S = 512, NEG_W = 1024, NEG_E = 2048,
  SIG = 4096, VISIT = 8192, REFINED = 16384, NEG = 32768
};

uint8_t ZC_LUT[4][256];

void init_luts() {
  static bool done = false;
  if (done) return;
  for (int o = 0; o < 4; o++)
    for (int f = 0; f < 256; f++) {
      int h = !!(f & W) + !!(f & E), v = !!(f & N) + !!(f & S);
      int d = !!(f & NW) + !!(f & NE) + !!(f & SW) + !!(f & SE);
      int n;
      if (o == 1) std::swap(h, v);
      if (o == 3) {
        int hv = h + v;
        if (d >= 3) n = 8;
        else if (d == 2) n = hv >= 1 ? 7 : 6;
        else if (d == 1) n = hv >= 2 ? 5 : hv == 1 ? 4 : 3;
        else n = hv >= 2 ? 2 : hv == 1 ? 1 : 0;
      } else {
        if (h == 2) n = 8;
        else if (h == 1) n = v >= 1 ? 7 : d >= 1 ? 6 : 5;
        else if (v == 2) n = 4;
        else if (v == 1) n = 3;
        else n = d >= 2 ? 2 : d;
      }
      ZC_LUT[o][f] = (uint8_t)n;
    }
  done = true;
}

struct T1 {
  int w, h, stride, orient, cblksty;
  std::vector<uint16_t> flags;  // (w + 2) x (h + 2)
  std::vector<int32_t> data;    // w x h
  Mqc mqc;
  bool vsc;

  uint16_t& f(int x, int y) { return flags[(size_t)(y + 1) * stride + x + 1]; }

  void set_sig(int x, int y, int neg) {
    f(x, y) |= SIG | (neg ? NEG : 0);
    // the row above sees this only when it is in the same stripe or the
    // code block is not vertically causal
    if (!(vsc && (y & 3) == 0)) {
      f(x - 1, y - 1) |= SE;
      f(x, y - 1) |= S | (neg ? NEG_S : 0);
      f(x + 1, y - 1) |= SW;
    }
    f(x - 1, y) |= E | (neg ? NEG_E : 0);
    f(x + 1, y) |= W | (neg ? NEG_W : 0);
    f(x - 1, y + 1) |= NE;
    f(x, y + 1) |= N | (neg ? NEG_N : 0);
    f(x + 1, y + 1) |= NW;
  }

  int decode_sign(uint16_t fl) {
    auto contrib = [](uint16_t g, uint16_t sig, uint16_t neg) {
      return (g & sig) ? ((g & neg) ? -1 : 1) : 0;
    };
    int hc = contrib(fl, W, NEG_W) + contrib(fl, E, NEG_E);
    int vc = contrib(fl, N, NEG_N) + contrib(fl, S, NEG_S);
    hc = hc < -1 ? -1 : hc > 1 ? 1 : hc;
    vc = vc < -1 ? -1 : vc > 1 ? 1 : vc;
    int ctx, x = 0;
    if (hc < 0) {
      hc = -hc;
      vc = -vc;
      x = 1;
    }
    if (hc == 0 && vc < 0) {
      vc = -vc;
      x = 1;
    }
    if (hc == 0) ctx = vc == 0 ? 9 : 10;
    else ctx = vc == 1 ? 13 : vc == 0 ? 12 : 11;
    return mqc.decode(ctx) ^ x;
  }

  void sigpass(int bpno, bool raw) {
    int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; x++)
        for (int y = y0; y < y0 + 4 && y < h; y++) {
          uint16_t& fl = f(x, y);
          if ((fl & (SIG | VISIT)) || !(fl & 0xff)) continue;
          int bit = raw ? mqc.raw() : mqc.decode(ZC_LUT[orient][fl & 0xff]);
          if (bit) {
            int neg = raw ? mqc.raw() : decode_sign(fl);
            data[(size_t)y * w + x] = neg ? -oneplushalf : oneplushalf;
            set_sig(x, y, neg);
          }
          f(x, y) |= VISIT;
        }
  }

  void refpass(int bpno, bool raw) {
    int32_t poshalf = (1 << bpno) >> 1;
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; x++)
        for (int y = y0; y < y0 + 4 && y < h; y++) {
          uint16_t& fl = f(x, y);
          if ((fl & (SIG | VISIT)) != SIG) continue;
          int bit;
          if (raw) {
            bit = mqc.raw();
          } else {
            int ctx = (fl & REFINED) ? CTX_MAG + 2 : (fl & 0xff) ? CTX_MAG + 1 : CTX_MAG;
            bit = mqc.decode(ctx);
          }
          int32_t& d = data[(size_t)y * w + x];
          d += (bit ^ (d < 0)) ? poshalf : -poshalf;
          fl |= REFINED;
        }
  }

  void clnpass(int bpno) {
    int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
    auto step = [&](int x, int y, bool known) {
      uint16_t fl = f(x, y);
      if (!known) {
        if (fl & (SIG | VISIT)) return;
        if (!mqc.decode(ZC_LUT[orient][fl & 0xff])) return;
      }
      int neg = decode_sign(fl);
      data[(size_t)y * w + x] = neg ? -oneplushalf : oneplushalf;
      set_sig(x, y, neg);
    };
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; x++) {
        int y = y0;
        if (y0 + 4 <= h && !f(x, y0) && !f(x, y0 + 1) && !f(x, y0 + 2) && !f(x, y0 + 3)) {
          if (!mqc.decode(CTX_AGG)) goto clear;
          int run = mqc.decode(CTX_UNI) << 1;
          run |= mqc.decode(CTX_UNI);
          y = y0 + run;
          step(x, y, true);
          y++;
        }
        for (; y < y0 + 4 && y < h; y++) step(x, y, false);
      clear:
        for (int yy = y0; yy < y0 + 4 && yy < h; yy++) f(x, yy) &= ~VISIT;
      }
    if (cblksty & 32) {  // segmentation symbol: read, a warning when not 0xa
      for (int i = 0; i < 4; i++) mqc.decode(CTX_UNI);
    }
  }
};

// opj_t1_decode_cblk, then opj_t1_clbl_decode_processor's ROI and
// dequantisation into the tile-component
void decode_cblk(T1& t1, const Cblk& cb, const Band& band, int orient, const Tccp& tccp,
                 TileComp& tc, int resno) {
  int w = cb.x1 - cb.x0, h = cb.y1 - cb.y0;
  if (w <= 0 || h <= 0) return;
  t1.w = w;
  t1.h = h;
  t1.stride = w + 2;
  t1.orient = orient;
  t1.cblksty = tccp.cblksty;
  t1.vsc = tccp.cblksty & 8;
  t1.flags.assign((size_t)(w + 2) * (h + 2), 0);
  t1.data.assign((size_t)w * h, 0);
  t1.mqc.reset_states();
  int bpno_plus_one = tccp.roishift + cb.numbps;
  if (bpno_plus_one >= 31) refuse("opj_t1_decode_cblk(): unsupported bpno_plus_one = %d >= 31", bpno_plus_one);
  int passtype = 2;
  size_t at = 0;
  std::vector<uint8_t> buf;
  for (int s = 0; s < cb.numsegs; s++) {
    const Seg& seg = cb.segs[s];
    bool raw = bpno_plus_one <= cb.numbps - 4 && passtype < 2 && (tccp.cblksty & 1);
    if (at + seg.len > cb.data.size()) refuse("code-block data shorter than its segments");
    buf.assign(cb.data.begin() + at, cb.data.begin() + at + seg.len);
    buf.push_back(0xff);
    buf.push_back(0xff);
    buf.push_back(0xff);
    if (raw) t1.mqc.init_raw(buf.data());
    else t1.mqc.init(buf.data(), seg.len);
    at += seg.len;
    for (int p = 0; p < seg.numpasses && bpno_plus_one >= 1; p++) {
      if (passtype == 0) t1.sigpass(bpno_plus_one, raw);
      else if (passtype == 1) t1.refpass(bpno_plus_one, raw);
      else t1.clnpass(bpno_plus_one);
      if ((tccp.cblksty & 2) && !raw) t1.mqc.reset_states();
      if (++passtype == 3) {
        passtype = 0;
        bpno_plus_one--;
      }
    }
  }
  std::vector<int32_t>& d = t1.data;
  if (tccp.roishift) {
    if (tccp.roishift >= 31) {
      std::fill(d.begin(), d.end(), 0);
    } else {
      int32_t thresh = 1 << tccp.roishift;
      for (int32_t& v : d) {
        int32_t mag = v < 0 ? -v : v;
        if (mag >= thresh) {
          mag >>= tccp.roishift;
          v = v < 0 ? -mag : mag;
        }
      }
    }
  }
  int x = cb.x0 - band.x0, y = cb.y0 - band.y0;
  if (band.bandno & 1) x += tc.res[resno - 1].x1 - tc.res[resno - 1].x0;
  if (band.bandno & 2) y += tc.res[resno - 1].y1 - tc.res[resno - 1].y0;
  size_t tw = (size_t)(tc.x1 - tc.x0);
  if (tccp.qmfbid == 1) {
    for (int j = 0; j < h; j++)
      for (int i = 0; i < w; i++) tc.idata[(y + j) * tw + x + i] = d[(size_t)j * w + i] / 2;
  } else {
    const float step = 0.5f * band.stepsize;
    for (int j = 0; j < h; j++)
      for (int i = 0; i < w; i++)
        tc.fdata[(y + j) * tw + x + i] = (float)d[(size_t)j * w + i] * step;
  }
}

// ---- the inverse wavelets: opj_dwt_decode_tile, opj_dwt_decode_tile_97 -----

// one line of `len` samples, its sn low-pass ones first, into x in place
void idwt53_line(int32_t* x, int sn, int dn, int cas, std::vector<int32_t>& tmp) {
  int len = sn + dn;
  if (len == 1) {
    if (cas) x[0] /= 2;
    return;
  }
  if (len == 0) return;
  tmp.resize(len);
  for (int i = 0; i < sn; i++) tmp[2 * i + cas] = x[i];
  for (int i = 0; i < dn; i++) tmp[2 * i + 1 - cas] = x[sn + i];
  auto at = [&](int k) { return tmp[k < 0 ? -k : k >= len ? 2 * (len - 1) - k : k]; };
  for (int k = cas; k < len; k += 2) tmp[k] -= (at(k - 1) + at(k + 1) + 2) >> 2;
  for (int k = 1 - cas; k < len; k += 2) tmp[k] += (at(k - 1) + at(k + 1)) >> 1;
  memcpy(x, tmp.data(), len * sizeof(int32_t));
}

const float K97 = 1.230174105f, C13318 = 1.625732422f;
const float LIFT[4] = {-0.443506852f, -0.882911075f, 0.052980118f, 1.586134342f};

void idwt97_line(float* x, int sn, int dn, int cas, std::vector<float>& tmp) {
  int len = sn + dn;
  if (cas == 0 ? !(dn > 0 || sn > 1) : !(sn > 0 || dn > 1)) return;
  tmp.resize(len);
  for (int i = 0; i < sn; i++) tmp[2 * i + cas] = x[i] * K97;
  for (int i = 0; i < dn; i++) tmp[2 * i + 1 - cas] = x[sn + i] * C13318;
  auto at = [&](int k) { return tmp[k < 0 ? -k : k >= len ? 2 * (len - 1) - k : k]; };
  for (int s = 0; s < 4; s++) {
    const float c = LIFT[s];
    int first = (s & 1) ? 1 - cas : cas;  // delta, beta: low; gamma, alpha: high
    for (int k = first; k < len; k += 2) {
      float sum = at(k - 1) + at(k + 1);
      tmp[k] = tmp[k] + sum * c;
    }
  }
  memcpy(x, tmp.data(), len * sizeof(float));
}

template <typename T, typename F>
void idwt_tile(std::vector<T>& data, const TileComp& tc, int numres, F line) {
  size_t w = (size_t)(tc.x1 - tc.x0);
  std::vector<T> tmp, col;
  for (int r = 1; r < numres; r++) {
    const Res& lo = tc.res[r - 1];
    const Res& res = tc.res[r];
    int rw = res.x1 - res.x0, rh = res.y1 - res.y0;
    int sn = lo.x1 - lo.x0, cas = res.x0 % 2;
    for (int j = 0; j < rh; j++) line(&data[j * w], sn, rw - sn, cas, tmp);
    sn = lo.y1 - lo.y0;
    cas = res.y0 % 2;
    col.resize(rh);
    for (int i = 0; i < rw; i++) {
      for (int j = 0; j < rh; j++) col[j] = data[j * w + i];
      line(col.data(), sn, rh - sn, cas, tmp);
      for (int j = 0; j < rh; j++) data[j * w + i] = col[j];
    }
  }
}

// ---- decoding a tile: opj_tcd_decode_tile ---------------------------------------

struct Decoder {
  Codestream cs;
  std::vector<int> resno_decoded;
  int32_t* out;
  int64_t out_len;
  int32_t* dims;  // per tile and component: width, height
  std::vector<int64_t> offsets;  // per tile: where its components start in out
};

void decode_tile(Decoder& dec, int index) {
  Codestream& cs = dec.cs;
  Tcp& tcp = cs.tcps[index];
  Tile tile;
  init_tile(cs, tcp, tile, index);
  // T2
  std::vector<uint8_t> ppt;
  HeaderSource hsrc{nullptr, 0, 0}, *hs = nullptr;
  if (cs.has_ppm) {
    hsrc = HeaderSource{cs.ppm_data.data(), cs.ppm_data.size(), cs.ppm_pos};
    hs = &hsrc;
  } else if (tcp.has_ppt) {
    for (auto& seg : tcp.ppt) ppt.insert(ppt.end(), seg.begin(), seg.end());
    hsrc = HeaderSource{ppt.data(), ppt.size(), 0};
    hs = &hsrc;
  }
  size_t pos = 0;
  for (const Packet& pk : packet_order(cs, tcp, tile)) {
    if (pk.resno >= tile.comps[pk.compno].numres) continue;
    read_packet(tcp, tile, pk, tcp.data, pos, hs);
    dec.resno_decoded[pk.compno] = std::max(dec.resno_decoded[pk.compno], pk.resno);
  }
  if (cs.has_ppm) cs.ppm_pos = hsrc.pos;
  // T1
  T1 t1;
  for (int c = 0; c < cs.nc; c++) {
    TileComp& tc = tile.comps[c];
    const Tccp& tccp = tcp.tccps[c];
    for (int r = 0; r < tc.numres; r++)
      for (int b = 0; b < tc.res[r].numbands; b++) {
        Band& band = tc.res[r].bands[b];
        if (band.empty()) continue;
        for (Prec& pr : band.precs)
          for (Cblk& cb : pr.cblks) decode_cblk(t1, cb, band, band.bandno, tccp, tc, r);
      }
  }
  // the inverse wavelets up to the resolution decoded
  for (int c = 0; c < cs.nc; c++) {
    TileComp& tc = tile.comps[c];
    int numres = std::min(tc.numres, dec.resno_decoded[c] + 1);
    if (tcp.tccps[c].qmfbid == 1) idwt_tile(tc.idata, tc, numres, idwt53_line);
    else idwt_tile(tc.fdata, tc, numres, idwt97_line);
  }
  // the inverse component transform (opj_tcd_mct_decode)
  if (tcp.mct && cs.nc >= 3) {
    const TileComp& a = tile.comps[0];
    size_t n = (size_t)(a.x1 - a.x0) * (a.y1 - a.y0);
    for (int c = 1; c < 3; c++) {
      const TileComp& b = tile.comps[c];
      if (dec.resno_decoded[c] != dec.resno_decoded[0] ||
          (size_t)(b.x1 - b.x0) * (b.y1 - b.y0) != n || a.numres != b.numres)
        refuse("Tiles don't all have the same dimension. Skip the MCT step.");
    }
    if (tcp.tccps[0].qmfbid == 1) {
      int32_t *c0 = tile.comps[0].idata.data(), *c1 = tile.comps[1].idata.data(),
              *c2 = tile.comps[2].idata.data();
      if (!c1 || !c2) refuse("MCT over components of another wavelet");
      for (size_t i = 0; i < n; i++) {
        int32_t y = c0[i], u = c1[i], v = c2[i];
        int32_t g = y - ((u + v) >> 2);
        c0[i] = v + g;
        c1[i] = g;
        c2[i] = u + g;
      }
    } else {
      float *c0 = tile.comps[0].fdata.data(), *c1 = tile.comps[1].fdata.data(),
            *c2 = tile.comps[2].fdata.data();
      if (!c1 || !c2) refuse("MCT over components of another wavelet");
      for (size_t i = 0; i < n; i++) {
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
  // the DC level shift, rounding and clamp (opj_tcd_dc_level_shift_decode),
  // then the samples of the resolution decoded
  int64_t at = dec.offsets[index];
  for (int c = 0; c < cs.nc; c++) {
    TileComp& tc = tile.comps[c];
    const Comp& ic = cs.comps[c];
    const Res& res = tc.res[std::min(tc.numres - 1, dec.resno_decoded[c])];
    int rw = res.x1 - res.x0, rh = res.y1 - res.y0;
    size_t w = (size_t)(tc.x1 - tc.x0);
    int32_t lo, hi, shift;
    if (ic.sgnd) {
      lo = -(int32_t)(1u << (ic.prec - 1));
      hi = (int32_t)((1u << (ic.prec - 1)) - 1);
      shift = 0;
    } else {
      lo = 0;
      hi = (int32_t)((1u << ic.prec) - 1);
      shift = (int32_t)(1u << (ic.prec - 1));
    }
    if (at + (int64_t)rw * rh > dec.out_len) refuse("output buffer too small");
    int32_t* o = dec.out + at;
    for (int j = 0; j < rh; j++)
      for (int i = 0; i < rw; i++) {
        int64_t v;
        if (tcp.tccps[c].qmfbid == 1) {
          v = (int64_t)tc.idata[j * w + i] + shift;
        } else {
          float f = tc.fdata[j * w + i];
          if (f > (float)INT32_MAX) v = hi;
          else if (f < (float)INT32_MIN) v = lo;
          else v = (int64_t)lrintf(f) + shift;
        }
        o[(size_t)j * rw + i] = (int32_t)(v < lo ? lo : v > hi ? hi : v);
      }
    dec.dims[((int64_t)index * cs.nc + c) * 2] = rw;
    dec.dims[((int64_t)index * cs.nc + c) * 2 + 1] = rh;
    at += (int64_t)(tc.x1 - tc.x0) * (tc.y1 - tc.y0);
  }
}

}  // namespace

namespace {

Reader segment(Reader& r) {
  uint32_t len = r.get(2);
  if (len < 2) refuse("Invalid marker size");
  if (r.left() < len - 2) refuse("Stream too short");
  Reader s(r.p + r.pos, len - 2);
  r.pos += len - 2;
  return s;
}

// opj_j2k_read_unk: 2-byte words up to the next marker OpenJPEG knows
int skip_unknown(Reader& r, int state) {
  for (;;) {
    uint32_t m = r.get(2);
    if (m < 0xff00) continue;
    int st = marker_states(m);
    if (st == -1) continue;
    if (!(st & state)) refuse("Marker is not compliant with its position");
    return (int)m;
  }
}

void read_marker(Decoder& dec, Tcp& tcp, int m, Reader s, bool tile) {
  Codestream& cs = dec.cs;
  switch (m) {
    case COD: read_cod(cs, tcp, s, tile); break;
    case COC: read_coc(cs, tcp, s); break;
    case QCD: read_qcd(cs, tcp, s); break;
    case QCC: read_qcc(cs, tcp, s); break;
    case RGN: read_rgn(cs, tcp, s); break;
    case POC: read_poc(cs, tcp, s); break;
    case PPM: read_ppm(cs, s); break;
    case PPT: read_ppt(cs, tcp, s); break;
    case TLM: read_tlm(s); break;
    case PLM: read_plm(s); break;
    case PLT: read_plt(s); break;
    case CRG: read_crg(cs, s); break;
    case COM: break;
    case CAP: case CPF: break;  // Part 15's signalling: read and ignored
    case MCT: case MCC: case MCO: case CBD:
      unported("the JPEG 2000 Part 2 extensions (MCT / MCC / MCO / CBD markers)");
    default: refuse("Marker is not compliant with its position");
  }
}

int64_t tile_size(const Codestream& cs, int index) {
  int p = index % cs.tw, q = index / cs.tw;
  int64_t x0 = std::max<int64_t>((int64_t)cs.TX0 + (int64_t)p * cs.TW, cs.X0);
  int64_t y0 = std::max<int64_t>((int64_t)cs.TY0 + (int64_t)q * cs.TH, cs.Y0);
  int64_t x1 = std::min<int64_t>((int64_t)cs.TX0 + (int64_t)(p + 1) * cs.TW, cs.X1);
  int64_t y1 = std::min<int64_t>((int64_t)cs.TY0 + (int64_t)(q + 1) * cs.TH, cs.Y1);
  int64_t n = 0;
  for (const Comp& c : cs.comps)
    n += (int64_t)(ceildiv(x1, c.dx) - ceildiv(x0, c.dx)) * (ceildiv(y1, c.dy) - ceildiv(y0, c.dy));
  return n;
}

void run(Decoder& dec, const uint8_t* d, size_t n, int32_t* order, int32_t n_tiles,
         int32_t* n_decoded) {
  init_luts();
  Codestream& cs = dec.cs;
  Reader r(d, n);
  if (r.get(2) != SOC) refuse("Expected a SOC marker");
  if (r.get(2) != SIZ) refuse("Marker is not compliant with its position");
  read_siz(cs, segment(r));
  int nt = cs.tw * cs.th;
  if (nt != n_tiles) refuse("%d tiles, not %d", nt, n_tiles);
  dec.offsets.resize(nt);
  int64_t total = 0;
  for (int t = 0; t < nt; t++) {
    dec.offsets[t] = total;
    total += tile_size(cs, t);
  }
  if (total != dec.out_len) refuse("an output of %lld samples, not %lld", (long long)dec.out_len,
                                   (long long)total);
  dec.resno_decoded.assign(cs.nc, 0);
  bool has_cod = false, has_qcd = false;
  int m = r.get(2);
  while (m != SOT) {
    if (m < 0xff00) refuse("A marker ID was expected (0xff--) instead of %.8x", m);
    if (marker_states(m) == -1) {
      m = skip_unknown(r, MH);
      if (m == SOT) break;
    }
    if (!(marker_states(m) & MH)) refuse("Marker is not compliant with its position");
    has_cod |= m == COD;
    has_qcd |= m == QCD;
    read_marker(dec, cs.def, m, segment(r), false);
    m = r.get(2);
  }
  if (!has_cod) refuse("required COD marker not found in main header");
  if (!has_qcd) refuse("required QCD marker not found in main header");
  merge_ppm(cs);
  cs.tcps.assign(nt, cs.def);
  for (Tcp& t : cs.tcps) t.cod = false;
  std::vector<int> cur_part(nt, -1);
  *n_decoded = 0;
  auto decode = [&](int t) {
    Tcp& tcp = cs.tcps[t];
    tcp.decoded = true;
    decode_tile(dec, t);
    order[(*n_decoded)++] = t;
    tcp.data.clear();
    tcp.data.shrink_to_fit();
  };
  // opj_read_tile_header / opj_decode_tile_data, one tile a call, from the
  // SOT the main header stopped at
  enum { TPHSOT = 4 };
  int state = TPHSOT, tile = 0;
  bool eoc = false, neoc = false, last_part = false;
  int64_t sot_length = 0;
  for (;;) {
    if (!eoc && state != TPHSOT) refuse("Stream does not end with EOC");
    bool can_decode = false;
    if (eoc) m = EOC;
    while (!can_decode && m != EOC) {
      while (m != SOD) {
        if (r.left() == 0) {
          neoc = true;
          break;
        }
        uint32_t size = r.get(2);
        if (size < 2) refuse("Inconsistent marker size");
        if (m == 0x8080 && r.left() == 0) {
          neoc = true;
          break;
        }
        if (state == TPH && sot_length != 0) {
          if (sot_length < size + 2) refuse("Sot length is less than marker size + marker ID");
          sot_length -= size + 2;
        }
        int st = marker_states(m);
        int allowed = m == SOT ? TPHSOT : st == -1 ? (MH | TPH) : st;
        if (!(allowed & state)) refuse("Marker is not compliant with its position");
        if (r.left() < size - 2) refuse("Stream too short");
        Reader seg(r.p + r.pos, size - 2);
        r.pos += size - 2;
        if (st == -1) refuse("Not sure how that happened.");
        if (m != SOT) {
          read_marker(dec, cs.tcps[tile], m, seg, true);
        } else {  // opj_j2k_read_sot
          if (seg.n != 8) refuse("Error reading SOT marker");
          tile = seg.get(2);
          uint32_t psot = seg.get(4);
          int tpsot = seg.get(1), tnsot = seg.get(1);
          if (tile >= nt) refuse("Invalid tile number %d", tile);
          Tcp& tcp = cs.tcps[tile];
          if (cur_part[tile] + 1 != tpsot)
            refuse("Invalid tile part index for tile number %d. Got %d, expected %d", tile,
                   tpsot, cur_part[tile] + 1);
          cur_part[tile]++;
          if (psot != 0 && psot < 14 && psot != 12)  // 12: an empty SOT, a warning
            refuse("Psot value is not correct regards to the JPEG2000 norm: %u.", psot);
          last_part = psot == 0;
          if (tnsot != 0) {
            if (tcp.nb_parts && tpsot >= tcp.nb_parts)
              refuse("In SOT marker, TPSot (%d) is not valid regards to the current number of tile-part (%d), giving up",
                     tpsot, tcp.nb_parts);
            if (tpsot >= tnsot)
              refuse("In SOT marker, TPSot (%d) is not valid regards to the current number of tile-part (header) (%d), giving up",
                     tpsot, tnsot);
            tcp.nb_parts = tnsot;
          }
          can_decode = tcp.nb_parts && tcp.nb_parts == tpsot + 1;
          sot_length = psot ? (int64_t)psot - 12 : 0;
          state = TPH;
        }
        if (r.left() < 2) refuse("Stream too short");
        m = r.get(2);
      }
      if (neoc) break;
      // opj_j2k_read_sod
      int64_t body;
      if (last_part) body = (int64_t)r.left() - 2;
      else body = sot_length >= 2 ? sot_length - 2 : sot_length;
      if (body != 0) {
        if (body < 0 || body > (int64_t)r.left())
          refuse("Tile part length size inconsistent with stream length");
        Tcp& tcp = cs.tcps[tile];
        if (tcp.decoded) refuse("tile %d has a tile-part after it was decoded", tile);
        tcp.data.insert(tcp.data.end(), d + r.pos, d + r.pos + body);
        tcp.seen = true;
        r.pos += body;
      }
      state = TPHSOT;
      if (!can_decode) {
        if (r.left() < 2) refuse("Stream too short");
        m = r.get(2);
      }
    }
    if (m == EOC && !eoc) {
      eoc = true;
      tile = 0;
    }
    if (!can_decode) {  // the next tile that holds data, from the current one
      while (tile < nt && !(cs.tcps[tile].seen && !cs.tcps[tile].decoded)) ++tile;
      if (tile == nt) return;
    }
    decode(tile);
    if (neoc) refuse("Stream does not end with EOC");  // the next call fails
    if (!eoc) {
      if (r.left() < 2) refuse("Stream too short");
      m = r.get(2);
      if (m == EOC) {
        eoc = true;
        tile = 0;
      } else if (m != SOT) {
        if (r.left()) refuse("Stream too short");
        state = -1;  // NEOC: "Stream does not end with EOC", then the next call fails
      }
    }
  }
}

}  // namespace

extern "C" {

// A codestream (from its SOC to the end of the file) -> each decoded tile's
// components as int32 samples at `out` (tile after tile in index order,
// each tile-component's full size), their decoded width and height at
// `dims` (tile, component), the tiles in the order decoded at `order`.
// Returns 0, 1 (a stream OpenJPEG or PIL refuses: ValueError) or 2 (a kind
// not ported: NotImplementedError), with the reason in msg.
int rsn_j2k_decode(const uint8_t* data, int64_t len, int32_t* out, int64_t out_len,
                   int32_t* dims, int32_t* order, int32_t n_tiles, int32_t* n_decoded,
                   char* msg, int msglen) {
  Decoder dec;
  dec.out = out;
  dec.out_len = out_len;
  dec.dims = dims;
  try {
    run(dec, data, (size_t)len, order, n_tiles, n_decoded);
  } catch (const Refused& e) {
    snprintf(msg, msglen, "%s", e.msg.c_str());
    return 1;
  } catch (const Unported& e) {
    snprintf(msg, msglen, "%s", e.msg.c_str());
    return 2;
  } catch (const std::bad_alloc&) {
    snprintf(msg, msglen, "out of memory");
    return 1;
  }
  return 0;
}

}  // extern "C"
