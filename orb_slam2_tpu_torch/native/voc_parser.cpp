// Fast DBoW2 text-vocabulary parser.
//
// The reference loads ORBvoc.txt (~1.1M nodes, ~150 MB of text) with a
// std::stringstream-per-line loop (TemplatedVocabulary.h:1338-1420) that the
// authors annotate "could take a while" (System.cc:62); a pure-Python parse
// is slower still.  This native component mmaps the file and tokenizes with
// branch-light scalar code — the whole file parses in ~1 s.
//
// Exposed via a C ABI for ctypes (no pybind11 in this image):
//
//   voc_text_stats(path, &k, &L, &n_nodes)       -> 0 / negative errno-ish
//   voc_text_parse(path, parents, leaves, desc, weights, cap) -> n parsed
//
// Layout: node i (0-based over file order; the implicit root is NOT
// included) writes parents[i] (int32), leaves[i] (uint8), desc[i*32..+32)
// (uint8), weights[i] (float32).
//
// Built with g++ -O3 -shared -fPIC at first use into the package's _build/
// (orb_slam2_tpu_torch/native_build.py).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Mapped {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;
  bool ok() const { return data != nullptr; }
};

Mapped map_file(const char* path) {
  Mapped m;
  m.fd = open(path, O_RDONLY);
  if (m.fd < 0) return m;
  struct stat st;
  if (fstat(m.fd, &st) != 0 || st.st_size == 0) {
    close(m.fd);
    m.fd = -1;
    return m;
  }
  void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, m.fd, 0);
  if (p == MAP_FAILED) {
    close(m.fd);
    m.fd = -1;
    return m;
  }
  m.data = static_cast<const char*>(p);
  m.size = st.st_size;
  return m;
}

void unmap(Mapped& m) {
  if (m.data) munmap(const_cast<char*>(m.data), m.size);
  if (m.fd >= 0) close(m.fd);
}

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* parse_long(const char* p, const char* end, long* out) {
  p = skip_ws(p, end);
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) neg = (*p++ == '-');
  long v = 0;
  while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
  *out = neg ? -v : v;
  return p;
}

// plain-decimal float parse (the format writes fixed-notation weights;
// falls back to strtof for exponents)
inline const char* parse_float(const char* p, const char* end, float* out) {
  p = skip_ws(p, end);
  const char* start = p;
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) neg = (*p++ == '-');
  double v = 0;
  while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
  if (p < end && *p == '.') {
    ++p;
    double f = 0.1;
    while (p < end && *p >= '0' && *p <= '9') {
      v += (*p++ - '0') * f;
      f *= 0.1;
    }
  }
  if (p < end && (*p == 'e' || *p == 'E')) {
    // strtof needs a NUL-terminated buffer; the mmap'd region is not —
    // copy the token (bounded by `end`) into a stack buffer first, or a
    // final-token read could run past the mapping (ADVICE r4).
    const char* q = p + 1;
    if (q < end && (*q == '-' || *q == '+')) ++q;
    while (q < end && *q >= '0' && *q <= '9') ++q;
    char buf[64];
    size_t n = static_cast<size_t>(q - start);
    if (n >= sizeof(buf)) n = sizeof(buf) - 1;
    memcpy(buf, start, n);
    buf[n] = '\0';
    char* bq;
    *out = strtof(buf, &bq);
    return start + (bq - buf);
  }
  *out = static_cast<float>(neg ? -v : v);
  return p;
}

}  // namespace

extern "C" {

// Reads the header (k, L) and counts node lines.  Returns 0 on success.
int voc_text_stats(const char* path, long* k, long* L, long* n_nodes) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  const char* p = m.data;
  const char* end = m.data + m.size;
  p = parse_long(p, end, k);
  p = parse_long(p, end, L);
  long sc, wt;
  p = parse_long(p, end, &sc);
  p = parse_long(p, end, &wt);
  while (p < end && *p != '\n') ++p;
  long n = 0;
  for (const char* q = p; q < end; ++q)
    if (*q == '\n' && q + 1 < end && *(q + 1) != '\n') ++n;
  // count a final unterminated line
  if (m.size && end[-1] != '\n' && p < end) ++n;
  *n_nodes = n;
  unmap(m);
  return 0;
}

// Parses up to `cap` node lines into the caller's arrays; returns the
// number parsed (negative on IO error).
long voc_text_parse(const char* path, int32_t* parents, uint8_t* leaves,
                    uint8_t* desc, float* weights, long cap) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  const char* p = m.data;
  const char* end = m.data + m.size;
  while (p < end && *p != '\n') ++p;  // skip header line
  if (p < end) ++p;
  long i = 0;
  while (p < end && i < cap) {
    p = skip_ws(p, end);
    if (p >= end) break;
    if (*p == '\n') {
      ++p;
      continue;
    }
    long parent, leaf;
    p = parse_long(p, end, &parent);
    p = parse_long(p, end, &leaf);
    parents[i] = static_cast<int32_t>(parent);
    leaves[i] = static_cast<uint8_t>(leaf);
    uint8_t* d = desc + i * 32;
    for (int b = 0; b < 32; ++b) {
      long v;
      p = parse_long(p, end, &v);
      d[b] = static_cast<uint8_t>(v);
    }
    p = parse_float(p, end, &weights[i]);
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
    ++i;
  }
  unmap(m);
  return i;
}

}  // extern "C"
