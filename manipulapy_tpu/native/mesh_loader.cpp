// Native mesh loader: binary/ASCII STL and Wavefront OBJ -> indexed
// triangle mesh (welded vertices, lexicographically sorted).
//
// This is the host-side systems component of the framework (SURVEY.md
// section 2 note: "where a host-side systems component is genuinely
// needed, C++"). Mesh IO is the one genuinely hot host loop left after
// the compute path moved onto the device: robot catalogs carry ~100s of MB
// of STL collision/visual geometry (reference ARCHITECTURE.md:118), and
// the pure-Python loader (reference geometry/mesh_loader.py:31-213,
// ours urdf/geometry.py) is allocation-bound on large files.
//
// Output contract matches the Python path exactly (urdf/geometry.py::
// _index_triangles): vertices are rounded to 9 decimals (round-half-even,
// numpy semantics), deduplicated, sorted lexicographically, and faces
// index into the sorted array. Tests assert bit-identical results.
//
// C ABI (ctypes-friendly):
//   int mpt_load_stl(path, &verts, &faces, &n_verts, &n_faces, err, errlen)
//   int mpt_load_obj(path, &verts, &faces, &n_verts, &n_faces, err, errlen)
//   void mpt_free(ptr)
// Return 0 on success; nonzero writes a NUL-terminated message to err.

#include <algorithm>
#include <array>
#include <cfenv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

using Vec3 = std::array<double, 3>;

// numpy round(decimals=9): scale, round-half-even, unscale.
// std::nearbyint honours the current rounding mode; the default
// (FE_TONEAREST) is round-half-to-even, matching numpy.
inline double round9(double x) { return std::nearbyint(x * 1e9) / 1e9; }

struct Vec3Hash {
  size_t operator()(const Vec3& v) const {
    // FNV-1a over the raw bits of the rounded coordinates.
    size_t h = 1469598103934665603ull;
    for (double d : v) {
      uint64_t bits;
      std::memcpy(&bits, &d, sizeof(bits));
      for (int i = 0; i < 8; ++i) {
        h ^= (bits >> (8 * i)) & 0xff;
        h *= 1099511628211ull;
      }
    }
    return h;
  }
};

struct MeshBuilder {
  std::vector<Vec3> verts;
  std::vector<std::array<int64_t, 3>> faces;
  std::unordered_map<Vec3, int64_t, Vec3Hash> index;

  int64_t weld(double x, double y, double z) {
    Vec3 key{round9(x), round9(y), round9(z)};
    auto it = index.find(key);
    if (it != index.end()) return it->second;
    int64_t id = static_cast<int64_t>(verts.size());
    verts.push_back(key);  // store the ROUNDED vertex, like the Python path
    index.emplace(key, id);
    return id;
  }

  void add_triangle(const double* a, const double* b, const double* c) {
    faces.push_back({weld(a[0], a[1], a[2]), weld(b[0], b[1], b[2]),
                     weld(c[0], c[1], c[2])});
  }

  // Sort vertices lexicographically (np.unique(axis=0) order) and remap
  // faces, then export malloc'd buffers the Python side copies and frees.
  int finish(double** out_verts, int32_t** out_faces, int64_t* n_verts,
             int64_t* n_faces) {
    const int64_t nv = static_cast<int64_t>(verts.size());
    const int64_t nf = static_cast<int64_t>(faces.size());
    std::vector<int64_t> order(nv);
    for (int64_t i = 0; i < nv; ++i) order[i] = i;
    std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
      return verts[a] < verts[b];  // std::array lexicographic compare
    });
    std::vector<int64_t> rank(nv);
    for (int64_t r = 0; r < nv; ++r) rank[order[r]] = r;

    double* v = static_cast<double*>(std::malloc(sizeof(double) * 3 * nv));
    int32_t* f = static_cast<int32_t*>(std::malloc(sizeof(int32_t) * 3 * nf));
    if ((nv && !v) || (nf && !f)) {
      std::free(v);
      std::free(f);
      return 1;
    }
    for (int64_t r = 0; r < nv; ++r) {
      const Vec3& src = verts[order[r]];
      v[3 * r + 0] = src[0];
      v[3 * r + 1] = src[1];
      v[3 * r + 2] = src[2];
    }
    for (int64_t i = 0; i < nf; ++i)
      for (int k = 0; k < 3; ++k)
        f[3 * i + k] = static_cast<int32_t>(rank[faces[i][k]]);
    *out_verts = v;
    *out_faces = f;
    *n_verts = nv;
    *n_faces = nf;
    return 0;
  }
};

int fail(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) std::snprintf(err, static_cast<size_t>(errlen), "%s", msg);
  return 1;
}

// -- STL ---------------------------------------------------------------------

int parse_binary_stl(const std::string& data, uint32_t count, MeshBuilder& mb) {
  // 50-byte records: 12B normal, 3x12B vertices, 2B attribute.
  const char* p = data.data() + 84;
  for (uint32_t t = 0; t < count; ++t, p += 50) {
    float raw[9];
    std::memcpy(raw, p + 12, sizeof(raw));
    double a[3] = {raw[0], raw[1], raw[2]};
    double b[3] = {raw[3], raw[4], raw[5]};
    double c[3] = {raw[6], raw[7], raw[8]};
    mb.add_triangle(a, b, c);
  }
  return 0;
}

int parse_ascii_stl(const std::string& text, MeshBuilder& mb, char* err,
                    int errlen) {
  std::vector<double> tri;
  tri.reserve(9);
  size_t pos = 0;
  const size_t n = text.size();
  while (pos < n) {
    size_t eol = text.find('\n', pos);
    if (eol == std::string::npos) eol = n;
    // Find "vertex" token at line start (after whitespace).
    size_t s = pos;
    while (s < eol && (text[s] == ' ' || text[s] == '\t' || text[s] == '\r')) ++s;
    if (eol - s > 7 && text.compare(s, 6, "vertex") == 0) {
      double v[3];
      if (std::sscanf(text.c_str() + s + 6, "%lf %lf %lf", &v[0], &v[1], &v[2]) == 3) {
        tri.push_back(v[0]);
        tri.push_back(v[1]);
        tri.push_back(v[2]);
        if (tri.size() == 9) {
          mb.add_triangle(&tri[0], &tri[3], &tri[6]);
          tri.clear();
        }
      }
    }
    pos = eol + 1;
  }
  if (!tri.empty() || mb.faces.empty())
    return fail(err, errlen, "Malformed ASCII STL: vertex count not a multiple of 3");
  return 0;
}

// -- OBJ ---------------------------------------------------------------------

int parse_obj(const std::string& text, MeshBuilder& mb, char* err, int errlen) {
  std::vector<Vec3> raw_verts;
  std::vector<std::array<int64_t, 3>> raw_faces;
  std::vector<int64_t> poly;
  size_t pos = 0;
  const size_t n = text.size();
  while (pos < n) {
    size_t eol = text.find('\n', pos);
    if (eol == std::string::npos) eol = n;
    size_t s = pos;
    while (s < eol && (text[s] == ' ' || text[s] == '\t' || text[s] == '\r')) ++s;
    if (s + 1 < eol && text[s] == 'v' && (text[s + 1] == ' ' || text[s + 1] == '\t')) {
      double v[3];
      if (std::sscanf(text.c_str() + s + 1, "%lf %lf %lf", &v[0], &v[1], &v[2]) == 3)
        raw_verts.push_back({v[0], v[1], v[2]});
    } else if (s + 1 < eol && text[s] == 'f' &&
               (text[s + 1] == ' ' || text[s + 1] == '\t')) {
      poly.clear();
      size_t q = s + 1;
      while (q < eol) {
        while (q < eol && (text[q] == ' ' || text[q] == '\t' || text[q] == '\r')) ++q;
        if (q >= eol) break;
        // token: [-]digits up to '/', space, or EOL ("v/vt/vn" keeps v only)
        long idx = std::strtol(text.c_str() + q, nullptr, 10);
        if (idx != 0) {
          int64_t i = idx > 0 ? idx - 1
                              : static_cast<int64_t>(raw_verts.size()) + idx;
          poly.push_back(i);
        }
        while (q < eol && text[q] != ' ' && text[q] != '\t' && text[q] != '\r') ++q;
      }
      for (size_t k = 1; k + 1 < poly.size(); ++k)  // fan triangulation
        raw_faces.push_back({poly[0], poly[k], poly[k + 1]});
    }
    pos = eol + 1;
  }
  if (raw_verts.empty() || raw_faces.empty())
    return fail(err, errlen, "OBJ file contains no triangles");
  for (const auto& f : raw_faces) {
    for (int k = 0; k < 3; ++k)
      if (f[k] < 0 || f[k] >= static_cast<int64_t>(raw_verts.size()))
        return fail(err, errlen, "OBJ face index out of range");
    // OBJ keeps the file's own vertex order/indexing (Python parity:
    // load_obj does NOT weld — only STL soup goes through _index_triangles),
    // so bypass the welding path below.
  }
  // Direct export preserving file order.
  mb.verts.assign(raw_verts.begin(), raw_verts.end());
  mb.faces = std::move(raw_faces);
  return 0;
}

int read_file(const char* path, std::string& out, char* err, int errlen) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return fail(err, errlen, "cannot open file");
  f.seekg(0, std::ios::end);
  std::streamoff size = f.tellg();
  f.seekg(0, std::ios::beg);
  out.resize(static_cast<size_t>(size));
  if (size > 0) f.read(&out[0], size);
  if (!f) return fail(err, errlen, "short read");
  return 0;
}

// OBJ export without the sort/weld of MeshBuilder::finish.
int export_raw(const MeshBuilder& mb, double** out_verts, int32_t** out_faces,
               int64_t* n_verts, int64_t* n_faces) {
  const int64_t nv = static_cast<int64_t>(mb.verts.size());
  const int64_t nf = static_cast<int64_t>(mb.faces.size());
  double* v = static_cast<double*>(std::malloc(sizeof(double) * 3 * nv));
  int32_t* f = static_cast<int32_t*>(std::malloc(sizeof(int32_t) * 3 * nf));
  if ((nv && !v) || (nf && !f)) {
    std::free(v);
    std::free(f);
    return 1;
  }
  for (int64_t i = 0; i < nv; ++i)
    for (int k = 0; k < 3; ++k) v[3 * i + k] = mb.verts[i][k];
  for (int64_t i = 0; i < nf; ++i)
    for (int k = 0; k < 3; ++k) f[3 * i + k] = static_cast<int32_t>(mb.faces[i][k]);
  *out_verts = v;
  *out_faces = f;
  *n_verts = nv;
  *n_faces = nf;
  return 0;
}

}  // namespace

extern "C" {

int mpt_load_stl(const char* path, double** out_verts, int32_t** out_faces,
                 int64_t* n_verts, int64_t* n_faces, char* err, int errlen) {
  std::string data;
  if (read_file(path, data, err, errlen)) return 1;
  MeshBuilder mb;
  // Binary detection: declared triangle count matches file size
  // (urdf/geometry.py::load_stl convention).
  bool parsed = false;
  if (data.size() >= 84) {
    uint32_t count;
    std::memcpy(&count, data.data() + 80, 4);
    if (84 + static_cast<uint64_t>(count) * 50 == data.size()) {
      if (parse_binary_stl(data, count, mb)) return fail(err, errlen, "binary STL parse error");
      parsed = true;
    }
  }
  if (!parsed && parse_ascii_stl(data, mb, err, errlen)) return 1;
  if (mb.finish(out_verts, out_faces, n_verts, n_faces))
    return fail(err, errlen, "out of memory");
  return 0;
}

int mpt_load_obj(const char* path, double** out_verts, int32_t** out_faces,
                 int64_t* n_verts, int64_t* n_faces, char* err, int errlen) {
  std::string data;
  if (read_file(path, data, err, errlen)) return 1;
  MeshBuilder mb;
  if (parse_obj(data, mb, err, errlen)) return 1;
  if (export_raw(mb, out_verts, out_faces, n_verts, n_faces))
    return fail(err, errlen, "out of memory");
  return 0;
}

void mpt_free(void* ptr) { std::free(ptr); }

}  // extern "C"
