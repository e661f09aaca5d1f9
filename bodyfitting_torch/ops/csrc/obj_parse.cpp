// Wavefront OBJ parsing (host C++): one pass over the file, v / vt / vn /
// f lines with the v, v/vt, v//vn and v/vt/vn corner forms, 1-based and
// negative indices, polygons triangulated as a fan, and the first mtllib
// name.  A RenderPeople scan is about a million lines; Python's line loop
// takes seconds for it, this parser a fraction of one.
//
// The port's own copy of the JAX package's native parser
// (native/bodyfit_native.cpp, parse_obj and its free helpers), built at
// first use by bodyfitting_torch/ops/kernels/_build.py with the system C++
// compiler; io/obj.py calls it through ctypes.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Buf {
  const char* p;
  const char* end;
};

inline void skip_ws(Buf& b) {
  // every whitespace EXCEPT newline: parsing must never cross a line
  while (b.p < b.end && (*b.p == ' ' || *b.p == '\t' || *b.p == '\r' ||
                         *b.p == '\v' || *b.p == '\f'))
    ++b.p;
}

inline bool at_number(const Buf& b) {
  return b.p < b.end &&
         (*b.p == '-' || *b.p == '+' || *b.p == '.' ||
          (*b.p >= '0' && *b.p <= '9'));
}

inline void skip_line(Buf& b) {
  while (b.p < b.end && *b.p != '\n') ++b.p;
  if (b.p < b.end) ++b.p;
}

inline bool parse_float(Buf& b, float* out) {
  skip_ws(b);
  // strtof skips whitespace INCLUDING newlines: a short line would steal
  // the next line's number and corrupt the mesh — stop at end-of-line
  if (!at_number(b)) return false;
  char* endp = nullptr;
  float v = strtof(b.p, &endp);
  if (endp == b.p) return false;
  b.p = endp;
  *out = v;
  return true;
}

inline bool parse_int(Buf& b, long* out) {
  skip_ws(b);
  if (!at_number(b)) return false;
  char* endp = nullptr;
  long v = strtol(b.p, &endp, 10);
  if (endp == b.p) return false;
  b.p = endp;
  *out = v;
  return true;
}

// one face corner: v[/vt][/vn] (any may be absent after the first)
struct Corner {
  long v = 0, vt = 0, vn = 0;
  bool has_vt = false, has_vn = false;
};

inline bool parse_corner(Buf& b, Corner* c) {
  if (!parse_int(b, &c->v)) return false;
  if (b.p < b.end && *b.p == '/') {
    ++b.p;
    // digit check BEFORE strtol: a trailing-slash corner ("f 1/ 2/ 3/")
    // must not let strtol skip whitespace and steal the next corner's
    // vertex index as this corner's vt
    if (at_number(b)) {
      char* endp = nullptr;
      long t = strtol(b.p, &endp, 10);
      if (endp != b.p) {
        c->vt = t;
        c->has_vt = true;
        b.p = endp;
      }
    }
    if (b.p < b.end && *b.p == '/') {
      ++b.p;
      if (at_number(b)) {
        char* endp = nullptr;
        long n = strtol(b.p, &endp, 10);
        if (endp != b.p) {
          c->vn = n;
          c->has_vn = true;
          b.p = endp;
        }
      }
    }
  }
  return true;
}

inline long resolve(long idx, size_t count) {
  return idx > 0 ? idx - 1 : static_cast<long>(count) + idx;
}

}  // namespace

extern "C" {

// Parse an OBJ file.  Returns 0 on success.  All out-buffers are malloc'd
// here and must be released with free_f32/free_i32.
//   verts      [n_verts * 3] float
//   uvs        [n_uvs * 2] float
//   normals    [n_normals * 3] float
//   faces      [n_faces * 3] int32 (vertex indices, triangulated)
//   face_uvs   [n_faces * 3] int32 (or -1 when absent)
//   face_norms [n_faces * 3] int32 (or -1 when absent)
//   mtllib     [256] char (first mtllib name, empty if none)
int parse_obj(const char* path, float** verts, int64_t* n_verts, float** uvs,
              int64_t* n_uvs, float** normals, int64_t* n_normals,
              int32_t** faces, int32_t** face_uvs, int32_t** face_norms,
              int64_t* n_faces, char* mtllib) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> data(static_cast<size_t>(size) + 1);
  if (size > 0 && fread(data.data(), 1, static_cast<size_t>(size), f) !=
                      static_cast<size_t>(size)) {
    fclose(f);
    return 2;
  }
  fclose(f);
  data[static_cast<size_t>(size)] = '\0';

  std::vector<float> v, vt, vn;
  std::vector<int32_t> fv, ft, fn;
  std::vector<Corner> corners;
  if (mtllib) mtllib[0] = '\0';

  Buf b{data.data(), data.data() + size};
  while (b.p < b.end) {
    skip_ws(b);
    if (b.p >= b.end) break;
    char c0 = *b.p;
    if (c0 == 'v' && b.p + 1 < b.end) {
      char c1 = b.p[1];
      if (c1 == ' ' || c1 == '\t') {
        b.p += 1;
        float x = 0, y = 0, z = 0;
        parse_float(b, &x);
        parse_float(b, &y);
        parse_float(b, &z);
        v.push_back(x);
        v.push_back(y);
        v.push_back(z);
      } else if (c1 == 't') {
        b.p += 2;
        float u = 0, w = 0;
        parse_float(b, &u);
        parse_float(b, &w);
        vt.push_back(u);
        vt.push_back(w);
      } else if (c1 == 'n') {
        b.p += 2;
        float x = 0, y = 0, z = 0;
        parse_float(b, &x);
        parse_float(b, &y);
        parse_float(b, &z);
        vn.push_back(x);
        vn.push_back(y);
        vn.push_back(z);
      }
      skip_line(b);
    } else if (c0 == 'f' && b.p + 1 < b.end &&
               (b.p[1] == ' ' || b.p[1] == '\t')) {
      b.p += 1;
      corners.clear();
      Corner c;
      while (true) {
        skip_ws(b);
        if (b.p >= b.end || *b.p == '\n' || *b.p == '#') break;
        Corner cc;
        if (!parse_corner(b, &cc)) break;
        corners.push_back(cc);
      }
      // fan triangulation
      for (size_t k = 1; k + 1 < corners.size(); ++k) {
        const Corner tri[3] = {corners[0], corners[k], corners[k + 1]};
        bool all_vt = true, all_vn = true;
        for (const Corner& t : tri) {
          all_vt &= t.has_vt;
          all_vn &= t.has_vn;
        }
        for (const Corner& t : tri) {
          fv.push_back(
              static_cast<int32_t>(resolve(t.v, v.size() / 3)));
          ft.push_back(all_vt ? static_cast<int32_t>(
                                    resolve(t.vt, vt.size() / 2))
                              : -1);
          fn.push_back(all_vn ? static_cast<int32_t>(
                                    resolve(t.vn, vn.size() / 3))
                              : -1);
        }
      }
      skip_line(b);
    } else if (c0 == 'm' && mtllib &&
               strncmp(b.p, "mtllib", 6) == 0) {
      b.p += 6;
      skip_ws(b);
      int i = 0;
      while (b.p < b.end && !isspace(static_cast<unsigned char>(*b.p)) &&
             i < 255) {
        mtllib[i++] = *b.p++;
      }
      mtllib[i] = '\0';
      skip_line(b);
    } else {
      skip_line(b);
    }
  }

  auto copy_f = [](const std::vector<float>& src) {
    float* out = static_cast<float*>(malloc(src.size() * sizeof(float)));
    memcpy(out, src.data(), src.size() * sizeof(float));
    return out;
  };
  auto copy_i = [](const std::vector<int32_t>& src) {
    int32_t* out =
        static_cast<int32_t*>(malloc(src.size() * sizeof(int32_t)));
    memcpy(out, src.data(), src.size() * sizeof(int32_t));
    return out;
  };

  *verts = copy_f(v);
  *n_verts = static_cast<int64_t>(v.size() / 3);
  *uvs = copy_f(vt);
  *n_uvs = static_cast<int64_t>(vt.size() / 2);
  *normals = copy_f(vn);
  *n_normals = static_cast<int64_t>(vn.size() / 3);
  *faces = copy_i(fv);
  *face_uvs = copy_i(ft);
  *face_norms = copy_i(fn);
  *n_faces = static_cast<int64_t>(fv.size() / 3);
  return 0;
}

void free_f32(float* p) { free(p); }
void free_i32(int32_t* p) { free(p); }

}  // extern "C"
