// Fast parser for Wireless InSite .paths.p2m files.
//
// The converter's hot CPU loop: large projects carry one paths file per
// TX-RX pair with up to ~10^5 receivers x 25 paths each. This native parser
// streams the file once with manual number scanning (no regex, no Python
// per-line overhead) and fills caller-allocated NaN-initialized matrices.
//
// C ABI (used via ctypes from deepmimo_tpu_torch/native/__init__.py):
//   p2m_count_rxs(path)                 -> receiver count or -1
//   p2m_parse_paths(path, ...buffers)   -> 0 on success, negative on error
//
// File layout parsed here matches deepmimo_tpu_torch/converter/insite/p2m.py
// (the pure-Python reference implementation).

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <string>
#include <vector>

namespace {

constexpr int kHeaderLines = 21;

struct Scanner {
  const char* p;
  const char* end;

  explicit Scanner(const std::string& buf)
      : p(buf.data()), end(buf.data() + buf.size()) {}

  bool next_line(const char** line_start, const char** line_end) {
    if (p >= end) return false;
    *line_start = p;
    const char* nl = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    if (nl == nullptr) {
      *line_end = end;
      p = end;
    } else {
      *line_end = nl;
      p = nl + 1;
    }
    return true;
  }

  void skip_lines(int n) {
    const char *a, *b;
    for (int i = 0; i < n && next_line(&a, &b); ++i) {
    }
  }
};

bool read_file(const char* path, std::string* out) {
  FILE* f = fopen(path, "rb");
  if (f == nullptr) return false;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  out->resize(static_cast<size_t>(size));
  size_t got = fread(out->data(), 1, static_cast<size_t>(size), f);
  fclose(f);
  return got == static_cast<size_t>(size);
}

// Parse whitespace-separated doubles from a line; returns count parsed.
int parse_doubles(const char* s, const char* e, double* out, int max_n) {
  int n = 0;
  while (s < e && n < max_n) {
    while (s < e && (*s == ' ' || *s == '\t' || *s == '\r')) ++s;
    if (s >= e) break;
    char* next = nullptr;
    double v = strtod(s, &next);
    if (next == s) break;
    out[n++] = v;
    s = next;
  }
  return n;
}

// Map interaction letters between "Tx-" and "-Rx" to digit codes.
// R->1, D->2, DS->3, T/F/X->4 (concatenated decimal digits).
double interactions_code(const char* s, const char* e) {
  double code = 0.0;
  bool any = false;
  const char* tok = s;
  while (tok < e) {
    const char* dash = static_cast<const char*>(
        memchr(tok, '-', static_cast<size_t>(e - tok)));
    const char* tok_end = dash == nullptr ? e : dash;
    size_t len = static_cast<size_t>(tok_end - tok);
    // strip trailing \r / spaces
    while (len > 0 && (tok[len - 1] == '\r' || tok[len - 1] == ' ')) --len;
    int digit = -1;
    if (len == 1) {
      switch (tok[0]) {
        case 'R': digit = 1; break;
        case 'D': digit = 2; break;
        case 'T': case 'F': case 'X': digit = 4; break;
        default: break;  // Tx / Rx endpoints and unknowns skipped
      }
    } else if (len == 2 && tok[0] == 'D' && tok[1] == 'S') {
      digit = 3;
    }
    if (digit >= 0) {
      code = code * 10.0 + digit;
      any = true;
    }
    if (dash == nullptr) break;
    tok = dash + 1;
  }
  return any ? code : 0.0;
}

}  // namespace

extern "C" {

int p2m_count_rxs(const char* path) {
  std::string buf;
  if (!read_file(path, &buf)) return -1;
  Scanner sc(buf);
  sc.skip_lines(kHeaderLines);
  const char *a, *b;
  if (!sc.next_line(&a, &b)) return -2;
  return atoi(std::string(a, b).c_str());
}

// All float buffers must be pre-filled with NaN by the caller and sized:
//   per-path matrices: n_rxs * max_paths
//   inter_pos:         n_rxs * max_paths * max_inter * 3
int p2m_parse_paths(const char* path, int n_rxs, int max_paths, int max_inter,
                    float* power, float* phase, float* delay,
                    float* aoa_el, float* aoa_az,
                    float* aod_el, float* aod_az,
                    float* inter, float* inter_pos) {
  std::string buf;
  if (!read_file(path, &buf)) return -1;
  Scanner sc(buf);
  sc.skip_lines(kHeaderLines + 1);  // header + rx-count line

  const char *a, *b;
  double vals[16];

  for (int rx = 0; rx < n_rxs; ++rx) {
    if (!sc.next_line(&a, &b)) return -2;
    if (parse_doubles(a, b, vals, 2) < 2) return -3;
    int n_paths = static_cast<int>(vals[1]);
    if (n_paths == 0) continue;
    sc.skip_lines(1);  // per-rx summary line

    for (int p = 0; p < n_paths; ++p) {
      if (!sc.next_line(&a, &b)) return -4;       // data line
      // fields: path#, n_inter, power, phase, toa, aoa_el, aoa_az,
      //         aod_el, aod_az
      if (parse_doubles(a, b, vals, 9) < 9) return -5;
      int n_inter = static_cast<int>(vals[1]);
      bool keep = p < max_paths;
      size_t idx = static_cast<size_t>(rx) * max_paths + p;
      if (keep) {
        power[idx] = static_cast<float>(vals[2]);
        phase[idx] = static_cast<float>(vals[3]);
        delay[idx] = static_cast<float>(vals[4]);
        aoa_el[idx] = static_cast<float>(vals[5]);
        aoa_az[idx] = static_cast<float>(vals[6]);
        aod_el[idx] = static_cast<float>(vals[7]);
        aod_az[idx] = static_cast<float>(vals[8]);
      }

      if (!sc.next_line(&a, &b)) return -6;       // type line Tx-R-D-Rx
      if (keep) inter[idx] = static_cast<float>(interactions_code(a, b));

      sc.skip_lines(1);                           // TX position line
      for (int bnc = 0; bnc < n_inter; ++bnc) {   // interaction positions
        if (!sc.next_line(&a, &b)) return -7;
        if (keep && bnc < max_inter) {
          double xyz[3];
          if (parse_doubles(a, b, xyz, 3) < 3) return -8;
          size_t base = ((static_cast<size_t>(rx) * max_paths + p) *
                         max_inter + bnc) * 3;
          inter_pos[base + 0] = static_cast<float>(xyz[0]);
          inter_pos[base + 1] = static_cast<float>(xyz[1]);
          inter_pos[base + 2] = static_cast<float>(xyz[2]);
        }
      }
      sc.skip_lines(1);                           // RX position line
    }
  }
  return 0;
}

}  // extern "C"
