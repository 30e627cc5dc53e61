// nemo_native.cpp — native ingestion/ETL engine: Molly JSON -> packed batches.
//
// The reference's ingestion is compiled-native Go (faultinjectors/molly.go:15-163,
// faultinjectors/data-types.go:6-98); this is its TPU-era equivalent: one C++
// pass that parses runs.json plus every run's pre/post provenance JSON, applies
// the ingestion invariants —
//   * clock-goal time extraction via the two patterns
//     ", (\d+), __WILDCARD__)" and ", (\d+), (\d+))" with two-number-wins
//     (molly.go:76-89, :124-137);
//   * run namespacing run_<iter>_{pre,post}_<origID> (molly.go:92-107);
//   * success partition on the exact status string "success" (molly.go:53);
// — interns table/label/time strings into a corpus-wide vocabulary (the
// device-side analog of Cypher string matching, SURVEY.md §7 hard part 4), and
// emits padded [B,V]/[B,E] int32/bool batches in the exact layout of
// nemo_tpu.graphs.packed.pack_batch, ready for jax.device_put.
//
// Exposed as a C ABI consumed via ctypes (nemo_tpu/ingest/native.py); no
// external dependencies (self-contained minimal JSON parser below).

#include <sched.h>

#include <algorithm>
#include <atomic>
#include <charconv>
#include <chrono>
#include <clocale>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <memory>
#include <sstream>
#include <stdexcept>
#include <string>
#include <system_error>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Minimal JSON DOM parser (objects, arrays, strings with escapes, numbers,
// bools, null).  Numbers keep their raw token so integer times round-trip as
// the same string the Python path produces via str(int).
// ---------------------------------------------------------------------------

struct JVal {
  enum Type { NUL, BOOL, NUM, STR, ARR, OBJ } type = NUL;
  bool b = false;
  std::string s;  // STR: decoded string; NUM: raw token
  std::vector<JVal> arr;
  std::vector<std::pair<std::string, JVal>> obj;

  const JVal* get(const std::string& key) const {
    for (const auto& kv : obj)
      if (kv.first == key) return &kv.second;
    return nullptr;
  }
  std::string get_str(const std::string& key, const std::string& dflt = "") const {
    const JVal* v = get(key);
    if (!v) return dflt;
    if (v->type == STR) return v->s;
    if (v->type == NUM) return v->s;  // str(number): raw token
    return dflt;
  }
  long get_int(const std::string& key, long dflt = 0) const {
    const JVal* v = get(key);
    if (!v || v->type != NUM) return dflt;
    return std::strtol(v->s.c_str(), nullptr, 10);
  }
};

class JsonParser {
 public:
  explicit JsonParser(const std::string& text) : t_(text) {}

  JVal parse() {
    JVal v = value();
    ws();
    if (p_ != t_.size()) fail("trailing content");
    return v;
  }

 private:
  const std::string& t_;
  size_t p_ = 0;
  int depth_ = 0;
  // Recursion guard: the parser is recursive-descent, so adversarial
  // nesting ("[[[[..." at megabyte scale) would otherwise overflow the C
  // stack — a crash, not a clean RuntimeError, on the trust boundary.
  // 256 is ~10x deeper than any real Molly output.  DELIBERATE one-sided
  // strictness vs the Python loader (like the int32 iteration bound):
  // json.loads accepts up to ~sys.getrecursionlimit() (~1000, and
  // caller-stack-dependent), so depths 257..~1000 are a loud native
  // reject where Python happens to accept — pinned by
  // tests/test_native_malformed.py:test_depth_limit_divergence_is_loud.
  static constexpr int kMaxDepth = 256;

  struct DepthGuard {
    JsonParser* p;
    explicit DepthGuard(JsonParser* parser) : p(parser) {
      if (++p->depth_ > kMaxDepth) p->fail("nesting too deep");
    }
    ~DepthGuard() { --p->depth_; }
  };

  [[noreturn]] void fail(const char* msg) {
    throw std::runtime_error("JSON parse error at byte " + std::to_string(p_) + ": " + msg);
  }
  void ws() {
    while (p_ < t_.size() &&
           (t_[p_] == ' ' || t_[p_] == '\t' || t_[p_] == '\n' || t_[p_] == '\r'))
      ++p_;
  }
  char peek() {
    if (p_ >= t_.size()) fail("unexpected end");
    return t_[p_];
  }
  void expect(char c) {
    if (p_ >= t_.size() || t_[p_] != c) fail("unexpected character");
    ++p_;
  }

  JVal value() {
    ws();
    switch (peek()) {
      case '{': return object();
      case '[': return array();
      case '"': {
        JVal v;
        v.type = JVal::STR;
        v.s = string();
        return v;
      }
      case 't': literal("true"); { JVal v; v.type = JVal::BOOL; v.b = true; return v; }
      case 'f': literal("false"); { JVal v; v.type = JVal::BOOL; v.b = false; return v; }
      case 'n': literal("null"); return JVal{};
      default: return number();
    }
  }

  void literal(const char* lit) {
    size_t n = std::strlen(lit);
    if (t_.compare(p_, n, lit) != 0) fail("bad literal");
    p_ += n;
  }

  JVal number() {
    // Strict JSON grammar -?(0|[1-9]\d*)(\.\d+)?([eE][+-]?\d+)?, matching
    // json.loads: the earlier lenient scan accepted "3-", "1.2.3", "01" —
    // inputs the Python loader rejects (trust-boundary parity).
    size_t start = p_;
    if (peek() == '-') ++p_;
    if (p_ >= t_.size() || !std::isdigit((unsigned char)t_[p_])) fail("bad number");
    if (t_[p_] == '0') {
      ++p_;
    } else {
      while (p_ < t_.size() && std::isdigit((unsigned char)t_[p_])) ++p_;
    }
    if (p_ < t_.size() && t_[p_] == '.') {
      ++p_;
      if (p_ >= t_.size() || !std::isdigit((unsigned char)t_[p_])) fail("bad number");
      while (p_ < t_.size() && std::isdigit((unsigned char)t_[p_])) ++p_;
    }
    if (p_ < t_.size() && (t_[p_] == 'e' || t_[p_] == 'E')) {
      ++p_;
      if (p_ < t_.size() && (t_[p_] == '+' || t_[p_] == '-')) ++p_;
      if (p_ >= t_.size() || !std::isdigit((unsigned char)t_[p_])) fail("bad number");
      while (p_ < t_.size() && std::isdigit((unsigned char)t_[p_])) ++p_;
    }
    JVal v;
    v.type = JVal::NUM;
    v.s = t_.substr(start, p_ - start);
    return v;
  }

  std::string string() {
    expect('"');
    std::string out;
    while (true) {
      if (p_ >= t_.size()) fail("unterminated string");
      char c = t_[p_++];
      if (c == '"') break;
      if ((unsigned char)c < 0x20) fail("control character in string");
      if (c == '\\') {
        if (p_ >= t_.size()) fail("bad escape");
        char e = t_[p_++];
        switch (e) {
          case '"': out += '"'; break;
          case '\\': out += '\\'; break;
          case '/': out += '/'; break;
          case 'b': out += '\b'; break;
          case 'f': out += '\f'; break;
          case 'n': out += '\n'; break;
          case 'r': out += '\r'; break;
          case 't': out += '\t'; break;
          case 'u': {
            if (p_ + 4 > t_.size()) fail("bad \\u escape");
            for (size_t h = 0; h < 4; ++h)
              if (!std::isxdigit((unsigned char)t_[p_ + h])) fail("bad \\u escape");
            unsigned cp = (unsigned)std::strtoul(t_.substr(p_, 4).c_str(), nullptr, 16);
            p_ += 4;
            // Surrogate pair.
            if (cp >= 0xD800 && cp <= 0xDBFF && p_ + 6 <= t_.size() && t_[p_] == '\\' &&
                t_[p_ + 1] == 'u') {
              unsigned lo = (unsigned)std::strtoul(t_.substr(p_ + 2, 4).c_str(), nullptr, 16);
              if (lo >= 0xDC00 && lo <= 0xDFFF) {
                cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
                p_ += 6;
              }
            }
            // UTF-8 encode.
            if (cp < 0x80) {
              out += (char)cp;
            } else if (cp < 0x800) {
              out += (char)(0xC0 | (cp >> 6));
              out += (char)(0x80 | (cp & 0x3F));
            } else if (cp < 0x10000) {
              out += (char)(0xE0 | (cp >> 12));
              out += (char)(0x80 | ((cp >> 6) & 0x3F));
              out += (char)(0x80 | (cp & 0x3F));
            } else {
              out += (char)(0xF0 | (cp >> 18));
              out += (char)(0x80 | ((cp >> 12) & 0x3F));
              out += (char)(0x80 | ((cp >> 6) & 0x3F));
              out += (char)(0x80 | (cp & 0x3F));
            }
            break;
          }
          default: fail("bad escape");
        }
      } else {
        out += c;
      }
    }
    return out;
  }

  static constexpr size_t kObjIndexThreshold = 16;

  JVal object() {
    DepthGuard guard(this);
    expect('{');
    JVal v;
    v.type = JVal::OBJ;
    std::unordered_map<std::string, size_t> key_index;
    ws();
    if (peek() == '}') { ++p_; return v; }
    while (true) {
      ws();
      std::string key = string();
      ws();
      expect(':');
      JVal val = value();
      // Duplicate keys are last-wins, matching Python json.loads (the
      // parity reference for both the prov and head serializers); the
      // key keeps its first position like dict insertion order does.
      // Small objects take the linear scan; wide ones (model "tables"
      // at stress scale) switch to a key->index map so each insert
      // stays O(1) instead of O(k) (ADVICE r4 #4).
      bool replaced = false;
      if (v.obj.size() < kObjIndexThreshold) {
        for (auto& kv : v.obj)
          if (kv.first == key) { kv.second = std::move(val); replaced = true; break; }
      } else {
        if (key_index.empty())  // built lazily on first wide lookup
          for (size_t i = 0; i < v.obj.size(); ++i)
            key_index.emplace(v.obj[i].first, i);
        auto it = key_index.find(key);
        if (it != key_index.end()) {
          v.obj[it->second].second = std::move(val);
          replaced = true;
        }
      }
      if (!replaced) {
        if (!key_index.empty()) key_index.emplace(key, v.obj.size());
        v.obj.emplace_back(std::move(key), std::move(val));
      }
      ws();
      if (peek() == ',') { ++p_; continue; }
      expect('}');
      break;
    }
    return v;
  }

  JVal array() {
    DepthGuard guard(this);
    expect('[');
    JVal v;
    v.type = JVal::ARR;
    ws();
    if (peek() == ']') { ++p_; return v; }
    while (true) {
      v.arr.push_back(value());
      ws();
      if (peek() == ',') { ++p_; continue; }
      expect(']');
      break;
    }
    return v;
  }
};

// ---------------------------------------------------------------------------
// Clock-time extraction (molly.go:76-89): leftmost match of each pattern;
// the two-number pattern, applied second, wins when both match.
// ---------------------------------------------------------------------------

bool scan_digits(const std::string& s, size_t& p, std::string& out) {
  size_t start = p;
  while (p < s.size() && std::isdigit((unsigned char)s[p])) ++p;
  if (p == start) return false;
  out = s.substr(start, p - start);
  return true;
}

// ", (\d+), __WILDCARD__\)"
bool match_clock_wild(const std::string& s, std::string& time_out) {
  for (size_t i = 0; i + 1 < s.size(); ++i) {
    if (s[i] != ',' || s[i + 1] != ' ') continue;
    size_t p = i + 2;
    std::string digits;
    if (!scan_digits(s, p, digits)) continue;
    static const char* kTail = ", __WILDCARD__)";
    if (s.compare(p, std::strlen(kTail), kTail) == 0) {
      time_out = digits;
      return true;
    }
  }
  return false;
}

// ", (\d+), (\d+)\)" — first capture group.
bool match_clock_two(const std::string& s, std::string& time_out) {
  for (size_t i = 0; i + 1 < s.size(); ++i) {
    if (s[i] != ',' || s[i + 1] != ' ') continue;
    size_t p = i + 2;
    std::string d1, d2;
    if (!scan_digits(s, p, d1)) continue;
    if (p + 1 < s.size() && s[p] == ',' && s[p + 1] == ' ') {
      size_t q = p + 2;
      if (scan_digits(s, q, d2) && q < s.size() && s[q] == ')') {
        time_out = d1;
        return true;
      }
    }
  }
  return false;
}

// ---------------------------------------------------------------------------
// Corpus model
// ---------------------------------------------------------------------------

struct Vocab {
  std::vector<std::string> strings;
  std::unordered_map<std::string, int32_t> ids;
  int32_t intern(const std::string& s) {
    auto it = ids.find(s);
    if (it != ids.end()) return it->second;
    int32_t id = (int32_t)strings.size();
    strings.push_back(s);
    ids.emplace(s, id);
    return id;
  }
  int32_t lookup(const std::string& s) const {
    auto it = ids.find(s);
    return it == ids.end() ? -1 : it->second;
  }
};

// ---------------------------------------------------------------------------
// Namespaced prov JSON serialization (debugging.json embedding).
//
// Byte-for-byte what the Python path produces via
// json.dumps(ProvData.to_json()) with default separators (", " / ": ") and
// ensure_ascii=True, after ingest/molly.py's transforms (namespacing + clock
// time fix): the report writer splices these strings into debugging.json
// without ever parsing provenance in Python (VERDICT r3 task 1).
// ---------------------------------------------------------------------------

// Python json.dumps ensure_ascii escaping for a decoded UTF-8 string.
void append_escaped(std::string& out, const std::string& s) {
  out += '"';
  size_t i = 0, n = s.size();
  while (i < n) {
    unsigned char c = (unsigned char)s[i];
    if (c == '"') { out += "\\\""; ++i; }
    else if (c == '\\') { out += "\\\\"; ++i; }
    else if (c == '\b') { out += "\\b"; ++i; }
    else if (c == '\f') { out += "\\f"; ++i; }
    else if (c == '\n') { out += "\\n"; ++i; }
    else if (c == '\r') { out += "\\r"; ++i; }
    else if (c == '\t') { out += "\\t"; ++i; }
    else if (c < 0x20) {
      char buf[8];
      std::snprintf(buf, sizeof buf, "\\u%04x", (unsigned)c);
      out += buf;
      ++i;
    } else if (c < 0x80) {
      out += (char)c;
      ++i;
    } else {
      // Decode one UTF-8 sequence -> codepoint -> \uXXXX (surrogate pair
      // beyond the BMP), matching ensure_ascii=True.
      unsigned cp = 0;
      int len = 1;
      if ((c & 0xE0) == 0xC0) { cp = c & 0x1F; len = 2; }
      else if ((c & 0xF0) == 0xE0) { cp = c & 0x0F; len = 3; }
      else if ((c & 0xF8) == 0xF0) { cp = c & 0x07; len = 4; }
      else { cp = 0xFFFD; len = 1; }
      if (len > 1) {
        if (i + (size_t)len > n) { cp = 0xFFFD; len = 1; }
        else {
          for (int k = 1; k < len; ++k) cp = (cp << 6) | ((unsigned char)s[i + k] & 0x3F);
        }
      }
      char buf[16];
      if (cp < 0x10000) {
        std::snprintf(buf, sizeof buf, "\\u%04x", cp);
        out += buf;
      } else {
        cp -= 0x10000;
        std::snprintf(buf, sizeof buf, "\\u%04x\\u%04x", 0xD800 + (cp >> 10),
                      0xDC00 + (cp & 0x3FF));
        out += buf;
      }
      i += (size_t)len;
    }
  }
  out += '"';
}

// Append `"key": <value>` mirroring Python `d.get(key, "")` then json.dumps:
// absent -> "", string -> escaped, number -> raw token, null -> null,
// bool -> true/false (dataclass field passthrough).
//
// Numeric caveat: the raw token is spliced verbatim, while Python's path
// round-trips through float() for non-integer tokens (json.load -> dumps
// canonicalizes "1e2" to 100.0, "1.50" to 1.5).  Molly emits integer and
// string scalars only, so the paths agree on every real corpus; exotic
// float spellings would diverge and are caught by the byte-parity tests
// (tests/test_fast_ingest.py), not silently mangled.
void append_field(std::string& out, const JVal& obj, const char* key) {
  out += '"';
  out += key;
  out += "\": ";
  const JVal* v = obj.get(key);
  if (!v) { out += "\"\""; return; }
  switch (v->type) {
    case JVal::STR: append_escaped(out, v->s); break;
    case JVal::NUM: out += v->s; break;
    case JVal::BOOL: out += v->b ? "true" : "false"; break;
    case JVal::NUL: out += "null"; break;
    default: out += "\"\""; break;  // arrays/objects never survive from_json
  }
}

// Append the always-a-string field value (Python str() coercion).
void append_str_value(std::string& out, const std::string& s) {
  append_escaped(out, s);
}

// Generic canonical serialization of a parsed JSON value, matching Python
// json.load -> json.dumps (default separators, ensure_ascii=True, dict
// insertion order preserved).  Same numeric caveat as append_field: NUM
// raw tokens are spliced verbatim, so exotic float spellings ("1e2",
// "1.50") diverge from Python's float canonicalization — caught by the
// byte-parity tests, never silently mangled.
void append_jval(std::string& out, const JVal& v) {
  switch (v.type) {
    case JVal::NUL: out += "null"; break;
    case JVal::BOOL: out += v.b ? "true" : "false"; break;
    case JVal::NUM: out += v.s; break;
    case JVal::STR: append_escaped(out, v.s); break;
    case JVal::ARR:
      out += '[';
      for (size_t i = 0; i < v.arr.size(); ++i) {
        if (i) out += ", ";
        append_jval(out, v.arr[i]);
      }
      out += ']';
      break;
    case JVal::OBJ:
      out += '{';
      for (size_t i = 0; i < v.obj.size(); ++i) {
        if (i) out += ", ";
        append_escaped(out, v.obj[i].first);
        out += ": ";
        append_jval(out, v.obj[i].second);
      }
      out += '}';
      break;
  }
}

// Python `int(d.get(key, dflt))` over a parsed value, emitted as the
// decimal string json.dumps would print.  Pure-integer tokens pass through
// digit-for-digit (arbitrary precision, matching Python ints beyond 64
// bits; leading zeros/'+' normalized away).  Tokens with '.'/'e'/'E' go
// through strtod + truncation toward zero, matching int(float) for every
// value a double represents exactly.  BOOL -> 0/1, absent/other -> dflt.
// Untrusted bytes destined for an error message: decoded strings can hold
// WTF-8 (lone \u surrogates) or get cut mid-codepoint, and the Python side
// decodes the error buffer as UTF-8 — so ship printable ASCII only.
std::string err_snippet(const std::string& s, size_t max_len = 40) {
  std::string out;
  for (size_t i = 0; i < s.size() && out.size() < max_len; ++i) {
    unsigned char c = (unsigned char)s[i];
    out += (c >= 0x20 && c < 0x7F) ? (char)c : '?';
  }
  return out;
}

[[noreturn]] void py_reject(const std::string& what) {
  // Mirrors a Python-loader exception (TypeError/ValueError/OverflowError
  // in the datatypes from_json path): the packed-first ETL must reject
  // exactly the inputs the object path rejects (VERDICT r4 task 4).
  throw std::runtime_error("schema error (python-loader parity): " + what);
}

std::string coerce_int_str(const JVal* v, long dflt) {
  if (!v) return std::to_string(dflt);
  if (v->type == JVal::BOOL) return v->b ? "1" : "0";  // int(True) == 1
  if (v->type != JVal::NUM && v->type != JVal::STR)
    py_reject("int() of a null/array/object value");
  // Integer-shaped fast path, shared by NUM and STR: Python int(str)
  // strips ASCII whitespace and allows single underscores between digits
  // (JSON NUM tokens can contain neither, so the extra leniency is
  // STR-only in practice).  Pure-integer tokens pass through
  // digit-for-digit — arbitrary precision, matching Python ints beyond
  // 64 bits; leading zeros/'+' normalized away.  Known divergences,
  // both Python-accepted forms this rejects: non-ASCII unicode digits
  // and unicode-whitespace padding — schema-invalid for Molly (Go json
  // marshaling never emits them) and out of parity scope.
  std::string s = v->s;
  size_t b = 0, e2 = s.size();
  while (b < e2 && std::isspace((unsigned char)s[b])) ++b;
  while (e2 > b && std::isspace((unsigned char)s[e2 - 1])) --e2;
  s = s.substr(b, e2 - b);
  size_t i = 0;
  bool neg = false;
  if (i < s.size() && (s[i] == '+' || s[i] == '-')) neg = s[i++] == '-';
  std::string digits;
  bool ok = i < s.size();
  bool prev_digit = false;
  for (; i < s.size(); ++i) {
    if (std::isdigit((unsigned char)s[i])) {
      digits += s[i];
      prev_digit = true;
    } else if (s[i] == '_' && prev_digit && i + 1 < s.size() &&
               std::isdigit((unsigned char)s[i + 1])) {
      prev_digit = false;  // single separator between digits
    } else {
      ok = false;
      break;
    }
  }
  if (ok && !digits.empty()) {
    size_t nz = 0;
    while (nz + 1 < digits.size() && digits[nz] == '0') ++nz;  // keep lone "0"
    std::string out = digits.substr(nz);
    if (neg && out != "0") out.insert(out.begin(), '-');
    return out;
  }
  // Python int(str) accepts ONLY the integer shape above — int("1.5") and
  // int("0x10") raise ValueError.
  if (v->type == JVal::STR)
    py_reject("int() of non-integer string " + err_snippet(v->s));
  // A non-integer NUM token is float-shaped by the strict number() grammar
  // (digits with '.'/exponent, no hex/inf/nan) -> Python int(float)
  // truncation.  Locale-independent parse with full-consumption check:
  // strtod honors LC_NUMERIC (a host app setting de_DE would stop at '.'),
  // while from_chars always uses the JSON radix.  FP from_chars needs
  // libstdc++ >= GCC 11; older toolchains (this library self-compiles on
  // the user's machine) fall back to strtod with the radix character
  // swapped to whatever the active locale expects.
  double d = 0.0;
  bool parsed = false;
  {
    std::string t = s;
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
    auto res = std::from_chars(t.data(), t.data() + t.size(), d,
                               std::chars_format::general);
    parsed = res.ec == std::errc() && res.ptr == t.data() + t.size();
#else
    const char* radix = std::localeconv()->decimal_point;
    if (radix && radix[0] && radix[0] != '.')
      for (char& ch : t)
        if (ch == '.') ch = radix[0];
    char* end = nullptr;
    d = std::strtod(t.c_str(), &end);
    parsed = end == t.c_str() + t.size();
#endif
  }
  if (parsed && std::isfinite(d)) {
    // %.0f prints the double's exact integer value at any magnitude
    // (doubles >= 2^53 are integral), matching Python int(float) even
    // beyond the long long range where a cast would be UB.
    double t = std::trunc(d);
    char buf[512];
    std::snprintf(buf, sizeof buf, "%.0f", t);
    // %.0f spells negative zero "-0"; Python int(-0.4) prints "0".
    return (buf[0] == '-' && buf[1] == '0' && buf[2] == '\0') ? "0" : buf;
  }
  // A grammar-valid NUM token that didn't parse finite is an overflow
  // ("1e999" -> inf): Python's int(float) raises OverflowError there.
  py_reject("int() overflow on numeric token " + err_snippet(v->s));
}

// Python iteration over a non-array JSON value: string -> its characters
// (codepoints, as STR JVals), dict -> its keys; NUM/BOOL/null raise
// TypeError in Python (signaled by returning false).  Arrays are the
// common case and are iterated in place by the callers — no JVal copies.
bool py_iter_items(const JVal& v, std::vector<JVal>& items) {
  JVal tmp;
  tmp.type = JVal::STR;
  if (v.type == JVal::STR) {
    for (size_t ci = 0; ci < v.s.size();) {
      unsigned char c0 = (unsigned char)v.s[ci];
      size_t len = c0 < 0x80 ? 1 : (c0 & 0xE0) == 0xC0 ? 2 : (c0 & 0xF0) == 0xE0 ? 3 : 4;
      if (ci + len > v.s.size()) len = 1;
      tmp.s = v.s.substr(ci, len);
      items.push_back(tmp);
      ci += len;
    }
    return true;
  }
  if (v.type == JVal::OBJ) {
    for (const auto& kv : v.obj) {
      tmp.s = kv.first;
      items.push_back(tmp);
    }
    return true;
  }
  return false;
}

// Python `list(v)` then json.dumps; non-iterables raise TypeError in the
// Python loader, so they reject here too (trust-boundary parity).
void append_pylist(std::string& out, const JVal& v) {
  if (v.type == JVal::ARR) {  // list(arr) passthrough, no element copies
    append_jval(out, v);
    return;
  }
  std::vector<JVal> items;
  if (!py_iter_items(v, items)) py_reject("list() of a non-iterable value");
  out += '[';
  for (size_t i = 0; i < items.size(); ++i) {
    if (i) out += ", ";
    append_jval(out, items[i]);
  }
  out += ']';
}

bool jval_falsy(const JVal* v);  // defined below (RawGraph section)

// Mirror of Python `for x in <container>`: arrays iterate in place;
// strings/objects iterate as characters/keys (py_iter_items); everything
// else raises TypeError in Python -> py_reject here.  or_empty mirrors the
// `d.get(key) or []` idiom (falsy values collapse to the empty list).
const std::vector<JVal>* py_elements(const JVal* v, std::vector<JVal>& scratch,
                                     bool or_empty, const char* what) {
  static const std::vector<JVal> kEmpty;
  if (!v) return &kEmpty;
  if (or_empty && jval_falsy(v)) return &kEmpty;
  if (v->type == JVal::ARR) return &v->arr;
  scratch.clear();
  if (!py_iter_items(*v, scratch))
    py_reject(std::string(what) + " is not iterable");
  return &scratch;
}

// Python `<element>.get(...)` requires a dict element.
void require_obj(const JVal& v, const char* what) {
  if (v.type != JVal::OBJ) py_reject(std::string(what) + " entry is not an object");
}

// Canonical head fragment of one debugging.json run entry — the five
// metadata pairs every run carries, byte-identical to what the pure-Python
// path emits via RunData.from_json -> to_json -> json.dumps
// (ingest/datatypes.py, analysis/pipeline.py:_run_json_str).  The from_json
// normalizations (missing-key defaults, int coercion, fixed key order,
// reading ONLY the schema fields) are reproduced here so the compiled ETL
// can serve report metadata without Python ever building run objects.
// Reference schema: faultinjectors/data-types.go:6-98.
std::string build_run_head(const JVal& r) {
  std::string out;
  out += "\"iteration\": ";
  out += coerce_int_str(r.get("iteration"), 0);
  out += ", \"status\": ";
  {
    const JVal* st = r.get("status");
    if (!st) out += "\"\"";
    else append_jval(out, *st);
  }
  out += ", \"failureSpec\": ";
  const JVal* fs = r.get("failureSpec");
  if (!fs || fs->type == JVal::NUL) {
    out += "null";
  } else {
    // FailureSpec.from_json(d["failureSpec"]) does .get on it: non-dict
    // values raise AttributeError in the Python loader.
    require_obj(*fs, "failureSpec");
    out += "{\"eot\": ";
    out += coerce_int_str(fs->get("eot"), 0);
    out += ", \"eff\": ";
    out += coerce_int_str(fs->get("eff"), 0);
    out += ", \"maxCrashes\": ";
    out += coerce_int_str(fs->get("maxCrashes"), 0);
    out += ", \"nodes\": ";
    // FailureSpec.from_json does list(d["nodes"]) when present/non-null.
    const JVal* nodes = fs->get("nodes");
    if (!nodes || nodes->type == JVal::NUL) out += "null";
    else append_pylist(out, *nodes);
    out += ", \"crashes\": ";
    const JVal* crashes = fs->get("crashes");
    std::vector<JVal> cr_scratch;
    if (!crashes || crashes->type == JVal::NUL) {
      out += "null";
    } else {
      const auto& cr_items = *py_elements(crashes, cr_scratch, false, "crashes");
      out += '[';
      for (size_t i = 0; i < cr_items.size(); ++i) {
        if (i) out += ", ";
        const JVal& cr = cr_items[i];
        require_obj(cr, "crashes");
        out += "{\"node\": ";
        const JVal* n = cr.get("node");
        if (!n) out += "\"\"";
        else append_jval(out, *n);
        out += ", \"time\": ";
        out += coerce_int_str(cr.get("time"), 0);
        out += '}';
      }
      out += ']';
    }
    out += ", \"omissions\": ";
    const JVal* om = fs->get("omissions");
    std::vector<JVal> om_scratch;
    if (!om || om->type == JVal::NUL) {
      out += "null";
    } else {
      const auto& om_items = *py_elements(om, om_scratch, false, "omissions");
      out += '[';
      for (size_t i = 0; i < om_items.size(); ++i) {
        if (i) out += ", ";
        const JVal& o = om_items[i];
        require_obj(o, "omissions");
        out += "{\"from\": ";
        const JVal* f = o.get("from");
        if (!f) out += "\"\"";
        else append_jval(out, *f);
        out += ", \"to\": ";
        const JVal* t = o.get("to");
        if (!t) out += "\"\"";
        else append_jval(out, *t);
        out += ", \"time\": ";
        out += coerce_int_str(o.get("time"), 0);
        out += '}';
      }
      out += ']';
    }
    out += '}';
  }
  out += ", \"model\": ";
  const JVal* model = r.get("model");
  if (!model || model->type == JVal::NUL) {
    out += "null";
  } else {
    // Model.from_json reads ONLY "tables" (missing -> {}); everything else
    // in the raw model object is dropped by the schema, and each table row
    // is normalized via Python list(r).  Non-dict model -> .get raises;
    // present non-dict tables -> .items() raises (both AttributeError in
    // the Python loader).
    require_obj(*model, "model");
    out += "{\"tables\": ";
    const JVal* tables = model->get("tables");
    if (!tables) {
      out += "{}";
    } else if (tables->type != JVal::OBJ) {
      py_reject("model tables is not an object");
    } else {
      out += '{';
      for (size_t ti = 0; ti < tables->obj.size(); ++ti) {
        if (ti) out += ", ";
        append_escaped(out, tables->obj[ti].first);
        out += ": ";
        // [list(r) for r in v]: Python iteration over the rows container,
        // then list(r) per row; non-iterables raise in Python — null.
        const JVal& rows = tables->obj[ti].second;
        if (rows.type == JVal::ARR) {  // common case, iterate in place
          out += '[';
          for (size_t ri = 0; ri < rows.arr.size(); ++ri) {
            if (ri) out += ", ";
            append_pylist(out, rows.arr[ri]);
          }
          out += ']';
        } else {
          std::vector<JVal> elems;
          if (!py_iter_items(rows, elems))
            py_reject("model table rows are not iterable");
          out += '[';
          for (size_t ri = 0; ri < elems.size(); ++ri) {
            if (ri) out += ", ";
            append_pylist(out, elems[ri]);
          }
          out += ']';
        }
      }
      out += '}';
    }
    out += '}';
  }
  out += ", \"messages\": [";
  const JVal* msgs = r.get("messages");
  std::vector<JVal> msg_scratch;
  {
    const auto& m_items = *py_elements(msgs, msg_scratch, /*or_empty=*/true,
                                       "messages");
    for (size_t i = 0; i < m_items.size(); ++i) {
      if (i) out += ", ";
      const JVal& m = m_items[i];
      require_obj(m, "messages");
      out += "{\"table\": ";
      const JVal* tb = m.get("table");
      if (!tb) out += "\"\"";
      else append_jval(out, *tb);
      out += ", \"from\": ";
      const JVal* f = m.get("from");
      if (!f) out += "\"\"";
      else append_jval(out, *f);
      out += ", \"to\": ";
      const JVal* t = m.get("to");
      if (!t) out += "\"\"";
      else append_jval(out, *t);
      out += ", \"sendTime\": ";
      out += coerce_int_str(m.get("sendTime"), 0);
      out += ", \"receiveTime\": ";
      out += coerce_int_str(m.get("receiveTime"), 0);
      out += '}';
    }
  }
  out += ']';
  return out;
}

// One provenance graph after parsing + namespacing, before interning.
struct RawGraph {
  int32_t n_goals = 0;
  std::vector<std::string> ids;     // slot -> namespaced id (goals then rules)
  std::vector<std::string> tables;  // per slot
  std::vector<std::string> labels;
  std::vector<std::string> times;   // goals only meaningful; rules ""
  std::vector<int32_t> types;       // 0 none, 1 async, 2 next, 3 collapsed
  std::vector<int32_t> esrc, edst;  // slot indices
  std::string prov_json;            // namespaced serialization (see above)
};

// True when a JVal would be falsy in Python (omitted by `if self.sender:`).
bool jval_falsy(const JVal* v) {
  if (!v) return true;
  switch (v->type) {
    case JVal::STR: return v->s.empty();
    case JVal::NUM: {
      double d = std::strtod(v->s.c_str(), nullptr);
      return d == 0.0;
    }
    case JVal::BOOL: return !v->b;
    case JVal::NUL: return true;
    default: return false;  // non-empty containers never survive from_json
  }
}

int32_t type_id_of(const std::string& t) {
  if (t == "async") return 1;
  if (t == "next") return 2;
  if (t == "collapsed") return 3;
  return 0;
}

// Strict UTF-8 validation (RFC 3629 ranges incl. surrogate/overlong
// rejection): the Python loader reads these files in text mode, so invalid
// bytes raise UnicodeDecodeError there — the native path must reject the
// same inputs instead of passing raw bytes through (trust-boundary parity).
void validate_utf8(const std::string& s, const std::string& path) {
  const unsigned char* p = (const unsigned char*)s.data();
  size_t n = s.size(), i = 0;
  while (i < n) {
    unsigned char c = p[i];
    if (c < 0x80) { ++i; continue; }
    size_t len;
    unsigned lo = 0x80, hi = 0xBF;
    if (c >= 0xC2 && c <= 0xDF) len = 2;
    else if (c == 0xE0) { len = 3; lo = 0xA0; }
    else if (c >= 0xE1 && c <= 0xEC) len = 3;
    else if (c == 0xED) { len = 3; hi = 0x9F; }  // no surrogates
    else if (c == 0xEE || c == 0xEF) len = 3;
    else if (c == 0xF0) { len = 4; lo = 0x90; }
    else if (c >= 0xF1 && c <= 0xF3) len = 4;
    else if (c == 0xF4) { len = 4; hi = 0x8F; }
    else throw std::runtime_error(path + ": invalid UTF-8 at byte " + std::to_string(i));
    if (i + len > n)
      throw std::runtime_error(path + ": truncated UTF-8 at byte " + std::to_string(i));
    if (p[i + 1] < lo || p[i + 1] > hi)
      throw std::runtime_error(path + ": invalid UTF-8 at byte " + std::to_string(i));
    for (size_t k = 2; k < len; ++k)
      if (p[i + k] < 0x80 || p[i + k] > 0xBF)
        throw std::runtime_error(path + ": invalid UTF-8 at byte " + std::to_string(i));
    i += len;
  }
}

double seconds_since(std::chrono::steady_clock::time_point t0) {
  return std::chrono::duration<double>(std::chrono::steady_clock::now() - t0).count();
}

// What one corpus's read_file calls cost: their summed wall (open, read and
// UTF-8 check), the files read and their bytes.
struct ReadStats {
  double read_s = 0;
  int64_t files = 0, bytes = 0;
};

std::string read_file(const std::string& path, ReadStats& st) {
  auto t0 = std::chrono::steady_clock::now();
  std::ifstream f(path, std::ios::binary);
  if (!f) throw std::runtime_error("cannot open " + path);
  std::ostringstream ss;
  ss << f.rdbuf();
  std::string out = ss.str();
  validate_utf8(out, path);
  st.read_s += seconds_since(t0);
  st.files += 1;
  st.bytes += (int64_t)out.size();
  return out;
}

// Python str() of a JSON value fetched via d.get(key, "") — the coercion
// Goal.from_json applies to "time" (datatypes.py:166).
std::string py_str_of(const JVal* v) {
  if (!v) return "";
  switch (v->type) {
    case JVal::STR: return v->s;
    case JVal::NUM: return v->s;
    case JVal::NUL: return "None";
    case JVal::BOOL: return v->b ? "True" : "False";
    default: return "";
  }
}

RawGraph parse_prov(const std::string& path, long iteration, const char* cond, ReadStats& st) {
  JVal doc = JsonParser(read_file(path, st)).parse();
  if (doc.type != JVal::OBJ) throw std::runtime_error(path + ": provenance root not an object");
  RawGraph g;
  std::string prefix = "run_" + std::to_string(iteration) + "_" + cond + "_";
  std::unordered_map<std::string, int32_t> slot;  // original (un-namespaced) id -> slot

  const JVal* goals = doc.get("goals");
  const JVal* rules = doc.get("rules");
  const JVal* edges = doc.get("edges");

  // The namespaced serialization is built alongside the packed arrays so
  // the DOM is walked exactly once; `js` accumulates the byte-exact
  // json.dumps(ProvData.to_json()) output.
  std::string& js = g.prov_json;
  js.reserve(4096);
  js += "{\"goals\": [";

  std::vector<JVal> g_scratch;
  {
    bool first = true;
    for (const JVal& jg : *py_elements(goals, g_scratch, false, "goals")) {
      require_obj(jg, "goals");
      // _namespace_prov does prefix + goal.id: a non-string id raises
      // TypeError in the Python loader.
      const JVal* idv = jg.get("id");
      if (idv && idv->type != JVal::STR) py_reject("goal id is not a string");
      std::string id = jg.get_str("id");
      std::string table = jg.get_str("table");
      std::string label = jg.get_str("label");
      std::string time = py_str_of(jg.get("time"));
      if (table == "clock") {  // molly.go:76-89: wild first, two-number wins
        // The Python loader regex-searches goal.label here; a non-string
        // label raises TypeError for clock goals (and only there).
        const JVal* lv = jg.get("label");
        if (lv && lv->type != JVal::STR)
          py_reject("clock goal label is not a string");
        std::string t;
        if (match_clock_wild(label, t)) time = t;
        if (match_clock_two(label, t)) time = t;
      }
      slot[id] = (int32_t)g.ids.size();  // last occurrence wins (packed.py pack_graph)
      g.ids.push_back(prefix + id);
      g.tables.push_back(table);
      g.labels.push_back(label);
      g.times.push_back(time);
      g.types.push_back(0);

      if (!first) js += ", ";
      first = false;
      // Goal.to_json key order: id, label, table, time, [conditionHolds —
      // never: ingest pins cond_holds=False, molly.py:55], [sender],
      // [receiver] (datatypes.py:171-185).
      js += "{\"id\": ";
      append_escaped(js, g.ids.back());
      js += ", ";
      append_field(js, jg, "label");
      js += ", ";
      append_field(js, jg, "table");
      js += ", \"time\": ";
      append_str_value(js, time);
      const JVal* sender = jg.get("sender");
      if (!jval_falsy(sender)) {
        js += ", ";
        append_field(js, jg, "sender");
      }
      const JVal* receiver = jg.get("receiver");
      if (!jval_falsy(receiver)) {
        js += ", ";
        append_field(js, jg, "receiver");
      }
      js += '}';
    }
  }
  g.n_goals = (int32_t)g.ids.size();
  js += "], \"rules\": [";
  std::vector<JVal> r_scratch;
  {
    bool first = true;
    for (const JVal& jr : *py_elements(rules, r_scratch, false, "rules")) {
      require_obj(jr, "rules");
      const JVal* idv = jr.get("id");
      if (idv && idv->type != JVal::STR) py_reject("rule id is not a string");
      std::string id = jr.get_str("id");
      slot[id] = (int32_t)g.ids.size();  // last occurrence wins (packed.py pack_graph)
      g.ids.push_back(prefix + id);
      g.tables.push_back(jr.get_str("table"));
      g.labels.push_back(jr.get_str("label"));
      g.times.push_back("");
      g.types.push_back(type_id_of(jr.get_str("type")));

      if (!first) js += ", ";
      first = false;
      // Rule.to_json: all four keys, unconditionally (datatypes.py:209).
      js += "{\"id\": ";
      append_escaped(js, g.ids.back());
      js += ", ";
      append_field(js, jr, "label");
      js += ", ";
      append_field(js, jr, "table");
      js += ", ";
      append_field(js, jr, "type");
      js += '}';
    }
  }
  js += "], \"edges\": [";
  std::vector<JVal> e_scratch;
  {
    bool first = true;
    for (const JVal& je : *py_elements(edges, e_scratch, false, "edges")) {
      require_obj(je, "edges");
      const JVal* fv = je.get("from");
      const JVal* tv = je.get("to");
      if ((fv && fv->type != JVal::STR) || (tv && tv->type != JVal::STR))
        py_reject("edge endpoint is not a string");
      std::string esrc = je.get_str("from");
      std::string edst = je.get_str("to");
      auto si = slot.find(esrc);
      auto di = slot.find(edst);
      if (si == slot.end() || di == slot.end())
        throw std::runtime_error(path + ": edge endpoint not a known goal/rule id");
      g.esrc.push_back(si->second);
      g.edst.push_back(di->second);

      if (!first) js += ", ";
      first = false;
      js += "{\"from\": ";
      append_escaped(js, prefix + esrc);
      js += ", \"to\": ";
      append_escaped(js, prefix + edst);
      js += '}';
    }
  }
  js += "]}";
  return g;
}

int32_t bucket_size(int32_t n, int32_t minimum = 16) {
  int32_t b = minimum;
  while (b < n) b *= 2;
  return b;
}

// Longest path (in edges) of one graph's DAG via topological relaxation;
// returns node count on a cycle (mirror of graphs/packed.py:longest_path_len
// — the tight static trip count for the depth-relaxation kernels).
int32_t longest_path_len(const RawGraph& g) {
  int32_t n = (int32_t)g.ids.size();
  if (n == 0 || g.esrc.empty()) return 0;
  std::vector<int32_t> indeg(n, 0);
  std::vector<std::vector<int32_t>> out(n);
  for (size_t k = 0; k < g.esrc.size(); ++k) {
    out[g.esrc[k]].push_back(g.edst[k]);
    indeg[g.edst[k]]++;
  }
  std::vector<int32_t> dist(n, 0), stack;
  for (int32_t i = 0; i < n; ++i)
    if (indeg[i] == 0) stack.push_back(i);
  int32_t seen = 0, best = 0;
  while (!stack.empty()) {
    int32_t u = stack.back();
    stack.pop_back();
    seen++;
    for (int32_t w : out[u]) {
      if (dist[u] + 1 > dist[w]) dist[w] = dist[u] + 1;
      if (--indeg[w] == 0) stack.push_back(w);
    }
    best = std::max(best, dist[u]);
  }
  if (seen < n) return n;  // cycle: conservative bound
  return best;
}

// Packed arrays for one condition's batch (layout of graphs/packed.py).
struct PackedCond {
  std::vector<int32_t> table_id, label_id, time_id, type_id;  // [B*V]
  std::vector<uint8_t> is_goal, node_mask;                    // [B*V]
  std::vector<int32_t> edge_src, edge_dst;                    // [B*E]
  std::vector<uint8_t> edge_mask;                             // [B*E]
  std::vector<int32_t> n_nodes, n_goals;                      // [B]
  std::vector<uint8_t> chain_linear;                          // [B]
  std::vector<std::string> node_ids_joined;                   // per run, '\n'-joined
  std::vector<std::string> prov_json;                         // per run, namespaced
};

// Per-graph mirror of ops/simplify.py:chains_linear_host: True iff the
// graph's @next chain-member subgraph (after the clean_masks restriction)
// has member in/out degree <= 1 — the precondition for the O(V log V)
// pointer-doubling component labels.  Duplicate edge-list entries inflate
// the counts exactly like the numpy batched check (conservative: a
// duplicated chain edge can only flip the answer to False, costing the
// closure fallback, never correctness).
bool graph_chain_linear(const RawGraph& g) {
  const int32_t n = (int32_t)g.ids.size();
  const int32_t ng = g.n_goals;  // slots [0, ng) are goals, rest rules
  const size_t m = g.esrc.size();
  // has_in_goal[x]: some goal -> x edge; has_out_goal[x]: some x -> goal.
  std::vector<uint8_t> has_in_goal(n, 0), has_out_goal(n, 0);
  for (size_t k = 0; k < m; ++k) {
    int32_t s = g.esrc[k], d = g.edst[k];
    if (s < ng) has_in_goal[d] = 1;   // goal s feeds d
    if (d < ng) has_out_goal[s] = 1;  // s feeds goal d
  }
  std::vector<uint8_t> alive(n, 0);
  for (int32_t s = 0; s < n; ++s)
    alive[s] = s < ng || (has_in_goal[s] && has_out_goal[s]);
  std::vector<uint8_t> next_rule(n, 0);
  for (int32_t s = ng; s < n; ++s)
    next_rule[s] = alive[s] && g.types[s] == 2;  // 2 = "next"
  // clean_masks edge keep: from a goal iff the rule dst has an out-goal;
  // from a rule iff it has an in-goal; endpoints alive.
  std::vector<uint8_t> keep(m, 0), in_from_next(n, 0), out_to_next(n, 0);
  for (size_t k = 0; k < m; ++k) {
    int32_t s = g.esrc[k], d = g.edst[k];
    bool kp = (s < ng ? has_out_goal[d] : has_in_goal[s]) && alive[s] && alive[d];
    keep[k] = kp;
    if (kp && next_rule[s]) in_from_next[d] = 1;
    if (kp && next_rule[d]) out_to_next[s] = 1;
  }
  std::vector<uint8_t> member(n, 0);
  for (int32_t s = 0; s < n; ++s)
    member[s] = next_rule[s] ||
                (s < ng && alive[s] && in_from_next[s] && out_to_next[s]);
  std::vector<int32_t> succ(n, 0), pred(n, 0);
  for (size_t k = 0; k < m; ++k) {
    if (!keep[k]) continue;
    int32_t s = g.esrc[k], d = g.edst[k];
    if (member[s] && member[d]) {
      if (++succ[s] > 1) return false;
      if (++pred[d] > 1) return false;
    }
  }
  return true;
}

struct Corpus {
  int64_t n_runs = 0, v = 0, e = 0, max_depth = 1;
  Vocab tables, labels, times;
  PackedCond cond[2];  // 0 = pre, 1 = post
  std::vector<int32_t> iteration;
  std::vector<uint8_t> success;
  std::vector<std::string> run_heads;  // per run, canonical head JSON fragment
  std::string error;  // empty on success
  // The engine's own wall, split: read_s, the reads' share (runs.json's
  // read, plus the pool's wall times its workers' read share), and parse_s,
  // the rest (JSON parse, provenance transform, packing).  files and bytes
  // count every file read; read_thread_s sums the workers' read_file
  // walls, and workers is the pool's size.
  ReadStats read;
  double parse_s = 0, read_thread_s = 0;
  int64_t workers = 1;
};

void pack_cond(std::vector<RawGraph>& graphs, int64_t v, int64_t e, Corpus& c,
               PackedCond& out) {
  int64_t b = (int64_t)graphs.size();
  out.table_id.assign(b * v, -1);
  out.label_id.assign(b * v, -1);
  out.time_id.assign(b * v, -1);
  out.type_id.assign(b * v, 0);
  out.is_goal.assign(b * v, 0);
  out.node_mask.assign(b * v, 0);
  out.edge_src.assign(b * e, 0);
  out.edge_dst.assign(b * e, 0);
  out.edge_mask.assign(b * e, 0);
  out.n_nodes.resize(b);
  out.n_goals.resize(b);
  out.chain_linear.resize(b);
  out.node_ids_joined.resize(b);
  out.prov_json.resize(b);
  for (int64_t i = 0; i < b; ++i) {
    RawGraph& g = graphs[i];
    out.chain_linear[i] = graph_chain_linear(g) ? 1 : 0;
    out.prov_json[i] = std::move(g.prov_json);
    int32_t n = (int32_t)g.ids.size();
    out.n_nodes[i] = n;
    out.n_goals[i] = g.n_goals;
    std::string joined;
    for (int32_t s = 0; s < n; ++s) {
      out.table_id[i * v + s] = c.tables.intern(g.tables[s]);
      out.label_id[i * v + s] = c.labels.intern(g.labels[s]);
      out.time_id[i * v + s] = c.times.intern(s < g.n_goals ? g.times[s] : "");
      out.type_id[i * v + s] = g.types[s];
      out.is_goal[i * v + s] = s < g.n_goals;
      out.node_mask[i * v + s] = 1;
      if (s) joined += '\n';
      joined += g.ids[s];
    }
    out.node_ids_joined[i] = std::move(joined);
    for (size_t k = 0; k < g.esrc.size(); ++k) {
      out.edge_src[i * e + (int64_t)k] = g.esrc[k];
      out.edge_dst[i * e + (int64_t)k] = g.edst[k];
      out.edge_mask[i * e + (int64_t)k] = 1;
    }
  }
}

constexpr int kPoolMaxWorkers = 16;

// The pool's size: `forced` when above 0 (tests), else the process's CPU
// affinity set clamped to [2, 16] (two at least, since a file read is a
// wait that another worker's parse can hide); never more than the runs.
int pool_workers(int64_t n_runs, int forced) {
  int64_t n;
  if (forced > 0) {
    n = forced;
  } else {
    cpu_set_t set;
    int cores = sched_getaffinity(0, sizeof set, &set) == 0 ? CPU_COUNT(&set)
                                                             : (int)std::thread::hardware_concurrency();
    n = std::clamp(cores, 2, kPoolMaxWorkers);
  }
  return (int)std::max<int64_t>(1, std::min(n, n_runs));
}

// An error and the run whose row or files raised it (-1: none).
struct RunError {
  int64_t run = -1;
  std::string what;
};

// One pool worker: claims run indices in order from `next` until it draws
// one at or past `limit`, and parses that run's pre file, then its post
// file.  A failure lowers `limit` to its run, so runs after it are not
// claimed; every run before it still is, so the error of the lowest run
// is the one the serial order meets first.
struct PoolWorker {
  ReadStats read;
  double busy_s = 0;
  RunError error;

  void run(const std::string& dir, const std::vector<int32_t>& iteration, std::atomic<int64_t>& next,
           std::atomic<int64_t>& limit, std::vector<RawGraph>& pre, std::vector<RawGraph>& post) {
    auto t0 = std::chrono::steady_clock::now();
    for (int64_t i; (i = next.fetch_add(1)) < limit.load();) {
      // Provenance files are indexed by position i, not iteration (molly.go:59-60).
      std::string stem = dir + "/run_" + std::to_string(i);
      try {
        pre[i] = parse_prov(stem + "_pre_provenance.json", iteration[i], "pre", read);
        post[i] = parse_prov(stem + "_post_provenance.json", iteration[i], "post", read);
      } catch (const std::exception& ex) {
        error = RunError{i, ex.what()};
        for (int64_t cur = limit.load(); i < cur && !limit.compare_exchange_weak(cur, i);) {
        }
      }
    }
    busy_s = seconds_since(t0);
  }
};

Corpus* ingest(const std::string& dir, bool with_heads, int forced_workers) {
  auto t0 = std::chrono::steady_clock::now();
  auto c = std::make_unique<Corpus>();
  // Pin "pre"/"post" to table ids 0/1 (mirror of graphs/packed.py
  // CorpusVocab.__post_init__): the condition-table ids are static args of
  // the fused device program, so pinning makes the compile signature
  // corpus-content-independent.
  c->tables.intern("pre");
  c->tables.intern("post");
  JVal runs = JsonParser(read_file(dir + "/runs.json", c->read)).parse();
  if (runs.type != JVal::ARR) throw std::runtime_error("runs.json: root not an array");
  c->n_runs = (int64_t)runs.arr.size();

  // (a) The runs.json rows, in order.  A bad row ends the walk: the pool
  // then parses only the runs before it, whose files the serial order
  // reads first.
  RunError first;
  int64_t n_rows = c->n_runs;
  for (int64_t i = 0; i < c->n_runs; ++i) {
    try {
      const JVal& r = runs.arr[i];
      require_obj(r, "runs.json run");
      // Python int(d.get("iteration", 0)) semantics (coerce_int_str), then a
      // loud int32 range check: Python would accept an astronomically large
      // iteration (arbitrary-precision int), but the packed arrays are
      // int32 — rejecting beats silently truncating the run namespace.
      std::string it_str = coerce_int_str(r.get("iteration"), 0);
      int32_t iter32 = 0;
      auto itp = std::from_chars(it_str.data(), it_str.data() + it_str.size(), iter32);
      if (itp.ec != std::errc() || itp.ptr != it_str.data() + it_str.size())
        throw std::runtime_error("runs.json: iteration out of int32 range: " + it_str);
      c->iteration.push_back(iter32);
      c->success.push_back(r.get_str("status") == "success");  // molly.go:53
      // Head fragments are only reachable through a live handle
      // (nemo_run_head_json); bench/prewarm ingests that drop the handle
      // skip building them — the messages arrays dominate runs.json.
      if (with_heads) c->run_heads.push_back(build_run_head(r));
    } catch (const std::exception& ex) {
      first = RunError{i, ex.what()};
      n_rows = i;
      break;
    }
  }

  // (b) Every run's pre and post file on the pool; the calling thread is
  // its first worker.
  std::vector<RawGraph> pre_graphs(n_rows), post_graphs(n_rows);
  c->workers = pool_workers(n_rows, forced_workers);
  std::vector<PoolWorker> pool(c->workers);
  std::atomic<int64_t> next{0}, limit{n_rows};
  auto tp = std::chrono::steady_clock::now();
  {
    std::vector<std::thread> threads;
    for (size_t w = 1; w < pool.size(); ++w) {
      try {
        threads.emplace_back(&PoolWorker::run, &pool[w], std::cref(dir), std::cref(c->iteration),
                             std::ref(next), std::ref(limit), std::ref(pre_graphs), std::ref(post_graphs));
      } catch (const std::system_error&) {
        break;  // no thread to be had: the workers started share the runs
      }
    }
    c->workers = 1 + (int64_t)threads.size();
    pool[0].run(dir, c->iteration, next, limit, pre_graphs, post_graphs);
    for (std::thread& t : threads) t.join();
  }
  double pool_s = seconds_since(tp), read_thread_s = 0, busy_s = 0;
  for (const PoolWorker& w : pool) {
    if (w.error.run >= 0 && (first.run < 0 || w.error.run < first.run)) first = w.error;
    c->read.files += w.read.files;
    c->read.bytes += w.read.bytes;
    read_thread_s += w.read.read_s;
    busy_s += w.busy_s;
  }
  if (first.run >= 0) throw std::runtime_error(first.what);

  // (c) Dims, then interning, in order.
  int32_t max_n = 1, max_e = 1, max_lp = 0;
  for (const auto* gs : {&pre_graphs, &post_graphs})
    for (const RawGraph& g : *gs) {
      max_n = std::max(max_n, (int32_t)g.ids.size());
      max_e = std::max(max_e, (int32_t)g.esrc.size());
      max_lp = std::max(max_lp, longest_path_len(g));
    }
  c->v = bucket_size(max_n);
  c->e = bucket_size(max_e);
  c->max_depth = std::min<int64_t>(c->v, std::max(1, max_lp + 1));

  // Interning order matches the Python path (pack_molly_for_step): all pre
  // graphs in run order, then all post graphs — so ids are bit-identical.
  pack_cond(pre_graphs, c->v, c->e, *c, c->cond[0]);
  pack_cond(post_graphs, c->v, c->e, *c, c->cond[1]);
  // The pool's wall goes to the reads in the share its workers spent in them.
  c->read_thread_s = read_thread_s;
  if (busy_s > 0) c->read.read_s += pool_s * (read_thread_s / busy_s);
  c->parse_s = seconds_since(t0) - c->read.read_s;
  return c.release();
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// Returns an opaque handle, or nullptr with a message in err[0..errlen).
// with_heads != 0 pre-serializes each run's debugging.json head fragment
// (nemo_run_head_json); callers that never read heads pass 0.  workers: 0
// for the engine's own rule (pool_workers), which the package always uses;
// n > 0 forces a pool of n, a hook for tests only.
void* nemo_ingest(const char* dir, char* err, int errlen, int with_heads, int workers) {
  try {
    return ingest(dir, with_heads != 0, workers);
  } catch (const std::exception& ex) {
    if (err && errlen > 0) {
      std::strncpy(err, ex.what(), (size_t)errlen - 1);
      err[errlen - 1] = '\0';
    }
    return nullptr;
  }
}

// dims: [n_runs, v, e, n_tables, n_labels, n_times, pre_tid, post_tid,
//        max_depth]
void nemo_dims(void* h, int64_t* out) {
  auto* c = (Corpus*)h;
  out[0] = c->n_runs;
  out[1] = c->v;
  out[2] = c->e;
  out[3] = (int64_t)c->tables.strings.size();
  out[4] = (int64_t)c->labels.strings.size();
  out[5] = (int64_t)c->times.strings.size();
  out[6] = c->tables.lookup("pre");
  out[7] = c->tables.lookup("post");
  out[8] = c->max_depth;
}

// Copy one condition's packed arrays into caller-allocated buffers
// (cond: 0 = pre, 1 = post).  Sizes: node arrays B*V, edge arrays B*E,
// n_nodes/n_goals B.
void nemo_copy(void* h, int cond, int32_t* table_id, int32_t* label_id, int32_t* time_id,
               int32_t* type_id, uint8_t* is_goal, uint8_t* node_mask, int32_t* edge_src,
               int32_t* edge_dst, uint8_t* edge_mask, int32_t* n_nodes, int32_t* n_goals,
               uint8_t* chain_linear) {
  auto* c = (Corpus*)h;
  const PackedCond& p = c->cond[cond];
  std::memcpy(chain_linear, p.chain_linear.data(), p.chain_linear.size());
  std::memcpy(table_id, p.table_id.data(), p.table_id.size() * sizeof(int32_t));
  std::memcpy(label_id, p.label_id.data(), p.label_id.size() * sizeof(int32_t));
  std::memcpy(time_id, p.time_id.data(), p.time_id.size() * sizeof(int32_t));
  std::memcpy(type_id, p.type_id.data(), p.type_id.size() * sizeof(int32_t));
  std::memcpy(is_goal, p.is_goal.data(), p.is_goal.size());
  std::memcpy(node_mask, p.node_mask.data(), p.node_mask.size());
  std::memcpy(edge_src, p.edge_src.data(), p.edge_src.size() * sizeof(int32_t));
  std::memcpy(edge_dst, p.edge_dst.data(), p.edge_dst.size() * sizeof(int32_t));
  std::memcpy(edge_mask, p.edge_mask.data(), p.edge_mask.size());
  std::memcpy(n_nodes, p.n_nodes.data(), p.n_nodes.size() * sizeof(int32_t));
  std::memcpy(n_goals, p.n_goals.data(), p.n_goals.size() * sizeof(int32_t));
}

// Run metadata: iteration numbers and success flags ([B] each).
void nemo_runs(void* h, int32_t* iteration, uint8_t* success) {
  auto* c = (Corpus*)h;
  std::memcpy(iteration, c->iteration.data(), c->iteration.size() * sizeof(int32_t));
  std::memcpy(success, c->success.data(), c->success.size());
}

// Vocabulary string (which: 0 tables, 1 labels, 2 times); valid until free.
const char* nemo_vocab(void* h, int which, int idx) {
  auto* c = (Corpus*)h;
  const Vocab& v = which == 0 ? c->tables : which == 1 ? c->labels : c->times;
  if (idx < 0 || (size_t)idx >= v.strings.size()) return "";
  return v.strings[(size_t)idx].c_str();
}

// '\n'-joined namespaced node ids of one run's graph (cond 0/1).
const char* nemo_node_ids(void* h, int cond, int run) {
  auto* c = (Corpus*)h;
  const PackedCond& p = c->cond[cond];
  if (run < 0 || (size_t)run >= p.node_ids_joined.size()) return "";
  return p.node_ids_joined[(size_t)run].c_str();
}

// Byte-exact namespaced prov serialization of one run's graph (cond 0/1):
// what json.dumps(ProvData.to_json()) produces after ingest transforms.
// Valid until free.
const char* nemo_prov_json(void* h, int cond, int run) {
  auto* c = (Corpus*)h;
  const PackedCond& p = c->cond[cond];
  if (run < 0 || (size_t)run >= p.prov_json.size()) return "";
  return p.prov_json[(size_t)run].c_str();
}

// Canonical debugging.json head fragment of one run (the five metadata
// pairs: iteration/status/failureSpec/model/messages), byte-identical to
// the pure-Python RunData round-trip.  Valid until free.
const char* nemo_run_head_json(void* h, int run) {
  auto* c = (Corpus*)h;
  if (run < 0 || (size_t)run >= c->run_heads.size()) return "";
  return c->run_heads[(size_t)run].c_str();
}

// The engine's counters of the corpus: secs [read_s, parse_s, read_thread_s]
// (the first two sum to the engine's wall); counts [files, bytes, workers].
void nemo_ingest_stats(void* h, double* secs, int64_t* counts) {
  auto* c = (Corpus*)h;
  secs[0] = c->read.read_s;
  secs[1] = c->parse_s;
  secs[2] = c->read_thread_s;
  counts[0] = c->read.files;
  counts[1] = c->read.bytes;
  counts[2] = c->workers;
}

void nemo_free(void* h) { delete (Corpus*)h; }

// ABI version for the ctypes wrapper to sanity-check.
int nemo_abi_version() { return 7; }

}  // extern "C"
