// Native streaming-record parser: JSON lines -> packed feature arrays.
//
// The port's copy of the JAX package's ops/native/fastparse.cpp (the C ABI,
// the parse rules and the CRC32 hashing are the same; the port's tests hold
// the two libraries' outputs equal byte for byte). A host component built
// with g++, not a device kernel. Equivalent of the reference's ingest hot path
// (DataInstanceParser + DataPointParser, reference:
// src/main/scala/omldm/utils/parsers/*): the JVM parses each record with Jackson
// into POJOs; here a single C++ pass over the byte buffer extracts the
// schema-known fields (numericalFeatures, discreteFeatures, target,
// operation) straight into packed float32 batch arrays, skipping Python
// object churn entirely. Records that do not match the fast schema are
// flagged so the caller can fall back to the Python parser (identical
// drop/keep semantics).
//
// Build: g++ -O3 -shared -fPIC -pthread -o libfastparse.so fastparse.cpp
//
// Exposed C ABI:
//   int omldm_parse_lines(buf, len, dim, max_records, x, y, op, valid,
//                         bytes_consumed)
//   int omldm_parse_lines_mt(buf, len, dim, max_records, x, y, op, valid,
//                            n_threads, bytes_consumed)
// Returns the number of lines consumed and stores the byte offset consumed
// (so a caller sizing its arrays by estimate can continue from there
// without pre-counting newlines). For line i:
//   valid[i] = 1 parsed ok, 0 dropped (invalid/EOS), 2 needs Python fallback
//   op[i]    = 0 training, 1 forecasting
//   y[i]     = target (0 when absent); x[i*dim .. i*dim+dim) zero-padded.
//
// Throughput design (this is the part that keeps the device fed):
// - ONE structural walk per line (key -> value, values skipped with memchr)
//   instead of re-scanning the line for every known key;
// - SWAR digit parsing: 8 or 4 ASCII digits converted per multiply chain
//   (the classic 0x0F0F... mask + pairwise-merge trick) instead of a serial
//   mant = mant*10 + d chain; strtod only for oddball syntax;
// - the _mt entry indexes newline offsets then parses disjoint line ranges
//   on std::threads (each line owns its output row; nothing is shared).

#include <cctype>
#include <cmath>
#include <cstdio>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

const double kPow10[] = {1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,
                         1e8,  1e9,  1e10, 1e11, 1e12, 1e13, 1e14, 1e15,
                         1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};

// --- SWAR digit runs -------------------------------------------------------

const uint64_t kPow10u[] = {1ull,       10ull,       100ull,
                            1000ull,    10000ull,    100000ull,
                            1000000ull, 10000000ull, 100000000ull};

// 8 ASCII digits -> value (Lemire's parse_eight_digits).
inline uint64_t swar8(uint64_t c) {
  c -= 0x3030303030303030ull;
  c = (c * 10) + (c >> 8);
  const uint64_t mask = 0x000000FF000000FFull;
  const uint64_t mul1 = 0x000F424000000064ull;  // 100 + (1000000 << 32)
  const uint64_t mul2 = 0x0000271000000001ull;  // 1 + (10000 << 32)
  c = (((c & mask) * mul1) + (((c >> 16) & mask) * mul2)) >> 32;
  return c;
}

// Count the leading ASCII-digit bytes of an 8-byte (text-order) load: a
// byte is a digit iff (c^0x30) <= 9; the +0x76 carry trick sets the high
// bit of every non-digit byte, ctz finds the first one.
inline int digit_prefix_len8(uint64_t c8) {
  uint64_t t = c8 ^ 0x3030303030303030ull;
  uint64_t nd = ((t + 0x7676767676767676ull) | t) & 0x8080808080808080ull;
  if (nd == 0) return 8;
  return static_cast<int>(__builtin_ctzll(nd)) >> 3;
}

// Accumulate a digit run into mant; returns #digits consumed. One 8-byte
// load classifies the run head (no all-or-nothing retries): a partial run
// of n digits is shifted to the tail bytes, the head refilled with ASCII
// zeros, and folded with the same swar8.
inline int parse_digit_run(const char*& p, const char* end, uint64_t& mant) {
  int digits = 0;
  while (end - p >= 8) {
    uint64_t c8;
    memcpy(&c8, p, 8);
    int nd = digit_prefix_len8(c8);
    if (nd == 8) {
      mant = mant * 100000000ull + swar8(c8);
      digits += 8;
      p += 8;
      continue;
    }
    if (nd > 0) {
      int s = 8 * (8 - nd);  // s in [8, 56]: both shifts below are defined
      uint64_t shifted =
          (c8 << s) | (0x3030303030303030ull >> (64 - s));
      mant = mant * kPow10u[nd] + swar8(shifted);
      digits += nd;
      p += nd;
    }
    return digits;
  }
  while (p < end && *p >= '0' && *p <= '9') {
    mant = mant * 10ull + static_cast<uint64_t>(*p - '0');
    ++digits;
    ++p;
  }
  return digits;
}

// float32 boundary clamp, identical to the Python side's
// runtime/vectorizer.clamp_f32: finite doubles beyond float32 range store
// as +/-FLT_MAX instead of overflowing to inf (inf would poison device
// state); parity pinned by tests/test_parser_fuzz.py.
inline float to_f32_clamped(double v) {
  if (v > 3.4028234663852886e38) return 3.4028234663852886e38f;
  if (v < -3.4028234663852886e38) return -3.4028234663852886e38f;
  return static_cast<float>(v);
}

struct Cursor {
  const char* p;
  const char* end;
};

inline void skip_ws(Cursor& c) {
  // JSON's own whitespace set (what json.loads allows BETWEEN tokens)
  while (c.p < c.end && (*c.p == ' ' || *c.p == '\t' || *c.p == '\n' ||
                         *c.p == '\r'))
    ++c.p;
}

// Python str.strip() whitespace (ASCII subset): what the codec strips off
// the EDGES of a line before json.loads (DataInstance.from_json)
inline bool is_edge_ws(char ch) {
  return ch == ' ' || ch == '\t' || ch == '\r' || ch == '\f' ||
         ch == '\v' || (ch >= '\x1c' && ch <= '\x1f');
}

// JSON-number parse: [-]digits[.digits][e[±]dd]. Falls back to strtod when
// the mantissa exceeds 19 digits or the syntax is unusual; rejects
// NaN/Infinity (parity with DataInstance.is_valid).
inline bool parse_number(Cursor& c, double* out) {
  const char* p = c.p;
  const char* end = c.end;
  if (p >= end) return false;
  // branchless sign consume: random signs in numeric streams would
  // mispredict a conditional ++p roughly every other number. A leading
  // '+' stays invalid (json.loads parity): it fails the digit check below.
  bool neg = (*p == '-');
  p += neg;
  // strict JSON grammar: the integer part needs >= 1 digit and no
  // leading zero — ".5", "-.5", "01", "+1" are json.loads drops. The
  // next-byte load is guarded by a (predictable) bounds branch; the digit
  // compares stay branchless ('0' leads ~half of sub-1 magnitudes).
  if (p >= end || *p < '0' || *p > '9') return false;
  char c1 = (p + 1 < end) ? p[1] : '\0';
  if ((*p == '0') & (c1 >= '0') & (c1 <= '9')) return false;
  uint64_t mant = 0;
  int digits = 0;
  int frac = 0;
  // One-window fast path for the dominant shape "d.f{1..6}" (one integer
  // digit, '.' and up to six fraction digits all inside one 8-byte load):
  // classifies the window once instead of two digit-run calls.
  if (end - p >= 8) {
    uint64_t c8;
    memcpy(&c8, p, 8);
    uint64_t t = c8 ^ 0x3030303030303030ull;
    uint64_t nd = ((t + 0x7676767676767676ull) | t) & 0x8080808080808080ull;
    if ((nd & 0x000000000000FF00ull) && !(nd & 0xFFull) &&
        ((c8 >> 8) & 0xFFull) == '.') {
      uint64_t rest = nd >> 16;  // non-digits among fraction bytes 2..7
      int fr = rest ? static_cast<int>(__builtin_ctzll(rest)) >> 3 : 6;
      bool full_window = (fr == 6);
      // a full window might truncate a longer fraction: only take the fast
      // path when the byte after the window cannot extend the number.
      // fr == 0 ("1.,") falls through to the slow path, which rejects a
      // dot with no fraction digits (json.loads parity).
      if (fr > 0)
      if (!full_window ||
          (end - p > 8 && !(p[8] >= '0' && p[8] <= '9') && p[8] != '.') ||
          end - p == 8) {
        uint64_t d0 = c8 & 0x0Full;
        if (fr > 0) {
          int s = 8 * (8 - fr);
          uint64_t shifted =
              ((c8 >> 16) << s) | (0x3030303030303030ull >> (64 - s));
          mant = d0 * kPow10u[fr] + swar8(shifted);
        } else {
          mant = d0;
        }
        digits = 1 + fr;
        frac = fr;
        p += 2 + fr;
        goto have_mantissa;
      }
    }
  }
  digits = parse_digit_run(p, end, mant);
  frac = 0;
  if (p < end && *p == '.') {
    ++p;
    frac = parse_digit_run(p, end, mant);
    if (frac == 0) return false;  // "1." is a json.loads drop
    digits += frac;
  }
have_mantissa:;
  if (digits == 0 || digits > 19) {
    // empty ("-", ".") or precision/overflow-risky: defer to strtod
    char* endp = nullptr;
    double v = strtod(c.p, &endp);
    if (endp == c.p || endp > c.end) return false;
    if (!std::isfinite(v)) return false;
    c.p = endp;
    *out = v;
    return true;
  }
  int exp10 = -frac;
  if (p < end && (*p == 'e' || *p == 'E')) {
    ++p;
    bool eneg = false;
    if (p < end && (*p == '-' || *p == '+')) {
      eneg = (*p == '-');
      ++p;
    }
    int e = 0, edigs = 0;
    while (p < end && *p >= '0' && *p <= '9' && edigs < 6) {
      e = e * 10 + (*p - '0');
      ++edigs;
      ++p;
    }
    if (edigs == 0) return false;
    exp10 += eneg ? -e : e;
  }
  double v = static_cast<double>(mant);
  if (exp10 > 0) {
    v = (exp10 > 22) ? v * std::pow(10.0, exp10) : v * kPow10[exp10];
  } else if (exp10 < 0) {
    v = (exp10 < -22) ? v / std::pow(10.0, -exp10) : v / kPow10[-exp10];
  }
  if (!std::isfinite(v)) return false;
  c.p = p;
  // branchless sign application (same misprediction argument as above)
  uint64_t vb;
  memcpy(&vb, &v, 8);
  vb ^= static_cast<uint64_t>(neg) << 63;
  memcpy(out, &vb, 8);
  return true;
}

// Parse a JSON array of numbers into dst (cap n); *count <- #parsed.
// Cursor must sit on '['. Non-numeric elements => false (fallback).
// The element loop is specialized for the dominant separators — "', '"
// between elements, none around the brackets — with a full skip_ws
// fallback for any other JSON whitespace arrangement.
inline bool parse_num_array(Cursor& c, float* dst, int cap, int* count) {
  if (c.p >= c.end || *c.p != '[') return false;
  ++c.p;
  int n = 0;
  skip_ws(c);
  if (c.p < c.end && *c.p == ']') {
    ++c.p;
    *count = 0;
    return true;
  }
  // Fast lane for the dominant serialized-float shape: "[-]d.dddddd"
  // elements separated by "', '" (what %.6f streams emit). The win over
  // parse_number is the pointer-advance chain: the next element's start
  // depends only on the sign byte (fixed width otherwise), not on the
  // digit-run classify (ctz) of the current one, so the CPU overlaps
  // several elements' parses. Bit-identical math to the one-window fast
  // path (same mant construction, same kPow10 divide); any other shape
  // falls through to the general loop with the element unconsumed.
  while (c.end - c.p >= 11) {
    const char* e = c.p;
    bool eneg = (*e == '-');
    e += eneg;
    uint64_t c8;
    memcpy(&c8, e, 8);
    uint64_t t = c8 ^ 0x3030303030303030ull;
    uint64_t ndm = ((t + 0x7676767676767676ull) | t) & 0x8080808080808080ull;
    // exactly byte 1 non-digit (and it must be '.'): d . d d d d d d
    if (ndm != 0x8000ull || ((c8 >> 8) & 0xFFull) != '.') break;
    char sep = e[8];
    if (sep != ',' && sep != ']') break;  // longer fraction / exp / ws
    uint64_t d0 = c8 & 0x0Full;
    uint64_t shifted = ((c8 >> 16) << 16) | (0x3030303030303030ull >> 48);
    uint64_t mant = d0 * kPow10u[6] + swar8(shifted);
    double v = static_cast<double>(mant) / kPow10[6];
    uint64_t vb;
    memcpy(&vb, &v, 8);
    vb ^= static_cast<uint64_t>(eneg) << 63;
    memcpy(&v, &vb, 8);
    if (n < cap) dst[n] = to_f32_clamped(v);
    ++n;
    if (sep == ']') {
      c.p = e + 9;
      *count = (n < cap) ? n : cap;
      return true;
    }
    c.p = e + 9;
    if (c.p < c.end && *c.p == ' ') ++c.p;
    if (c.p < c.end && (*c.p == ' ' || *c.p == '\t' || *c.p == '\n' ||
                        *c.p == '\r'))
      skip_ws(c);
  }
  while (c.p < c.end) {
    double v;
    if (!parse_number(c, &v)) return false;
    if (n < cap) dst[n] = to_f32_clamped(v);
    ++n;
    if (c.p >= c.end) return false;
    char ch = *c.p;
    if (ch == ',') {
      ++c.p;
      if (c.p < c.end && *c.p == ' ') ++c.p;
      if (c.p < c.end && (*c.p == ' ' || *c.p == '\t' || *c.p == '\n' ||
                          *c.p == '\r'))
        skip_ws(c);
      continue;
    }
    if (ch == ']') {
      ++c.p;
      *count = (n < cap) ? n : cap;
      return true;
    }
    skip_ws(c);
    if (c.p < c.end && *c.p == ',') {
      ++c.p;
      skip_ws(c);
      continue;
    }
    if (c.p < c.end && *c.p == ']') {
      ++c.p;
      *count = (n < cap) ? n : cap;
      return true;
    }
    return false;
  }
  return false;
}

// --- single-pass structural walk ------------------------------------------

// Known keys, matched by (length, bytes).
enum KeyId {
  KEY_NUMERICAL,
  KEY_DISCRETE,
  KEY_CATEGORICAL,
  KEY_METADATA,
  KEY_TARGET,
  KEY_OPERATION,
  KEY_UNKNOWN,
};

inline KeyId match_key(const char* k, size_t len) {
  switch (len) {
    case 17:
      if (memcmp(k, "numericalFeatures", 17) == 0) return KEY_NUMERICAL;
      break;
    case 16:
      if (memcmp(k, "discreteFeatures", 16) == 0) return KEY_DISCRETE;
      break;
    case 19:
      if (memcmp(k, "categoricalFeatures", 19) == 0) return KEY_CATEGORICAL;
      break;
    case 8:
      if (memcmp(k, "metadata", 8) == 0) return KEY_METADATA;
      break;
    case 6:
      if (memcmp(k, "target", 6) == 0) return KEY_TARGET;
      break;
    case 9:
      if (memcmp(k, "operation", 9) == 0) return KEY_OPERATION;
      break;
    default:
      break;
  }
  return KEY_UNKNOWN;
}

// Skip a string; cursor sits on the opening '"'. Handles escapes.
inline bool ishex(char h) {
  return (h >= '0' && h <= '9') || (h >= 'a' && h <= 'f') ||
         (h >= 'A' && h <= 'F');
}

// First byte in [p, end) that is a backslash or a raw control char
// (< 0x20), or ``end`` — SWAR, 8 bytes per iteration. The two classes are
// exactly what interrupts a plain JSON string span: '\\' starts an escape
// and controls must be escaped (json.loads parity).
template <bool kWithQuote>
inline const char* scan_span_impl(const char* p, const char* end) {
  while (end - p >= 8) {
    uint64_t w;
    memcpy(&w, p, 8);
    // zero-byte detector on w ^ '\\' -> flags bytes equal to backslash
    uint64_t x = w ^ 0x5C5C5C5C5C5C5C5CULL;
    uint64_t hit =
        (x - 0x0101010101010101ULL) & ~x & 0x8080808080808080ULL;
    // byte < 0x20: (b - 0x20) borrows into the high bit AND b < 0x80
    hit |= (w - 0x2020202020202020ULL) & ~w & 0x8080808080808080ULL;
    if (kWithQuote) {
      uint64_t xq = w ^ 0x2222222222222222ULL;  // zero byte where '"'
      hit |= (xq - 0x0101010101010101ULL) & ~xq & 0x8080808080808080ULL;
    }
    if (hit) return p + (__builtin_ctzll(hit) >> 3);
    p += 8;
  }
  for (; p < end; ++p) {
    unsigned char ch = static_cast<unsigned char>(*p);
    if (ch == '\\' || ch < 0x20 || (kWithQuote && ch == '"')) return p;
  }
  return end;
}

// First byte in [p, end) that is a backslash or a raw control char
// (< 0x20), or ``end`` — what interrupts a plain JSON string span whose
// closing quote is already known.
inline const char* scan_special(const char* p, const char* end) {
  return scan_span_impl<false>(p, end);
}

// Same scan, additionally stopping at '"': finds the closing quote OR
// the first special byte in ONE pass (memchr-then-rescan costs two
// passes plus a library call's setup at ~10-byte category strings).
inline const char* scan_quote_or_special(const char* p, const char* end) {
  return scan_span_impl<true>(p, end);
}

// Strict-JSON string scan (json.loads parity): raw control characters
// (< 0x20) must be escaped, and only the JSON escapes \" \\ \/ \b \f \n
// \r \t \uXXXX are valid. Leaves the cursor after the closing quote.
// Fast shape: memchr to the candidate closing quote, one SWAR pass over
// the span; the per-escape state machine only runs from the first
// backslash onward (strings in this schema rarely contain any).
inline bool skip_string(Cursor& c) {
  ++c.p;  // opening quote
  while (c.p < c.end) {
    const char* q =
        static_cast<const char*>(memchr(c.p, '"', c.end - c.p));
    if (!q) return false;
    const char* s = scan_special(c.p, q);
    if (s < q && static_cast<unsigned char>(*s) < 0x20) return false;
    if (s == q) {  // clean span: q really is the closing quote
      c.p = q + 1;
      return true;
    }
    // escape at s: validate it, then rescan from after it (the escaped
    // char may itself be the quote memchr found)
    if (s + 1 >= c.end) return false;
    char e = s[1];
    if (e == '"' || e == '\\' || e == '/' || e == 'b' || e == 'f' ||
        e == 'n' || e == 'r' || e == 't') {
      c.p = s + 2;
      continue;
    }
    if (e == 'u') {
      if (s + 6 > c.end || !ishex(s[2]) || !ishex(s[3]) || !ishex(s[4]) ||
          !ishex(s[5]))
        return false;
      c.p = s + 6;
      continue;
    }
    return false;  // invalid escape: json.loads drops the line
  }
  return false;
}

// Structural skip of an array/object value: tracks bracket depth and skips
// strings properly, so unknown-key values containing ']'/'}' inside strings
// or nested containers don't derail the walk.
inline bool skip_composite(Cursor& c) {
  int depth = 0;
  while (c.p < c.end) {
    char ch = *c.p;
    if (ch == '"') {
      if (!skip_string(c)) return false;
      continue;
    }
    if (ch == '[' || ch == '{') {
      ++depth;
    } else if (ch == ']' || ch == '}') {
      --depth;
      if (depth == 0) {
        ++c.p;
        return true;
      }
      if (depth < 0) return false;
    }
    ++c.p;
  }
  return false;
}

// Strictly validate a value we do not extract (json.loads parity).
// Returns 1 valid-and-consumed, 0 invalid, 2 composite: bracket-matched
// and strings validated, but contents not fully validated — the caller
// defers such lines to the Python codec, which decides exactly.
inline int check_value(Cursor& c) {
  skip_ws(c);
  if (c.p >= c.end) return 0;
  char ch = *c.p;
  if (ch == '"') return skip_string(c) ? 1 : 0;
  if (ch == '[' || ch == '{') return skip_composite(c) ? 2 : 0;
  if (ch == 't') {
    if (c.end - c.p >= 4 && strncmp(c.p, "true", 4) == 0) {
      c.p += 4;
      return 1;
    }
    return 0;
  }
  if (ch == 'f') {
    if (c.end - c.p >= 5 && strncmp(c.p, "false", 5) == 0) {
      c.p += 5;
      return 1;
    }
    return 0;
  }
  if (ch == 'n') {
    if (c.end - c.p >= 4 && strncmp(c.p, "null", 4) == 0) {
      c.p += 4;
      return 1;
    }
    return 0;
  }
  double v;
  Cursor t{c.p, c.end};
  if (parse_number(t, &v)) {
    c.p = t.p;
    return 1;
  }
  // starts like a number but failed the strict parse: overflow to inf
  // (json.loads keeps it — and is_valid never inspects ignored keys) or
  // grammar junk (json.loads drops). Either way the Python codec is the
  // authority: defer instead of dropping a possibly-valid record.
  if (ch == '-' || (ch >= '0' && ch <= '9')) return 2;
  return 0;
}

// Parse one line into output row i. xi is only defined when *validi == 1
// (features zero-padded to dim); dropped/fallback rows leave xi
// unspecified — consumers mask them out (valid != 1) or reparse via the
// Python codec, so the zero-fill is deferred to the success path instead
// of a 112-byte memset per line.
inline void parse_one_line(const char* p, const char* line_end, int dim,
                           float* xi, float* yi, unsigned char* opi,
                           unsigned char* validi) {
  *yi = 0.0f;
  *opi = 0;
  *validi = 0;

  const char* q = p;
  while (q < line_end && is_edge_ws(*q)) ++q;
  long ll = line_end - q;
  if (ll == 0) return;                                            // blank
  if ((ll == 3 && strncmp(q, "EOS", 3) == 0) ||
      (ll == 5 && strncmp(q, "\"EOS\"", 5) == 0))
    return;                                                       // EOS
  if (*q != '{') return;                                          // garbage

  // Whole-line schema template: the dominant serialized record shape
  // {"numericalFeatures": [ ... ], "target": N, "operation": "training"}
  // short-circuits the general key walk (three key scans, match_key
  // dispatch, member-separator machinery) into three memcmps around the
  // array fast lane. Any mismatch falls through to the general walk,
  // which re-parses the line from scratch — semantics are identical, the
  // template is only a faster route for lines json.loads would accept.
  {
    static const char kHead[] = "{\"numericalFeatures\": ";
    static const char kTgt[] = ", \"target\": ";
    static const char kOp[] = ", \"operation\": \"training\"}";
    const long kHeadLen = sizeof(kHead) - 1;   // 22
    const long kTgtLen = sizeof(kTgt) - 1;     // 12
    const long kOpLen = sizeof(kOp) - 1;       // 26
    if (ll > kHeadLen + kTgtLen + kOpLen &&
        memcmp(q, kHead, kHeadLen) == 0 && q[kHeadLen] == '[') {
      Cursor t{q + kHeadLen, line_end};
      int cnt = 0;
      if (parse_num_array(t, xi, dim, &cnt) && cnt > 0 &&
          line_end - t.p >= kTgtLen && memcmp(t.p, kTgt, kTgtLen) == 0) {
        t.p += kTgtLen;
        double tv;
        if (parse_number(t, &tv) && line_end - t.p >= kOpLen &&
            memcmp(t.p, kOp, kOpLen) == 0) {
          t.p += kOpLen;
          while (t.p < line_end && is_edge_ws(*t.p)) ++t.p;
          if (t.p == line_end) {
            if (cnt < dim)
              memset(xi + cnt, 0,
                     sizeof(float) * static_cast<size_t>(dim - cnt));
            *yi = to_f32_clamped(tv);
            *opi = 0;
            *validi = 1;
            return;
          }
        }
      }
    }
  }

  Cursor c{q + 1, line_end};
  // numerical parses INLINE into xi[0..] during the walk (it always packs
  // first, DataPointParser.scala:20-33 ordering); discrete parses inline at
  // xi[num_cnt..] when numerical was already seen, else its cursor is
  // recorded and parsed after the walk. Inline parsing avoids a second
  // structural pass over the array bytes (skip_composite), which dominated
  // the per-line cost.
  Cursor disc_c{nullptr, line_end};
  bool ok = true;
  bool have_target = false, have_op = false;
  double target = 0.0;
  int op_val = -1;
  int num_cnt = -1;  // -1 = numericalFeatures not seen yet
  int disc_cnt = 0;
  bool disc_seen = false;
  bool closed = false;  // saw the object's closing '}'
  bool first = true;

  while (ok && c.p < c.end) {
    skip_ws(c);
    if (c.p < c.end && *c.p == '}') {
      ++c.p;
      closed = true;
      break;
    }
    // strict member separation (json.loads parity): exactly one comma
    // between members, none before the first or after the last
    if (!first) {
      if (c.p >= c.end || *c.p != ',') {
        ok = false;
        break;
      }
      ++c.p;
      skip_ws(c);
      if (c.p < c.end && *c.p == '}') {
        ok = false;  // trailing comma
        break;
      }
    }
    first = false;
    if (c.p >= c.end || *c.p != '"') {
      ok = false;
      break;
    }
    const char* ks = c.p + 1;
    if (!skip_string(c)) {
      ok = false;
      break;
    }
    const char* ke = c.p - 1;  // closing quote
    skip_ws(c);
    if (c.p >= c.end || *c.p != ':') {
      ok = false;
      break;
    }
    ++c.p;
    skip_ws(c);
    switch (match_key(ks, ke - ks)) {
      case KEY_CATEGORICAL:
      case KEY_METADATA:
        *validi = 2;  // python fallback (hashing / nesting)
        return;
      case KEY_NUMERICAL: {
        if (num_cnt >= 0) {
          // duplicate array key: inline packing can no longer reproduce the
          // codec's last-key-wins layout — defer the line to the Python
          // fallback, which parses it identically to DataInstance.from_json
          *validi = 2;
          return;
        }
        int cnt = 0;
        if (!parse_num_array(c, xi, dim, &cnt)) {
          ok = false;  // malformed / non-numeric array: drop
          break;
        }
        num_cnt = cnt;
        break;
      }
      case KEY_DISCRETE:
        if (disc_seen) {
          *validi = 2;  // duplicate key: Python-fallback (see above)
          return;
        }
        disc_seen = true;
        if (num_cnt >= 0) {
          int cnt = 0;
          if (!parse_num_array(c, xi + num_cnt, dim - num_cnt, &cnt)) {
            ok = false;
            break;
          }
          disc_cnt = cnt;
        } else {
          // deferred array: bracket-matched here, strictly parsed after
          // the walk by parse_num_array (non-array values fail there,
          // matching the codec's element-coercion drop)
          disc_c.p = c.p;
          if (c.p < c.end && *c.p == '[') {
            if (!skip_composite(c)) ok = false;
          } else {
            int r = check_value(c);
            if (r == 0) ok = false;
            // a valid non-array value fails parse_num_array later: drop,
            // same as the codec's per-element float() coercion
          }
        }
        break;
      case KEY_TARGET: {
        Cursor t{c.p, line_end};
        if (parse_number(t, &target)) {
          have_target = true;
          c.p = t.p;
        } else if (c.end - c.p >= 4 && strncmp(c.p, "null", 4) == 0) {
          // explicit null: the codec treats it as absent (last key wins)
          have_target = false;
          target = 0.0;
          c.p += 4;
        } else {
          // string/boolean/other: the codec's float() coercion decides
          // (float("0") keeps, float("x") drops) — defer to Python
          *validi = 2;
          return;
        }
        break;
      }
      case KEY_OPERATION: {
        have_op = true;
        op_val = -1;  // duplicate keys: last one wins, like the codec
        if (c.p < c.end && *c.p == '"') {
          const char* vs = c.p + 1;
          if (!skip_string(c)) {
            ok = false;
            break;
          }
          const char* ve = c.p - 1;
          long vl = ve - vs;
          if (memchr(vs, '\\', vl) != nullptr) {
            *validi = 2;  // escaped spelling: let Python decode+compare
            return;
          }
          // EXACT match (is_valid drops any other operation string)
          if (vl == 11 && strncmp(vs, "forecasting", 11) == 0) {
            op_val = 1;
          } else if (vl == 8 && strncmp(vs, "training", 8) == 0) {
            op_val = 0;
          }
        } else {
          int r = check_value(c);
          if (r == 0) {
            ok = false;
          } else if (r == 2) {
            *validi = 2;
            return;
          }
          // valid non-string operation: op_val stays -1 -> dropped below
        }
        break;
      }
      case KEY_UNKNOWN: {
        int r = check_value(c);
        if (r == 0) {
          ok = false;
        } else if (r == 2) {
          *validi = 2;  // composite under an unknown key: Python decides
          return;
        }
        break;
      }
    }
  }
  // strict-JSON parity with the Python codec: a truncated object (no
  // closing '}') or trailing non-whitespace after it is a drop. The tail
  // may carry anything str.strip() removes (CRLF files, formfeeds, ...).
  if (!ok || !closed) return;
  while (c.p < c.end && is_edge_ws(*c.p)) ++c.p;
  if (c.p < c.end) return;

  int pos = num_cnt > 0 ? num_cnt : 0;
  if (disc_c.p) {
    // discrete appeared before numerical in the line: parse it now so it
    // still packs after the numerical block
    int cnt = 0;
    if (parse_num_array(disc_c, xi + pos, dim - pos, &cnt)) {
      disc_cnt = cnt;
    } else {
      return;
    }
  }
  bool any = num_cnt > 0 || disc_cnt > 0;
  if (have_target) *yi = to_f32_clamped(target);
  if (have_op) {
    if (op_val < 0) return;  // unknown operation: drop
    *opi = static_cast<unsigned char>(op_val);
  }
  if (any) {
    // deferred zero-fill (see above): only the unfilled tail, only on keep
    int filled = pos + disc_cnt;
    if (filled < dim)
      memset(xi + filled, 0, sizeof(float) * static_cast<size_t>(dim - filled));
    *validi = 1;
  }
}

// --- sparse (padded-COO) line parse --------------------------------------
//
// The sparse twin of parse_one_line: dense numerical/discrete values keep
// their positional slots (only nonzero values occupy a COO slot, exactly
// like SparseVectorizer.vectorize), categorical strings hash with
// zlib-CRC32 of "{i}={cat}" into [dense_budget, dense_budget + hash_space)
// with the same sign rule. Lines whose category strings contain escapes
// (the hash must cover the DECODED bytes) defer to the Python codec.

// slice-by-8 CRC-32 (zlib polynomial): 8 bytes per iteration through 8
// derived tables — category hashing is a large share of the sparse parse
struct Crc8Tables {
  uint32_t t[8][256];
  Crc8Tables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1u) ? 0xEDB88320u ^ (c >> 1) : (c >> 1);
      t[0][i] = c;
    }
    for (int s = 1; s < 8; ++s)
      for (uint32_t i = 0; i < 256; ++i)
        t[s][i] = t[0][t[s - 1][i] & 0xFFu] ^ (t[s - 1][i] >> 8);
  }
};

static const Crc8Tables CRC_T;  // namespace scope: no per-call init guard

inline uint32_t crc32_zlib(const char* data, size_t len, uint32_t seed) {
  const Crc8Tables& T = CRC_T;
  const uint32_t* t0 = T.t[0];
  uint32_t c = seed ^ 0xFFFFFFFFu;
  while (len >= 8) {
    uint32_t lo, hi;
    memcpy(&lo, data, 4);
    memcpy(&hi, data + 4, 4);
    lo ^= c;
    c = T.t[7][lo & 0xFFu] ^ T.t[6][(lo >> 8) & 0xFFu] ^
        T.t[5][(lo >> 16) & 0xFFu] ^ T.t[4][lo >> 24] ^
        T.t[3][hi & 0xFFu] ^ T.t[2][(hi >> 8) & 0xFFu] ^
        T.t[1][(hi >> 16) & 0xFFu] ^ T.t[0][hi >> 24];
    data += 8;
    len -= 8;
  }
  for (size_t i = 0; i < len; ++i)
    c = t0[(c ^ static_cast<unsigned char>(data[i])) & 0xFFu] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// Exact x % d via Lemire's fastmod (two multiplies instead of a
// hardware divide); d is fixed for a whole parse call.
struct FastMod {
  uint64_t m;
  uint32_t d;
  explicit FastMod(uint32_t d_) : m(~0ULL / d_ + 1), d(d_) {}
  inline uint32_t mod(uint32_t x) const {
    uint64_t low = m * x;
    return static_cast<uint32_t>(
        (static_cast<unsigned __int128>(low) * d) >> 64);
  }
};

// Categorical string items (cursor just past '['): hash each plain
// string into a COO slot. Returns 0 ok (cursor past ']'), 1 malformed
// (json.loads drops the line), 2 Python fallback (escapes). Shared by
// the general key walk and the whole-line schema template.
inline int parse_cat_items(Cursor& c, int dense_budget,
                           const FastMod& hash_mod, int max_nnz,
                           int32_t* ii, float* vv, int& k, bool& any) {
  skip_ws(c);
  long cat_i = 0;
  if (c.p < c.end && *c.p == ']') { ++c.p; return 0; }
  while (c.p < c.end) {
    if (*c.p != '"') return 2;  // non-string element
    const char* vs = c.p + 1;
    const char* ve = scan_quote_or_special(vs, c.end);
    if (ve >= c.end) return 1;  // unterminated
    if (*ve != '"') {
      if (*ve == '\\') return 2;  // escaped content: Python decodes
      return 1;  // raw control char: json.loads drops the line
    }
    c.p = ve + 1;
    if (k < max_nnz) {
      // CRC state after the "{i}=" prefix depends only on i: cache it
      // (the prefixes repeat every line). snprintf here once measured
      // ~5 us/line; the hand-rolled digits remain for the uncached tail
      uint32_t h;
      static thread_local uint32_t prefix_crc[64];
      static thread_local bool prefix_have[64];
      if (cat_i < 64 && prefix_have[cat_i]) {
        h = prefix_crc[cat_i];
      } else {
        char prefix[24];
        int plen = 0;
        char tmp[20];
        int tl = 0;
        long t = cat_i;
        do {
          tmp[tl++] = static_cast<char>('0' + (t % 10));
          t /= 10;
        } while (t);
        while (tl) prefix[plen++] = tmp[--tl];
        prefix[plen++] = '=';
        h = crc32_zlib(prefix, plen, 0);
        if (cat_i < 64) {
          prefix_crc[cat_i] = h;
          prefix_have[cat_i] = true;
        }
      }
      h = crc32_zlib(vs, ve - vs, h);
      ii[k] = static_cast<int32_t>(dense_budget + hash_mod.mod(h));
      vv[k] = ((h >> 1) & 1u) == 0 ? 1.0f : -1.0f;
      ++k;
    }
    any = true;  // presence (even past the max_nnz cap)
    ++cat_i;
    skip_ws(c);
    if (c.p < c.end && *c.p == ',') { ++c.p; skip_ws(c); continue; }
    if (c.p < c.end && *c.p == ']') { ++c.p; return 0; }
    return 1;
  }
  return 1;
}

// Numeric array items into COO slots (cursor just past '['): nonzero
// values at positions < dense_budget take slots; the positional cursor
// advances regardless. Returns 0 ok, 1 malformed. Shared by the general
// walk and the schema template.
inline int parse_num_items_coo(Cursor& c, int dense_budget, int max_nnz,
                               int32_t* ii, float* vv, int& k, long& pos,
                               bool& any) {
  skip_ws(c);
  if (c.p < c.end && *c.p == ']') { ++c.p; return 0; }
  while (c.p < c.end) {
    double v;
    if (!parse_number(c, &v)) return 1;
    any = true;  // validity = feature PRESENCE (is_valid counts the
                 // raw lists), not whether a nonzero slot was stored
    if (pos < dense_budget && v != 0.0 && k < max_nnz) {
      ii[k] = static_cast<int32_t>(pos);
      vv[k] = to_f32_clamped(v);
      ++k;
    }
    if (pos < dense_budget) ++pos;
    if (c.p >= c.end) return 1;
    char ch = *c.p;
    if (ch == ',') {
      ++c.p;
      if (c.p < c.end && *c.p == ' ') ++c.p;
      skip_ws(c);
      continue;
    }
    if (ch == ']') { ++c.p; return 0; }
    skip_ws(c);
    if (c.p < c.end && *c.p == ',') { ++c.p; skip_ws(c); continue; }
    if (c.p < c.end && *c.p == ']') { ++c.p; return 0; }
    return 1;
  }
  return 1;
}

// Parse one line into padded-COO row i. Same valid semantics as
// parse_one_line (0 drop, 1 keep, 2 Python fallback).
inline void parse_one_line_sparse(const char* p, const char* line_end,
                                  int dense_budget, long hash_space,
                                  const FastMod& hash_mod,
                                  int max_nnz, int32_t* ii, float* vv,
                                  float* yi, unsigned char* opi,
                                  unsigned char* validi) {
  *yi = 0.0f;
  *opi = 0;
  *validi = 0;

  const char* q = p;
  while (q < line_end && is_edge_ws(*q)) ++q;
  long ll = line_end - q;
  if (ll == 0) return;
  if ((ll == 3 && strncmp(q, "EOS", 3) == 0) ||
      (ll == 5 && strncmp(q, "\"EOS\"", 5) == 0))
    return;
  if (*q != '{') return;

  // Whole-line schema template: the dominant sparse record shape
  // {"numericalFeatures": [..], "categoricalFeatures": [..],
  //  "target": N, "operation": "training"} short-circuits the key walk
  // (four key scans + member machinery) into four memcmps around the
  // shared item loops. Any mismatch falls through to the general walk,
  // which re-parses from scratch (ii/vv scribbles are only read when
  // *validi == 1) — semantics identical, the template is only a faster
  // route for lines json.loads would accept.
  {
    static const char kHead[] = "{\"numericalFeatures\": ";
    static const char kCat[] = ", \"categoricalFeatures\": ";
    static const char kTgt[] = ", \"target\": ";
    static const char kOp[] = ", \"operation\": \"training\"}";
    const long kHeadLen = sizeof(kHead) - 1;
    const long kCatLen = sizeof(kCat) - 1;
    const long kTgtLen = sizeof(kTgt) - 1;
    const long kOpLen = sizeof(kOp) - 1;
    if (ll > kHeadLen + kCatLen + kTgtLen + kOpLen &&
        hash_space > 0 && hash_space <= 0xFFFFFFFFL &&
        memcmp(q, kHead, kHeadLen) == 0 && q[kHeadLen] == '[') {
      Cursor t{q + kHeadLen + 1, line_end};
      int tk = 0;
      long tpos = 0;
      bool tany = false;
      if (parse_num_items_coo(t, dense_budget, max_nnz, ii, vv, tk, tpos,
                              tany) == 0 &&
          line_end - t.p > kCatLen &&
          memcmp(t.p, kCat, kCatLen) == 0 && t.p[kCatLen] == '[') {
        t.p += kCatLen + 1;
        int rc = parse_cat_items(t, dense_budget, hash_mod, max_nnz, ii,
                                 vv, tk, tany);
        if (rc == 2) { *validi = 2; return; }  // same verdict either route
        if (rc == 0 && line_end - t.p >= kTgtLen &&
            memcmp(t.p, kTgt, kTgtLen) == 0) {
          t.p += kTgtLen;
          double tv;
          if (parse_number(t, &tv) && line_end - t.p >= kOpLen &&
              memcmp(t.p, kOp, kOpLen) == 0) {
            t.p += kOpLen;
            while (t.p < line_end && is_edge_ws(*t.p)) ++t.p;
            if (t.p == line_end) {
              for (int z = tk; z < max_nnz; ++z) { ii[z] = 0; vv[z] = 0.0f; }
              *yi = to_f32_clamped(tv);
              *opi = 0;
              *validi = tany ? 1 : 0;
              return;
            }
          }
        }
      }
    }
  }

  Cursor c{q + 1, line_end};
  bool ok = true;
  bool have_target = false, have_op = false;
  double target = 0.0;
  int op_val = -1;
  int k = 0;        // COO slots used
  long pos = 0;     // dense positional cursor
  bool num_seen = false, disc_seen = false, cat_seen = false;
  bool any = false;
  bool closed = false;
  bool first = true;

  while (ok && c.p < c.end) {
    skip_ws(c);
    if (c.p < c.end && *c.p == '}') {
      ++c.p;
      closed = true;
      break;
    }
    if (!first) {
      if (c.p >= c.end || *c.p != ',') { ok = false; break; }
      ++c.p;
      skip_ws(c);
      if (c.p < c.end && *c.p == '}') { ok = false; break; }
    }
    first = false;
    if (c.p >= c.end || *c.p != '"') { ok = false; break; }
    const char* ks = c.p + 1;
    if (!skip_string(c)) { ok = false; break; }
    const char* ke = c.p - 1;
    skip_ws(c);
    if (c.p >= c.end || *c.p != ':') { ok = false; break; }
    ++c.p;
    skip_ws(c);
    switch (match_key(ks, ke - ks)) {
      case KEY_METADATA:
        *validi = 2;
        return;
      case KEY_NUMERICAL:
      case KEY_DISCRETE: {
        bool dup = (match_key(ks, ke - ks) == KEY_NUMERICAL)
                       ? num_seen : disc_seen;
        if (dup) { *validi = 2; return; }
        if (match_key(ks, ke - ks) == KEY_NUMERICAL) num_seen = true;
        else disc_seen = true;
        // ordering parity: SparseVectorizer packs numerical, then
        // discrete, then categorical REGARDLESS of JSON key order; any
        // line whose keys arrive out of that order defers to Python so
        // the COO slot order (and the max_nnz truncation set) match
        if (cat_seen ||
            (match_key(ks, ke - ks) == KEY_NUMERICAL && disc_seen &&
             pos > 0)) {
          *validi = 2;
          return;
        }
        if (c.p >= c.end || *c.p != '[') {
          int r = check_value(c);
          if (r == 0) ok = false; else if (r == 2) { *validi = 2; return; }
          break;
        }
        ++c.p;
        if (parse_num_items_coo(c, dense_budget, max_nnz, ii, vv, k, pos,
                                any) != 0)
          ok = false;
        break;
      }
      case KEY_CATEGORICAL: {
        if (cat_seen) { *validi = 2; return; }
        cat_seen = true;
        // hash_space must fit uint32 for the fastmod (and the old 32-bit
        // %); larger spaces defer to the full-precision Python hasher
        if (hash_space <= 0 || hash_space > 0xFFFFFFFFL) {
          *validi = 2;
          return;
        }
        if (c.p >= c.end || *c.p != '[') {
          int r = check_value(c);
          if (r == 0) ok = false; else if (r == 2) { *validi = 2; return; }
          break;
        }
        ++c.p;
        int rc = parse_cat_items(c, dense_budget, hash_mod, max_nnz, ii,
                                 vv, k, any);
        if (rc == 2) { *validi = 2; return; }
        if (rc != 0) ok = false;
        break;
      }
      case KEY_TARGET: {
        Cursor t{c.p, line_end};
        if (parse_number(t, &target)) {
          have_target = true;
          c.p = t.p;
        } else if (c.end - c.p >= 4 && strncmp(c.p, "null", 4) == 0) {
          have_target = false;
          target = 0.0;
          c.p += 4;
        } else {
          *validi = 2;
          return;
        }
        break;
      }
      case KEY_OPERATION: {
        have_op = true;
        op_val = -1;
        if (c.p < c.end && *c.p == '"') {
          const char* vs = c.p + 1;
          if (!skip_string(c)) { ok = false; break; }
          const char* ve = c.p - 1;
          long vl = ve - vs;
          if (memchr(vs, '\\', vl) != nullptr) { *validi = 2; return; }
          if (vl == 11 && strncmp(vs, "forecasting", 11) == 0) op_val = 1;
          else if (vl == 8 && strncmp(vs, "training", 8) == 0) op_val = 0;
        } else {
          int r = check_value(c);
          if (r == 0) ok = false;
          else if (r == 2) { *validi = 2; return; }
        }
        break;
      }
      case KEY_UNKNOWN: {
        int r = check_value(c);
        if (r == 0) ok = false;
        else if (r == 2) { *validi = 2; return; }
        break;
      }
    }
  }
  if (!ok || !closed) return;
  while (c.p < c.end && is_edge_ws(*c.p)) ++c.p;
  if (c.p < c.end) return;
  // zero-fill the unused COO slots (pad idx 0 / val 0 is inert)
  for (int z = k; z < max_nnz; ++z) { ii[z] = 0; vv[z] = 0.0f; }
  if (have_target) *yi = to_f32_clamped(target);
  if (have_op) {
    if (op_val < 0) return;
    *opi = static_cast<unsigned char>(op_val);
  }
  *validi = any ? 1 : 0;
}

// Shared multithreaded line runner: index newline offsets, then run
// ``per_line(i, line, line_end)`` over disjoint line ranges on
// std::threads (each line owns its output row; nothing is shared).
// Returns lines consumed; stores the consumed byte offset.
template <typename F>
int mt_line_runner(const char* buf, long len, int max_records,
                   int n_threads, long* bytes_consumed, F per_line) {
  std::vector<long> starts;
  starts.reserve(4096);
  const char* p = buf;
  const char* bufend = buf + len;
  while (p < bufend && static_cast<int>(starts.size()) < max_records) {
    starts.push_back(p - buf);
    const char* nl = static_cast<const char*>(memchr(p, '\n', bufend - p));
    p = nl ? nl + 1 : bufend;
  }
  const long consumed = p - buf;
  if (bytes_consumed) *bytes_consumed = consumed;
  int n = static_cast<int>(starts.size());
  if (n == 0) return 0;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;

  auto worker = [&](int lo, int hi) {
    for (int i = lo; i < hi; ++i) {
      const char* line = buf + starts[i];
      // starts[i+1]-1 lands on the '\n'; the final indexed line ends at
      // the consumed offset (== len unless max_records truncated)
      long line_len =
          ((i + 1 < n) ? starts[i + 1] - 1 : consumed) - starts[i];
      if (line_len < 0) line_len = 0;
      const char* line_end = line + line_len;
      if (line_end > bufend) line_end = bufend;
      if (line_end > line && line_end[-1] == '\n') --line_end;
      per_line(i, line, line_end);
    }
  };
  if (n_threads == 1) {
    worker(0, n);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    int chunk = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
      int lo = t * chunk;
      int hi = lo + chunk < n ? lo + chunk : n;
      if (lo >= hi) break;
      threads.emplace_back(worker, lo, hi);
    }
    for (auto& th : threads) th.join();
  }
  return n;
}

}  // namespace

extern "C" {

int omldm_parse_lines(const char* buf, long len, int dim, int max_records,
                      float* x, float* y, unsigned char* op,
                      unsigned char* valid, long* bytes_consumed) {
  const char* p = buf;
  const char* bufend = buf + len;
  int i = 0;
  while (p < bufend && i < max_records) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', bufend - p));
    const char* line_end = nl ? nl : bufend;
    parse_one_line(p, line_end, dim, x + static_cast<long>(i) * dim, y + i,
                   op + i, valid + i);
    ++i;
    p = nl ? nl + 1 : bufend;
  }
  if (bytes_consumed) *bytes_consumed = p - buf;
  return i;
}

// --- fused parse -> holdout -> stage -------------------------------------
//
// The e2e hot loop (SPMDBridge.handle_batch -> _train_rows -> _stage_rows)
// re-touches every row several times in numpy: batcher copy, holdout
// split/concatenate, stage memcpy. This entry fuses the whole per-record
// path (FlinkSpoke.scala:92-107 semantics) into the parse itself: each line
// is parsed DIRECTLY into its stage slot, the 8-of-10 holdout cycle
// (counts 8,9 of each 0-9 cycle) runs in place, and ring eviction swaps the
// evicted row into the very slot the arriving row was parsed into — the
// evicted point re-enters training at the evicting row's stream position,
// exact ArrayHoldout.append_many parity. Rare lines (Python-codec fallback,
// forecasts) return control to the caller so the hot loop stays pure C.
struct OmldmStageCtx {
  float* stage_x;       // [stage_cap, row_stride] training stage
  float* stage_y;       // [stage_cap]
  long long stage_cap;
  long long stage_n;
  float* hold_x;        // [hold_cap, row_stride] holdout ring
  float* hold_y;        // [hold_cap]
  long long hold_cap;
  long long hold_n;
  long long hold_head;  // oldest element
  long long holdout_count;  // position in the 0-9 holdout cycle
  long long row_stride;     // floats per stage/holdout row (>= n_features)
  int n_features;           // dense parse budget (row_stride - hash_dims)
  int test_enabled;
};

namespace {

// Holdout-split one training row already sitting in its stage slot.
// Returns 1 if the row stays staged (slot consumed), 0 if it moved to the
// holdout ring (slot free for reuse).
inline int stage_holdout_slot(OmldmStageCtx* ctx, float* slot, float yv) {
  long long cyc = ctx->holdout_count % 10;
  ctx->holdout_count++;
  if (ctx->test_enabled && cyc >= 8 && ctx->hold_cap > 0) {
    long long stride = ctx->row_stride;
    if (ctx->hold_n < ctx->hold_cap) {
      long long pos = (ctx->hold_head + ctx->hold_n) % ctx->hold_cap;
      memcpy(ctx->hold_x + pos * stride, slot,
             sizeof(float) * static_cast<size_t>(stride));
      ctx->hold_y[pos] = yv;
      ctx->hold_n++;
      return 0;
    }
    // ring full: swap the oldest row into this slot (it re-enters training
    // here) and store the arriving row in its place
    long long pos = ctx->hold_head;
    float* ring = ctx->hold_x + pos * stride;
    for (long long i = 0; i < stride; ++i) {
      float t = ring[i];
      ring[i] = slot[i];
      slot[i] = t;
    }
    float ty = ctx->hold_y[pos];
    ctx->hold_y[pos] = yv;
    yv = ty;
    ctx->hold_head = (ctx->hold_head + 1) % ctx->hold_cap;
  }
  ctx->stage_y[ctx->stage_n] = yv;
  ctx->stage_n++;
  return 1;
}

}  // namespace

// Parse a block of whole JSON lines straight into the staging buffers.
// Returns:
//   0  buffer fully consumed
//   1  stage full (caller launches the device step, resets stage_n, resumes)
//   2  fallback line (Python codec decides; [*special_off, +*special_len))
//   3  forecast row (features in fore_x[0..row_stride), target in *fore_y)
// *bytes_consumed is the resume offset relative to buf in all cases (for
// 2/3 it points past the special line).
int omldm_parse_stage(const char* buf, long long len, OmldmStageCtx* ctx,
                      long long* bytes_consumed, long long* special_off,
                      long long* special_len, float* fore_x, float* fore_y) {
  const char* p = buf;
  const char* bufend = buf + len;
  const long long stride = ctx->row_stride;
  const int nfeat = ctx->n_features;
  while (p < bufend) {
    if (ctx->stage_n >= ctx->stage_cap) {
      *bytes_consumed = p - buf;
      return 1;
    }
    const char* nl = static_cast<const char*>(memchr(p, '\n', bufend - p));
    const char* line_end = nl ? nl : bufend;
    const char* next = nl ? nl + 1 : bufend;
    float* slot = ctx->stage_x + ctx->stage_n * stride;
    float yv;
    unsigned char opv, validv;
    parse_one_line(p, line_end, nfeat, slot, &yv, &opv, &validv);
    if (validv == 1) {
      if (stride > nfeat)  // zero the hashed-categorical tail (slot reuse)
        memset(slot + nfeat, 0,
               sizeof(float) * static_cast<size_t>(stride - nfeat));
      if (opv == 1) {
        memcpy(fore_x, slot, sizeof(float) * static_cast<size_t>(stride));
        *fore_y = yv;
        *bytes_consumed = next - buf;
        return 3;
      }
      stage_holdout_slot(ctx, slot, yv);
    } else if (validv == 2) {
      *special_off = p - buf;
      *special_len = line_end - p;
      *bytes_consumed = next - buf;
      return 2;
    }
    p = next;
  }
  *bytes_consumed = len;
  return 0;
}

// --- fused SPARSE parse -> holdout -> stage ------------------------------
//
// The padded-COO twin of omldm_parse_stage: the sparse e2e hot loop
// (SparseSPMDBridge.ingest_file -> _consume_coo_block -> _train_sparse_rows
// -> _stage_coo) re-touched every row several times in numpy — per-block
// output allocation + concatenate in the Python parser wrapper, the vectorized
// holdout split (mask/argsort/concatenate), and the stage memcpy. This
// entry parses each line DIRECTLY into its COO stage slot, runs the 8-of-10
// holdout cycle in place against the sparse holdout ring (idx/val/y
// triple), and swaps evicted rows into the arriving row's slot — exact
// SparseHoldout.append_many + _holdout_then_stage parity, pinned by
// tests/test_sparse_spmd_bridge.py. Specials (Python-codec fallbacks AND
// forecasts — both re-enter through DataInstance.from_json -> handle_data
// exactly like the block route's special path) return control to the
// caller; the hot loop stays pure C.
struct OmldmSparseStageCtx {
  int32_t* stage_i;     // [stage_cap, max_nnz] COO index stage
  float* stage_v;       // [stage_cap, max_nnz] COO value stage
  float* stage_y;       // [stage_cap]
  long long stage_cap;
  long long stage_n;
  int32_t* hold_i;      // [hold_cap, max_nnz] holdout ring
  float* hold_v;        // [hold_cap, max_nnz]
  float* hold_y;        // [hold_cap]
  long long hold_cap;
  long long hold_n;
  long long hold_head;      // oldest element
  long long holdout_count;  // position in the 0-9 holdout cycle
  int max_nnz;
  int dense_budget;         // positional slots before the hashed region
  long long hash_space;
  int test_enabled;
};

namespace {

// Holdout-split one COO training row already sitting in its stage slot
// (the sparse form of stage_holdout_slot; same return convention).
inline int sparse_stage_holdout_slot(OmldmSparseStageCtx* ctx, int32_t* si,
                                     float* sv, float yv) {
  long long cyc = ctx->holdout_count % 10;
  ctx->holdout_count++;
  if (ctx->test_enabled && cyc >= 8 && ctx->hold_cap > 0) {
    const size_t k = static_cast<size_t>(ctx->max_nnz);
    if (ctx->hold_n < ctx->hold_cap) {
      long long pos = (ctx->hold_head + ctx->hold_n) % ctx->hold_cap;
      memcpy(ctx->hold_i + pos * static_cast<long long>(k), si,
             sizeof(int32_t) * k);
      memcpy(ctx->hold_v + pos * static_cast<long long>(k), sv,
             sizeof(float) * k);
      ctx->hold_y[pos] = yv;
      ctx->hold_n++;
      return 0;
    }
    // ring full: swap the oldest row into this slot (it re-enters training
    // at the evicting row's stream position) and store the arriving row
    long long pos = ctx->hold_head;
    int32_t* ri = ctx->hold_i + pos * static_cast<long long>(k);
    float* rv = ctx->hold_v + pos * static_cast<long long>(k);
    for (size_t i = 0; i < k; ++i) {
      int32_t ti = ri[i];
      ri[i] = si[i];
      si[i] = ti;
      float tv = rv[i];
      rv[i] = sv[i];
      sv[i] = tv;
    }
    float ty = ctx->hold_y[pos];
    ctx->hold_y[pos] = yv;
    yv = ty;
    ctx->hold_head = (ctx->hold_head + 1) % ctx->hold_cap;
  }
  ctx->stage_y[ctx->stage_n] = yv;
  ctx->stage_n++;
  return 1;
}

}  // namespace

// Parse a block of whole JSON lines straight into the COO staging buffers.
// Returns:
//   0  buffer fully consumed
//   1  stage full (caller launches the staged step, resets stage_n, resumes)
//   2  special line (codec fallback OR forecast — the caller re-parses
//      [*special_off, +*special_len) with the Python codec, whose
//      handle_data path serves forecasts and odd schemas identically to
//      the block route)
// *bytes_consumed is the resume offset relative to buf in all cases (for
// 2 it points past the special line).
int omldm_parse_stage_sparse(const char* buf, long long len,
                             OmldmSparseStageCtx* ctx,
                             long long* bytes_consumed,
                             long long* special_off,
                             long long* special_len) {
  const char* p = buf;
  const char* bufend = buf + len;
  const int k = ctx->max_nnz;
  const bool hash_fits =
      ctx->hash_space > 0 && ctx->hash_space <= 0xFFFFFFFFL;
  const FastMod hash_mod(
      hash_fits ? static_cast<uint32_t>(ctx->hash_space) : 1u);
  while (p < bufend) {
    if (ctx->stage_n >= ctx->stage_cap) {
      *bytes_consumed = p - buf;
      return 1;
    }
    const char* nl = static_cast<const char*>(memchr(p, '\n', bufend - p));
    const char* line_end = nl ? nl : bufend;
    const char* next = nl ? nl + 1 : bufend;
    int32_t* si = ctx->stage_i + ctx->stage_n * static_cast<long long>(k);
    float* sv = ctx->stage_v + ctx->stage_n * static_cast<long long>(k);
    float yv;
    unsigned char opv, validv;
    parse_one_line_sparse(p, line_end, ctx->dense_budget, ctx->hash_space,
                          hash_mod, k, si, sv, &yv, &opv, &validv);
    if (validv == 1 && opv == 0) {
      sparse_stage_holdout_slot(ctx, si, sv, yv);
    } else if (validv == 2 || (validv == 1 && opv == 1)) {
      *special_off = p - buf;
      *special_len = line_end - p;
      *bytes_consumed = next - buf;
      return 2;
    }
    p = next;
  }
  *bytes_consumed = len;
  return 0;
}

// Stage a run of ALREADY-PARSED COO training rows: the staging tail of the
// multithreaded block route (omldm_parse_lines_sparse_mt parses on all
// cores, then this serial pass runs the 8-of-10 holdout cycle + ring swap
// + stage memcpy in C — the work the numpy _holdout_then_stage/_stage_coo
// pair used to do with mask/argsort/concatenate per block). Pauses at
// stage-full so the caller can launch the staged step; returns rows
// consumed from [0, n). Bit-identical to the fused line loop above and to
// the numpy route (all three share the per-record holdout semantics).
long long omldm_stage_coo_rows(OmldmSparseStageCtx* ctx, const int32_t* idx,
                               const float* val, const float* y,
                               long long n) {
  const long long k = ctx->max_nnz;
  long long i = 0;
  while (i < n) {
    if (ctx->stage_n >= ctx->stage_cap) break;
    int32_t* si = ctx->stage_i + ctx->stage_n * k;
    float* sv = ctx->stage_v + ctx->stage_n * k;
    memcpy(si, idx + i * k, sizeof(int32_t) * static_cast<size_t>(k));
    memcpy(sv, val + i * k, sizeof(float) * static_cast<size_t>(k));
    sparse_stage_holdout_slot(ctx, si, sv, y[i]);
    ++i;
  }
  return i;
}

// Sparse bulk entry: JSON lines -> padded-COO (idx[max_nnz], val[max_nnz])
// rows + targets/ops/valid, mirroring omldm_parse_lines' contract.
int omldm_parse_lines_sparse(const char* buf, long len, int dense_budget,
                             long hash_space, int max_nnz, int max_records,
                             int32_t* idx, float* val, float* y,
                             unsigned char* op, unsigned char* valid,
                             long* bytes_consumed) {
  const char* p = buf;
  const char* bufend = buf + len;
  int i = 0;
  const bool hash_fits = hash_space > 0 && hash_space <= 0xFFFFFFFFL;
  const FastMod hash_mod(
      hash_fits ? static_cast<uint32_t>(hash_space) : 1u);
  while (p < bufend && i < max_records) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', bufend - p));
    const char* line_end = nl ? nl : bufend;
    parse_one_line_sparse(p, line_end, dense_budget, hash_space, hash_mod,
                          max_nnz,
                          idx + static_cast<long>(i) * max_nnz,
                          val + static_cast<long>(i) * max_nnz, y + i,
                          op + i, valid + i);
    ++i;
    p = nl ? nl + 1 : bufend;
  }
  if (bytes_consumed) *bytes_consumed = p - buf;
  return i;
}

int omldm_parse_lines_mt(const char* buf, long len, int dim, int max_records,
                         float* x, float* y, unsigned char* op,
                         unsigned char* valid, int n_threads,
                         long* bytes_consumed) {
  return mt_line_runner(
      buf, len, max_records, n_threads, bytes_consumed,
      [&](int i, const char* line, const char* line_end) {
        parse_one_line(line, line_end, dim, x + static_cast<long>(i) * dim,
                       y + i, op + i, valid + i);
      });
}

int omldm_parse_lines_sparse_mt(const char* buf, long len, int dense_budget,
                                long hash_space, int max_nnz,
                                int max_records, int32_t* idx, float* val,
                                float* y, unsigned char* op,
                                unsigned char* valid, int n_threads,
                                long* bytes_consumed) {
  const bool hash_fits = hash_space > 0 && hash_space <= 0xFFFFFFFFL;
  const FastMod hash_mod(
      hash_fits ? static_cast<uint32_t>(hash_space) : 1u);
  return mt_line_runner(
      buf, len, max_records, n_threads, bytes_consumed,
      [&](int i, const char* line, const char* line_end) {
        parse_one_line_sparse(line, line_end, dense_budget, hash_space,
                              hash_mod, max_nnz,
                              idx + static_cast<long>(i) * max_nnz,
                              val + static_cast<long>(i) * max_nnz, y + i,
                              op + i, valid + i);
      });
}

}  // extern "C"
