// lmrs native runtime: data-plane hot loops + KV page allocator (C ABI).
//
// The reference framework is pure Python (SURVEY.md §0: "no native code
// anywhere"); this library is the TPU build's native runtime layer — the
// host-side work that sits on the scheduler/data-plane critical path:
//
//  * text cleaning  — the per-segment regex pass (reference clean_text,
//    preprocessor.py:69-89) re-implemented as a single UTF-8 scan;
//  * token counting — the chunker's hot loop (reference encodes with
//    tiktoken per segment/sentence/clause, big_chunkeroosky.py:83,370,510;
//    SURVEY.md §3.5 hot loop #2), here the approx-counter contract
//    max(codepoints/4, words/2, 1) over batches of strings;
//  * page allocator — LIFO free-list for the paged KV cache
//    (engine/kv_cache.py PageAllocator), O(1) alloc/free, page 0 reserved.
//
// Exact-parity contract with the Python implementations is enforced by
// tests/test_native.py.  Unicode strategy: the whitespace set matches
// Python's str \s exactly (so counting is exact for ALL input); clean_text's
// \w / IGNORECASE semantics are only reproduced exactly for ASCII, so the
// Python binding routes non-ASCII strings to the pure-Python cleaner —
// parity by construction.  The letter-block tables below only matter for
// direct C-ABI callers.

#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

#if defined(_WIN32)
#define LMRS_API extern "C" __declspec(dllexport)
#else
#define LMRS_API extern "C" __attribute__((visibility("default")))
#endif

namespace {

// ---------------------------------------------------------------- UTF-8

// Decode one codepoint starting at s[i]; advances i.  Invalid bytes are
// treated as Latin-1 (one byte, one codepoint) so the scan never stalls.
inline uint32_t decode_cp(const unsigned char* s, size_t n, size_t& i) {
  unsigned char b = s[i];
  if (b < 0x80) { i += 1; return b; }
  if ((b >> 5) == 0x6 && i + 1 < n && (s[i+1] & 0xC0) == 0x80) {
    uint32_t cp = ((b & 0x1F) << 6) | (s[i+1] & 0x3F);
    i += 2; return cp;
  }
  if ((b >> 4) == 0xE && i + 2 < n && (s[i+1] & 0xC0) == 0x80 &&
      (s[i+2] & 0xC0) == 0x80) {
    uint32_t cp = ((b & 0x0F) << 12) | ((s[i+1] & 0x3F) << 6) | (s[i+2] & 0x3F);
    i += 3; return cp;
  }
  if ((b >> 3) == 0x1E && i + 3 < n && (s[i+1] & 0xC0) == 0x80 &&
      (s[i+2] & 0xC0) == 0x80 && (s[i+3] & 0xC0) == 0x80) {
    uint32_t cp = ((b & 0x07) << 18) | ((s[i+1] & 0x3F) << 12) |
                  ((s[i+2] & 0x3F) << 6) | (s[i+3] & 0x3F);
    i += 4; return cp;
  }
  i += 1;
  return b;
}

inline void encode_cp(uint32_t cp, std::string& out) {
  if (cp < 0x80) { out.push_back(char(cp)); return; }
  if (cp < 0x800) {
    out.push_back(char(0xC0 | (cp >> 6)));
    out.push_back(char(0x80 | (cp & 0x3F)));
    return;
  }
  if (cp < 0x10000) {
    out.push_back(char(0xE0 | (cp >> 12)));
    out.push_back(char(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back(char(0x80 | (cp & 0x3F)));
    return;
  }
  out.push_back(char(0xF0 | (cp >> 18)));
  out.push_back(char(0x80 | ((cp >> 12) & 0x3F)));
  out.push_back(char(0x80 | ((cp >> 6) & 0x3F)));
  out.push_back(char(0x80 | (cp & 0x3F)));
}

// Python str \s whitespace set.
inline bool is_space_cp(uint32_t cp) {
  switch (cp) {
    case 0x09: case 0x0A: case 0x0B: case 0x0C: case 0x0D: case 0x20:
    case 0x1C: case 0x1D: case 0x1E: case 0x1F:
    case 0x85: case 0xA0: case 0x1680:
    case 0x2028: case 0x2029: case 0x202F: case 0x205F: case 0x3000:
      return true;
    default:
      return cp >= 0x2000 && cp <= 0x200A;
  }
}

// Word char: ASCII alnum/underscore, plus non-ASCII codepoints in the major
// letter blocks (Latin-1/extended, Greek, Cyrillic, Armenian, Hebrew,
// Arabic, Indic, kana, CJK, Hangul).  Symbols/emoji are NOT word chars —
// matching Python's unicode \w on the transcript domain without shipping
// full Unicode category tables.
inline bool is_word_cp(uint32_t cp) {
  if (cp < 0x80) {
    return (cp >= 'a' && cp <= 'z') || (cp >= 'A' && cp <= 'Z') ||
           (cp >= '0' && cp <= '9') || cp == '_';
  }
  if (cp == 0xD7 || cp == 0xF7) return false;  // multiply / divide signs
  if (cp >= 0xC0 && cp <= 0x24F) return true;    // Latin-1 + extended
  if (cp >= 0x370 && cp <= 0x5FF) return true;   // Greek, Cyrillic, Armenian, Hebrew
  if (cp >= 0x600 && cp <= 0x6FF) return true;   // Arabic
  if (cp >= 0x900 && cp <= 0xDFF) return true;   // Indic scripts
  if (cp >= 0x1E00 && cp <= 0x1FFF) return true; // Latin/Greek additional
  if (cp >= 0x3040 && cp <= 0x30FF) return true; // kana
  if (cp >= 0x4E00 && cp <= 0x9FFF) return true; // CJK unified
  if (cp >= 0xAC00 && cp <= 0xD7AF) return true; // Hangul
  return false;
}

inline uint32_t ascii_lower(uint32_t cp) {
  return (cp >= 'A' && cp <= 'Z') ? cp + 32 : cp;
}

struct Run {
  uint32_t start, end;  // [start, end) index range into the codepoint array
  uint8_t cls;          // 0 = other, 1 = space, 2 = word
};

// --------------------------------------------------------- clean_text

// Mirrors lmrs_tpu.data.preprocessor.clean_text:
//   1. \s+ -> " "  and strip;
//   2. \b(\w+)(\s+\1\b)+ -> \1  (case-insensitive immediate-repeat dedup);
//   3. ([.!?,;:])([A-Za-z]) -> "\1 \2".
// `out` is appended to (batch API reuses one buffer); scratch vectors are
// caller-owned to amortize allocations across a batch.
void clean_text_impl(const unsigned char* s, size_t n, std::string& out,
                     std::vector<uint32_t>& cps, std::vector<Run>& runs) {
  if (n == 0) return;
  cps.clear();
  runs.clear();
  cps.reserve(n);
  size_t i = 0;
  uint8_t prev_cls = 255;
  while (i < n) {
    uint32_t cp = decode_cp(s, n, i);
    bool sp = is_space_cp(cp);
    uint8_t cls = sp ? 1 : (is_word_cp(cp) ? 2 : 0);
    if (cls != prev_cls) {
      runs.push_back(Run{uint32_t(cps.size()), uint32_t(cps.size()), cls});
      prev_cls = cls;
    }
    cps.push_back(cp);
    runs.back().end = uint32_t(cps.size());
  }

  auto words_equal_nocase = [&](const Run& a, const Run& b) {
    if (a.end - a.start != b.end - b.start) return false;
    for (uint32_t j = 0; j < a.end - a.start; ++j) {
      if (ascii_lower(cps[a.start + j]) != ascii_lower(cps[b.start + j]))
        return false;
    }
    return true;
  };

  // Pass 1+2 fused: whitespace runs become one space; a word run preceded
  // (through whitespace only) by a case-equal word run is dropped together
  // with that whitespace — the regex consumes "\s+\1", so following text
  // continues flush against the kept word.
  size_t start = 0, end = runs.size();
  while (start < end && runs[start].cls == 1) ++start;  // lstrip
  while (end > start && runs[end - 1].cls == 1) --end;  // rstrip

  size_t emit_from = out.size();
  int last_word = -1;  // index into runs of the word run emitted last
  bool last_emitted_was_word = false;
  bool pending_space = false;
  for (size_t t = start; t < end; ++t) {
    const Run& r = runs[t];
    if (r.cls == 1) {
      pending_space = true;
      continue;
    }
    if (r.cls == 2 && last_word >= 0 && last_emitted_was_word &&
        pending_space && words_equal_nocase(runs[last_word], r)) {
      pending_space = false;
      continue;
    }
    if (pending_space) {
      out.push_back(' ');
      pending_space = false;
    }
    // Pass 3 fused at emission: a word starting [A-Za-z] flush against a
    // kept trailing [.!?,;:] gets the missing space restored.
    if (r.cls == 2 && !pending_space && out.size() > emit_from) {
      char prevb = out.back();
      uint32_t first = cps[r.start];
      if ((prevb == '.' || prevb == '!' || prevb == '?' || prevb == ',' ||
           prevb == ';' || prevb == ':') &&
          ((first >= 'A' && first <= 'Z') || (first >= 'a' && first <= 'z'))) {
        out.push_back(' ');
      }
    }
    for (uint32_t j = r.start; j < r.end; ++j) encode_cp(cps[j], out);
    last_emitted_was_word = (r.cls == 2);
    if (r.cls == 2) last_word = int(t);
  }
}

std::string clean_text_str(const unsigned char* s, size_t n) {
  std::string out;
  out.reserve(n);
  std::vector<uint32_t> cps;
  std::vector<Run> runs;
  clean_text_impl(s, n, out, cps, runs);
  return out;
}

// ------------------------------------------------------ approx counting

// Mirrors ApproxTokenizer.count: max(codepoints // 4, \S+ runs // 2, 1),
// 0 for the empty string.
int64_t count_approx_impl(const unsigned char* s, size_t n) {
  if (n == 0) return 0;
  int64_t cps = 0, words = 0;
  bool in_word = false;
  size_t i = 0;
  while (i < n) {
    uint32_t cp = decode_cp(s, n, i);
    ++cps;
    bool sp = is_space_cp(cp);
    if (!sp && !in_word) { ++words; in_word = true; }
    if (sp) in_word = false;
  }
  int64_t by_chars = cps / 4;
  int64_t by_words = words / 2;
  int64_t best = by_chars > by_words ? by_chars : by_words;
  return best > 1 ? best : 1;
}

// ---------------------------------------------------------- allocator

// Mirrors engine/kv_cache.PageAllocator: LIFO free list initialized
// [num_pages-1 .. 1] (so pages are handed out 1, 2, 3, ... and freed pages
// are reused most-recently-freed-first).  Page 0 is reserved (null page).
// Pages are ref-counted (prefix-cache sharing): alloc hands out refcount 1,
// incref adds a holder, free is a decref that returns the page to the free
// list only at zero — and errors on a page already free (double-free would
// hand one page to two sequences).
struct PageAlloc {
  int32_t num_pages;
  std::vector<int32_t> free_list;
  std::vector<int32_t> refs;  // per-page refcount; 0 == on the free list
  std::mutex mu;
};

// Validate a free/incref batch before ANY mutation: every id in range and
// every page's refcount covering its multiplicity in the call.  Returns 0,
// -2 on a bad id, -3 on a double-free / unowned page.
int32_t check_pages(const PageAlloc* a, const int32_t* pages, int32_t n) {
  for (int32_t i = 0; i < n; ++i) {
    if (pages[i] < 1 || pages[i] >= a->num_pages) return -2;
  }
  for (int32_t i = 0; i < n; ++i) {
    int32_t mult = 0;
    for (int32_t j = 0; j < n; ++j) mult += (pages[j] == pages[i]);
    if (a->refs[pages[i]] < mult) return -3;
  }
  return 0;
}

}  // namespace

// =================================================================== C ABI

LMRS_API int32_t lmrs_abi_version(void) { return 2; }

// ---- text ----

// Clean `in[0..n)` into `out` (capacity out_cap).  Returns the cleaned
// length, or the required capacity as a negative number if out_cap is too
// small (call again with a bigger buffer).  Output never exceeds 2n+1 bytes.
LMRS_API int64_t lmrs_clean_text(const char* in, int64_t n, char* out,
                                 int64_t out_cap) {
  std::string r = clean_text_str(reinterpret_cast<const unsigned char*>(in),
                                 size_t(n));
  if (int64_t(r.size()) > out_cap) return -int64_t(r.size());
  std::memcpy(out, r.data(), r.size());
  return int64_t(r.size());
}

// Batch cleaning over concatenated strings (string i spans
// buf[offsets[i] .. offsets[i+1]); offsets has n+1 entries).  Cleaned
// strings are written back-to-back into `out` with their spans recorded in
// out_offsets (n+1 entries).  Returns 0, or the required capacity as a
// negative number if out_cap is too small.
LMRS_API int64_t lmrs_clean_text_batch(const char* buf, const int64_t* offsets,
                                       int64_t n, char* out, int64_t out_cap,
                                       int64_t* out_offsets) {
  std::string acc;
  acc.reserve(size_t(offsets[n] - offsets[0]) + 16);
  std::vector<uint32_t> cps;
  std::vector<Run> runs;
  out_offsets[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    clean_text_impl(
        reinterpret_cast<const unsigned char*>(buf + offsets[i]),
        size_t(offsets[i + 1] - offsets[i]), acc, cps, runs);
    out_offsets[i + 1] = int64_t(acc.size());
  }
  if (int64_t(acc.size()) > out_cap) return -int64_t(acc.size());
  std::memcpy(out, acc.data(), acc.size());
  return 0;
}

LMRS_API int64_t lmrs_count_approx(const char* in, int64_t n) {
  return count_approx_impl(reinterpret_cast<const unsigned char*>(in), size_t(n));
}

// Batch counting over concatenated strings: string i spans
// buf[offsets[i] .. offsets[i+1]).  offsets has n+1 entries.
LMRS_API void lmrs_count_approx_batch(const char* buf, const int64_t* offsets,
                                      int64_t n, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] = count_approx_impl(
        reinterpret_cast<const unsigned char*>(buf + offsets[i]),
        size_t(offsets[i + 1] - offsets[i]));
  }
}

// ---- page allocator ----

LMRS_API void* lmrs_palloc_create(int32_t num_pages) {
  if (num_pages <= 1) return nullptr;  // page 0 reserved; need >= 2
  auto* a = new PageAlloc();
  a->num_pages = num_pages;
  a->free_list.reserve(num_pages - 1);
  for (int32_t p = num_pages - 1; p >= 1; --p) a->free_list.push_back(p);
  a->refs.assign(num_pages, 0);
  return a;
}

LMRS_API void lmrs_palloc_destroy(void* h) {
  delete static_cast<PageAlloc*>(h);
}

LMRS_API int32_t lmrs_palloc_free_count(void* h) {
  auto* a = static_cast<PageAlloc*>(h);
  std::lock_guard<std::mutex> lk(a->mu);
  return int32_t(a->free_list.size());
}

// Pop n pages into out at refcount 1.  Returns 0, or -1 if fewer than n
// pages are free (OutOfPages back-pressure; nothing is allocated).
LMRS_API int32_t lmrs_palloc_alloc(void* h, int32_t n, int32_t* out) {
  auto* a = static_cast<PageAlloc*>(h);
  std::lock_guard<std::mutex> lk(a->mu);
  if (n < 0 || size_t(n) > a->free_list.size()) return -1;
  for (int32_t i = 0; i < n; ++i) {
    out[i] = a->free_list.back();
    a->free_list.pop_back();
    a->refs[out[i]] = 1;
  }
  return 0;
}

// Release one reference per page; pages reaching refcount 0 return to the
// pool.  Returns 0, -2 on an out-of-range page id, -3 on a double-free /
// unowned page (ids validated before any mutation).
LMRS_API int32_t lmrs_palloc_free(void* h, const int32_t* pages, int32_t n) {
  auto* a = static_cast<PageAlloc*>(h);
  std::lock_guard<std::mutex> lk(a->mu);
  int32_t rc = check_pages(a, pages, n);
  if (rc != 0) return rc;
  for (int32_t i = 0; i < n; ++i) {
    if (--a->refs[pages[i]] == 0) a->free_list.push_back(pages[i]);
  }
  return 0;
}

// Add one reference per page (prefix-cache sharing); only live pages may
// gain holders.  Returns 0, -2 on a bad id, -3 on a refcount-0 page.
LMRS_API int32_t lmrs_palloc_incref(void* h, const int32_t* pages,
                                    int32_t n) {
  auto* a = static_cast<PageAlloc*>(h);
  std::lock_guard<std::mutex> lk(a->mu);
  int32_t rc = check_pages(a, pages, n);
  if (rc != 0) return rc;
  for (int32_t i = 0; i < n; ++i) ++a->refs[pages[i]];
  return 0;
}

// Current refcount of one page (>= 0), or -2 on an out-of-range id.
LMRS_API int32_t lmrs_palloc_refcount(void* h, int32_t page) {
  auto* a = static_cast<PageAlloc*>(h);
  std::lock_guard<std::mutex> lk(a->mu);
  if (page < 0 || page >= a->num_pages) return -2;
  return a->refs[page];
}
