// bb25_native: host-side hot loops for the BM25 engine.
//
// Implements the tokenizer (lowercase + [a-z0-9]+ extraction + stopword
// filter + Porter stemmer) and the corpus builder (vocab construction +
// per-doc term counting) in C++. The Python reference implementation lives
// in bayesian_bm25_tpu/engine/tokenize.py; behavior here must match it
// exactly (parity-tested in tests/test_tokenize.py).
//
// C ABI (ctypes-friendly): results are heap-allocated structs of flat
// arrays; callers copy into numpy and free via the matching free function.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

const std::unordered_set<std::string>& stopwords() {
  static const std::unordered_set<std::string> kStop = {
      "a",    "an",   "and",  "are",  "as",    "at",   "be",   "but",
      "by",   "for",  "if",   "in",   "into",  "is",   "it",   "no",
      "not",  "of",   "on",   "or",   "such",  "that", "the",  "their",
      "then", "there", "these", "they", "this", "to",   "was",  "will",
      "with"};
  return kStop;
}

inline bool is_word_char(char c) {
  return (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9');
}

// ----- Porter stemmer ------------------------------------------------------

bool is_consonant(const std::string& w, int i) {
  char c = w[i];
  if (c == 'a' || c == 'e' || c == 'i' || c == 'o' || c == 'u') return false;
  if (c == 'y') return i == 0 ? true : !is_consonant(w, i - 1);
  return true;
}

int measure(const std::string& stem) {
  int m = 0;
  bool prev_vowel = false;
  for (int i = 0; i < (int)stem.size(); ++i) {
    if (is_consonant(stem, i)) {
      if (prev_vowel) ++m;
      prev_vowel = false;
    } else {
      prev_vowel = true;
    }
  }
  return m;
}

bool contains_vowel(const std::string& stem) {
  for (int i = 0; i < (int)stem.size(); ++i)
    if (!is_consonant(stem, i)) return true;
  return false;
}

bool ends_double_consonant(const std::string& w) {
  int n = (int)w.size();
  return n >= 2 && w[n - 1] == w[n - 2] && is_consonant(w, n - 1);
}

bool ends_cvc(const std::string& w) {
  int n = (int)w.size();
  if (n < 3) return false;
  if (!(is_consonant(w, n - 3) && !is_consonant(w, n - 2) &&
        is_consonant(w, n - 1)))
    return false;
  char c = w[n - 1];
  return c != 'w' && c != 'x' && c != 'y';
}

bool ends_with(const std::string& w, const char* suf) {
  size_t n = std::strlen(suf);
  return w.size() >= n && w.compare(w.size() - n, n, suf) == 0;
}

std::string porter_stem(const std::string& word) {
  if (word.size() <= 2) return word;
  std::string w = word;

  // Step 1a
  if (ends_with(w, "sses")) {
    w.resize(w.size() - 2);
  } else if (ends_with(w, "ies")) {
    w.resize(w.size() - 2);
  } else if (ends_with(w, "ss")) {
    // keep
  } else if (ends_with(w, "s")) {
    w.resize(w.size() - 1);
  }

  // Step 1b
  if (ends_with(w, "eed")) {
    if (measure(w.substr(0, w.size() - 3)) > 0) w.resize(w.size() - 1);
  } else {
    bool flag = false;
    if (ends_with(w, "ed") && contains_vowel(w.substr(0, w.size() - 2))) {
      w.resize(w.size() - 2);
      flag = true;
    } else if (ends_with(w, "ing") &&
               contains_vowel(w.substr(0, w.size() - 3))) {
      w.resize(w.size() - 3);
      flag = true;
    }
    if (flag) {
      if (ends_with(w, "at") || ends_with(w, "bl") || ends_with(w, "iz")) {
        w += 'e';
      } else if (ends_double_consonant(w) && !ends_with(w, "l") &&
                 !ends_with(w, "s") && !ends_with(w, "z")) {
        w.resize(w.size() - 1);
      } else if (measure(w) == 1 && ends_cvc(w)) {
        w += 'e';
      }
    }
  }

  // Step 1c
  if (ends_with(w, "y") && contains_vowel(w.substr(0, w.size() - 1))) {
    w[w.size() - 1] = 'i';
  }

  // Step 2
  static const std::pair<const char*, const char*> kStep2[] = {
      {"ational", "ate"}, {"tional", "tion"}, {"enci", "ence"},
      {"anci", "ance"},   {"izer", "ize"},    {"abli", "able"},
      {"alli", "al"},     {"entli", "ent"},   {"eli", "e"},
      {"ousli", "ous"},   {"ization", "ize"}, {"ation", "ate"},
      {"ator", "ate"},    {"alism", "al"},    {"iveness", "ive"},
      {"fulness", "ful"}, {"ousness", "ous"}, {"aliti", "al"},
      {"iviti", "ive"},   {"biliti", "ble"}};
  for (const auto& [suf, rep] : kStep2) {
    if (ends_with(w, suf)) {
      std::string stem = w.substr(0, w.size() - std::strlen(suf));
      if (measure(stem) > 0) w = stem + rep;
      break;
    }
  }

  // Step 3
  static const std::pair<const char*, const char*> kStep3[] = {
      {"icate", "ic"}, {"ative", ""},  {"alize", "al"}, {"iciti", "ic"},
      {"ical", "ic"},  {"ful", ""},    {"ness", ""}};
  for (const auto& [suf, rep] : kStep3) {
    if (ends_with(w, suf)) {
      std::string stem = w.substr(0, w.size() - std::strlen(suf));
      if (measure(stem) > 0) w = stem + rep;
      break;
    }
  }

  // Step 4
  static const char* kStep4[] = {"al",   "ance", "ence", "er",    "ic",
                                 "able", "ible", "ant",  "ement", "ment",
                                 "ent",  "ou",   "ism",  "ate",   "iti",
                                 "ous",  "ive",  "ize"};
  bool matched4 = false;
  for (const char* suf : kStep4) {
    if (ends_with(w, suf)) {
      std::string stem = w.substr(0, w.size() - std::strlen(suf));
      if (measure(stem) > 1) w = stem;
      matched4 = true;
      break;
    }
  }
  if (!matched4 && ends_with(w, "ion") && w.size() > 3) {
    char c = w[w.size() - 4];
    if ((c == 's' || c == 't') && measure(w.substr(0, w.size() - 3)) > 1) {
      w.resize(w.size() - 3);
    }
  }

  // Step 5a
  if (ends_with(w, "e")) {
    std::string stem = w.substr(0, w.size() - 1);
    int m = measure(stem);
    if (m > 1 || (m == 1 && !ends_cvc(stem))) w = stem;
  }

  // Step 5b
  if (measure(w) > 1 && ends_double_consonant(w) && ends_with(w, "l")) {
    w.resize(w.size() - 1);
  }

  return w;
}

// ----- Snowball (Porter2) English stemmer ----------------------------------
//
// Behavioral mirror of bayesian_bm25_tpu/engine/snowball.py (which is
// fuzz-verified exact against NLTK's SnowballStemmer('english')). R1/R2
// are maintained as suffix strings of the evolving word; the three edit
// kinds treat regions shorter than the matched suffix differently, so
// they are distinct helpers rather than one generic replace.

namespace sb {

inline bool is_v(char c) {
  return c == 'a' || c == 'e' || c == 'i' || c == 'o' || c == 'u' ||
         c == 'y';
}

struct State {
  std::string w, r1, r2;
};

inline bool ends(const std::string& s, const char* suf) {
  size_t n = std::strlen(suf);
  return s.size() >= n && std::memcmp(s.data() + s.size() - n, suf, n) == 0;
}

// Drop the last k chars of word/R1/R2 alike (regions may underflow to
// empty, like Python's s[:-k]).
void trunc(State& st, size_t k) {
  auto cut = [k](std::string& x) {
    x.resize(x.size() > k ? x.size() - k : 0);
  };
  cut(st.w);
  cut(st.r1);
  cut(st.r2);
}

// Drop 1 char, append 'e'; empty regions stay empty.
void edit_e1(State& st) {
  auto fix = [](std::string& x) {
    if (!x.empty()) {
      x.back() = 'e';
    }
  };
  st.w.back() = 'e';
  fix(st.r1);
  fix(st.r2);
}

// Replace the n-char suffix with rep; a region shorter than the suffix
// collapses ("" for R1, fb2 for R2).
void repl(State& st, size_t n, const char* rep, const char* fb2) {
  st.w.resize(st.w.size() - n);
  st.w += rep;
  if (st.r1.size() >= n) {
    st.r1.resize(st.r1.size() - n);
    st.r1 += rep;
  } else {
    st.r1.clear();
  }
  if (st.r2.size() >= n) {
    st.r2.resize(st.r2.size() - n);
    st.r2 += rep;
  } else {
    st.r2 = fb2;
  }
}

const std::unordered_map<std::string, std::string>& special_words() {
  static const std::unordered_map<std::string, std::string> kSpecial = {
      {"skis", "ski"},        {"skies", "sky"},
      {"dying", "die"},       {"lying", "lie"},
      {"tying", "tie"},       {"idly", "idl"},
      {"gently", "gentl"},    {"ugly", "ugli"},
      {"early", "earli"},     {"only", "onli"},
      {"singly", "singl"},    {"sky", "sky"},
      {"news", "news"},       {"howe", "howe"},
      {"atlas", "atlas"},     {"cosmos", "cosmos"},
      {"bias", "bias"},       {"andes", "andes"},
      {"inning", "inning"},   {"innings", "inning"},
      {"outing", "outing"},   {"outings", "outing"},
      {"canning", "canning"}, {"cannings", "canning"},
      {"herring", "herring"}, {"herrings", "herring"},
      {"earring", "earring"}, {"earrings", "earring"},
      {"proceed", "proceed"}, {"proceeds", "proceed"},
      {"proceeded", "proceed"}, {"proceeding", "proceed"},
      {"exceed", "exceed"},   {"exceeds", "exceed"},
      {"exceeded", "exceed"}, {"exceeding", "exceed"},
      {"succeed", "succeed"}, {"succeeds", "succeed"},
      {"succeeded", "succeed"}, {"succeeding", "succeed"},
  };
  return kSpecial;
}

inline bool ends_double(const std::string& w) {
  if (w.size() < 2) return false;
  char a = w[w.size() - 2], b = w[w.size() - 1];
  if (a != b) return false;
  return a == 'b' || a == 'd' || a == 'f' || a == 'g' || a == 'm' ||
         a == 'n' || a == 'p' || a == 'r' || a == 't';
}

inline bool any_vowel(const std::string& w, size_t upto) {
  for (size_t i = 0; i < upto && i < w.size(); ++i)
    if (is_v(w[i])) return true;
  return false;
}

void mark_regions(State& st) {
  const std::string& w = st.w;
  size_t r1_start = w.size();
  if (w.rfind("gener", 0) == 0 || w.rfind("arsen", 0) == 0) {
    r1_start = 5;
  } else if (w.rfind("commun", 0) == 0) {
    r1_start = 6;
  } else {
    for (size_t i = 1; i < w.size(); ++i) {
      if (!is_v(w[i]) && is_v(w[i - 1])) {
        r1_start = i + 1;
        break;
      }
    }
  }
  if (r1_start < w.size()) st.r1 = w.substr(r1_start);
  for (size_t i = 1; i < st.r1.size(); ++i) {
    if (!is_v(st.r1[i]) && is_v(st.r1[i - 1])) {
      st.r2 = st.r1.substr(i + 1);
      break;
    }
  }
}

std::string stem(const std::string& word) {
  if (word.size() <= 2) return word;
  auto& sp = special_words();
  auto it = sp.find(word);
  if (it != sp.end()) return it->second;

  State st;
  st.w = word;
  std::string& w = st.w;
  if (w[0] == '\'') w.erase(0, 1);
  if (!w.empty() && w[0] == 'y') w[0] = 'Y';
  for (size_t i = 1; i < w.size(); ++i)
    if (w[i] == 'y' && is_v(w[i - 1])) w[i] = 'Y';

  mark_regions(st);
  std::string& r1 = st.r1;
  std::string& r2 = st.r2;

  // Step 0: possessive markers.
  for (const char* suf : {"'s'", "'s", "'"}) {
    if (ends(w, suf)) {
      trunc(st, std::strlen(suf));
      break;
    }
  }

  // Step 1a: plural endings.
  if (ends(w, "sses")) {
    trunc(st, 2);
  } else if (ends(w, "ied") || ends(w, "ies")) {
    trunc(st, w.size() > 4 ? 2 : 1);
  } else if (ends(w, "us") || ends(w, "ss")) {
    // keep
  } else if (ends(w, "s")) {
    if (w.size() >= 2 && any_vowel(w, w.size() - 2)) trunc(st, 1);
  }

  // Step 1b: -ed/-ing families.
  for (const char* suf : {"eedly", "ingly", "edly", "eed", "ing", "ed"}) {
    if (!ends(w, suf)) continue;
    size_t n = std::strlen(suf);
    if (n >= 3 && suf[0] == 'e' && suf[1] == 'e') {  // eed / eedly
      if (ends(r1, suf)) repl(st, n, "ee", "");
    } else if (any_vowel(w, w.size() - n)) {
      trunc(st, n);
      if (ends(w, "at") || ends(w, "bl") || ends(w, "iz")) {
        w += 'e';
        r1 += 'e';
        // Marker quirk: the e lands in R2 only for words already long
        // enough to have reached it.
        if (w.size() > 5 || r1.size() >= 3) r2 += 'e';
      } else if (ends_double(w)) {
        trunc(st, 1);
      } else if (r1.empty() &&
                 ((w.size() >= 3 && !is_v(w[w.size() - 1]) &&
                   w[w.size() - 1] != 'w' && w[w.size() - 1] != 'x' &&
                   w[w.size() - 1] != 'Y' && is_v(w[w.size() - 2]) &&
                   !is_v(w[w.size() - 3])) ||
                  (w.size() == 2 && is_v(w[0]) && !is_v(w[1])))) {
        w += 'e';  // short word: restore the e (regions stay empty)
      }
    }
    break;
  }

  // Step 1c: terminal y after a consonant.
  if (w.size() > 2 && (w.back() == 'y' || w.back() == 'Y') &&
      !is_v(w[w.size() - 2])) {
    w.back() = 'i';
    if (!r1.empty()) r1.back() = 'i';
    if (!r2.empty()) r2.back() = 'i';
  }

  // Step 2 (longest match, first endswith wins; applies only inside R1).
  {
    struct Rule {
      const char* suf;
      int kind;  // 0 trunc, 1 e1, 2 repl
      size_t k;
      const char* rep;
      const char* fb2;
    };
    static const Rule kStep2[] = {
        {"ization", 2, 0, "ize", ""}, {"ational", 2, 0, "ate", "e"},
        {"fulness", 0, 4, "", ""},    {"ousness", 2, 0, "ous", ""},
        {"iveness", 2, 0, "ive", "e"}, {"tional", 0, 2, "", ""},
        {"biliti", 2, 0, "ble", ""},  {"lessli", 0, 2, "", ""},
        {"entli", 0, 2, "", ""},      {"ation", 2, 0, "ate", "e"},
        {"alism", 2, 0, "al", ""},    {"aliti", 2, 0, "al", ""},
        {"ousli", 2, 0, "ous", ""},   {"iviti", 2, 0, "ive", "e"},
        {"fulli", 0, 2, "", ""},      {"enci", 1, 0, "", ""},
        {"anci", 1, 0, "", ""},       {"abli", 1, 0, "", ""},
        {"izer", 2, 0, "ize", ""},    {"ator", 2, 0, "ate", "e"},
        {"alli", 2, 0, "al", ""},
    };
    bool matched = false;
    for (const Rule& rule : kStep2) {
      if (ends(w, rule.suf)) {
        matched = true;
        if (ends(r1, rule.suf)) {
          if (rule.kind == 0) {
            trunc(st, rule.k);
          } else if (rule.kind == 1) {
            edit_e1(st);
          } else {
            repl(st, std::strlen(rule.suf), rule.rep, rule.fb2);
          }
        }
        break;
      }
    }
    if (!matched) {
      if (ends(w, "bli")) {
        if (ends(r1, "bli")) repl(st, 3, "ble", "");
      } else if (ends(w, "ogi")) {
        if (ends(r1, "ogi") && w.size() >= 4 && w[w.size() - 4] == 'l')
          trunc(st, 1);
      } else if (ends(w, "li")) {
        if (ends(r1, "li") && w.size() >= 3) {
          char c = w[w.size() - 3];
          if (c == 'c' || c == 'd' || c == 'e' || c == 'g' || c == 'h' ||
              c == 'k' || c == 'm' || c == 'n' || c == 'r' || c == 't')
            trunc(st, 2);
        }
      }
    }
  }

  // Step 3 (inside R1; -ative additionally requires R2).
  {
    struct Rule {
      const char* suf;
      int kind;  // 0 trunc, 2 repl
      size_t k;
      const char* rep;
    };
    static const Rule kStep3[] = {
        {"ational", 2, 0, "ate"}, {"tional", 0, 2, ""},
        {"alize", 0, 3, ""},      {"icate", 2, 0, "ic"},
        {"iciti", 2, 0, "ic"},    {"ical", 2, 0, "ic"},
        {"ness", 0, 4, ""},       {"ful", 0, 3, ""},
    };
    bool matched = false;
    for (const Rule& rule : kStep3) {
      if (ends(w, rule.suf)) {
        matched = true;
        if (ends(r1, rule.suf)) {
          if (rule.kind == 0) {
            trunc(st, rule.k);
          } else {
            repl(st, std::strlen(rule.suf), rule.rep, "");
          }
        }
        break;
      }
    }
    if (!matched && ends(w, "ative") && ends(r1, "ative") &&
        ends(r2, "ative")) {
      trunc(st, 5);
    }
  }

  // Step 4 (inside R2; -ion only after s/t).
  {
    static const char* kStep4[] = {"ement", "ance", "ence", "able", "ible",
                                   "ment", "ant", "ent", "ism", "ate",
                                   "iti", "ous", "ive", "ize", "al", "er",
                                   "ic"};
    bool matched = false;
    for (const char* suf : kStep4) {
      if (ends(w, suf)) {
        matched = true;
        if (ends(r2, suf)) trunc(st, std::strlen(suf));
        break;
      }
    }
    if (!matched && ends(w, "ion") && ends(r2, "ion") && w.size() >= 4 &&
        (w[w.size() - 4] == 's' || w[w.size() - 4] == 't')) {
      trunc(st, 3);
    }
  }

  // Step 5: residual e/l.
  if (ends(r2, "l") && w.size() >= 2 && w[w.size() - 2] == 'l') {
    w.resize(w.size() - 1);
  } else if (ends(r2, "e")) {
    w.resize(w.size() - 1);
  } else if (ends(r1, "e")) {
    if (w.size() >= 4 &&
        (is_v(w[w.size() - 2]) || w[w.size() - 2] == 'w' ||
         w[w.size() - 2] == 'x' || w[w.size() - 2] == 'Y' ||
         !is_v(w[w.size() - 3]) || is_v(w[w.size() - 4]))) {
      w.resize(w.size() - 1);
    }
  }

  for (char& c : w)
    if (c == 'Y') c = 'y';
  return w;
}

}  // namespace sb

// stem_mode: 0 = none, 1 = Porter (1980), 2 = Snowball English (Porter2).
void tokenize_one(const char* begin, const char* end, bool lowercase,
                  bool remove_stop, int stem_mode,
                  std::vector<std::string>* out) {
  std::string cur;
  for (const char* p = begin; p <= end; ++p) {
    char c = (p < end) ? *p : ' ';
    if (lowercase && c >= 'A' && c <= 'Z') c = (char)(c - 'A' + 'a');
    if (is_word_char(c)) {
      cur += c;
    } else if (!cur.empty()) {
      if (!remove_stop || !stopwords().count(cur)) {
        if (stem_mode == 1) {
          out->push_back(porter_stem(cur));
        } else if (stem_mode == 2) {
          out->push_back(sb::stem(cur));
        } else {
          out->push_back(cur);
        }
      }
      cur.clear();
    }
  }
}

}  // namespace

extern "C" {

// ----- Batch tokenization (strings out) ------------------------------------

struct TokenizeResult {
  char* token_blob;        // concatenated token bytes
  int64_t* token_offsets;  // n_tokens + 1 into token_blob
  int64_t* doc_offsets;    // n_docs + 1 into token index space
  int64_t n_tokens;
  int64_t blob_size;
};

TokenizeResult* bb25_tokenize(const char* blob, const int64_t* offsets,
                              int64_t n_docs, int lowercase, int remove_stop,
                              int stem) {
  auto* res = new TokenizeResult();
  std::string token_blob;
  std::vector<int64_t> token_offsets{0};
  std::vector<int64_t> doc_offsets{0};
  std::vector<std::string> tokens;
  for (int64_t d = 0; d < n_docs; ++d) {
    tokens.clear();
    tokenize_one(blob + offsets[d], blob + offsets[d + 1], lowercase != 0,
                 remove_stop != 0, stem, &tokens);
    for (const auto& t : tokens) {
      token_blob += t;
      token_offsets.push_back((int64_t)token_blob.size());
    }
    doc_offsets.push_back((int64_t)token_offsets.size() - 1);
  }
  res->n_tokens = (int64_t)token_offsets.size() - 1;
  res->blob_size = (int64_t)token_blob.size();
  res->token_blob = new char[token_blob.size() + 1];
  std::memcpy(res->token_blob, token_blob.data(), token_blob.size());
  res->token_blob[token_blob.size()] = 0;
  res->token_offsets = new int64_t[token_offsets.size()];
  std::memcpy(res->token_offsets, token_offsets.data(),
              token_offsets.size() * sizeof(int64_t));
  res->doc_offsets = new int64_t[doc_offsets.size()];
  std::memcpy(res->doc_offsets, doc_offsets.data(),
              doc_offsets.size() * sizeof(int64_t));
  return res;
}

void bb25_free_tokenize(TokenizeResult* res) {
  if (!res) return;
  delete[] res->token_blob;
  delete[] res->token_offsets;
  delete[] res->doc_offsets;
  delete res;
}

// ----- Corpus build: tokenize + vocab + per-doc term counts ----------------

struct CorpusResult {
  int64_t* doc_indptr;   // n_docs + 1 into term_ids/term_counts
  int32_t* term_ids;     // nnz (unique terms per doc)
  int32_t* term_counts;  // nnz
  int32_t* doc_lengths;  // n_docs (total token count incl. duplicates)
  char* vocab_blob;      // concatenated vocab strings (id order)
  int64_t* vocab_offsets;  // n_vocab + 1
  int64_t n_vocab;
  int64_t nnz;
  int64_t vocab_blob_size;
};

namespace {

inline uint32_t fnv1a_hash(const char* s, size_t n) {
  uint32_t h = 2166136261u;
  for (size_t i = 0; i < n; ++i) {
    h ^= (uint8_t)s[i];
    h *= 16777619u;
  }
  return h;
}

// Shared corpus-accumulation state for the two builder entry points.
//
// Interning uses a growable flat open-addressing table (linear probing,
// FNV-1a, load factor <= 1/2) whose keys live in one arena string in id
// order — a lookup is a hash plus ~1 probe with zero allocation, vs the
// previous unordered_map<std::string,...>'s temp string + chained
// buckets (2+ cache misses each).  Per-doc dedup is epoch-stamped:
// last_doc/pos_of arrays indexed by term id replace the per-doc
// unordered_map<int,int> counts + unordered_set seen pass, so a doc's
// unique (id, count) rows are emitted in first-occurrence order during
// the token scan itself — matching engine/index.py:_corpus_to_csr's
// dict-insertion semantics bit-for-bit.
struct CorpusBuild {
  std::string arena;                // concatenated vocab strings, id order
  std::vector<int64_t> offs{0};     // n_vocab + 1 into arena
  struct Slot {
    uint32_t hash;  // cached full hash; empty slots have id == -1
    int32_t id;
  };
  std::vector<Slot> slots = std::vector<Slot>(1 << 16, Slot{0, -1});
  size_t mask = (1 << 16) - 1;
  // Per-term doc stamps for the in-scan dedup (grow with the vocab).
  std::vector<int64_t> last_doc;
  std::vector<int64_t> pos_of;
  int64_t cur_doc = -1;

  std::vector<int64_t> indptr{0};
  std::vector<int32_t> term_ids;
  std::vector<int32_t> term_counts;
  std::vector<int32_t> doc_lengths;

  size_t n_vocab() const { return offs.size() - 1; }

  void grow_table() {
    size_t cap = (mask + 1) << 1;
    std::vector<Slot> next(cap, Slot{0, -1});
    size_t nmask = cap - 1;
    for (const Slot& sl : slots) {
      if (sl.id == -1) continue;
      size_t at = sl.hash & nmask;
      while (next[at].id != -1) at = (at + 1) & nmask;
      next[at] = sl;
    }
    slots.swap(next);
    mask = nmask;
  }

  int32_t intern(const char* s, size_t n) {
    uint32_t h = fnv1a_hash(s, n);
    size_t at = h & mask;
    while (true) {
      const Slot& sl = slots[at];
      if (sl.id == -1) break;
      if (sl.hash == h) {
        int64_t o = offs[sl.id];
        if ((size_t)(offs[sl.id + 1] - o) == n &&
            std::memcmp(arena.data() + o, s, n) == 0)
          return sl.id;
      }
      at = (at + 1) & mask;
    }
    int32_t id = (int32_t)n_vocab();
    arena.append(s, n);
    offs.push_back((int64_t)arena.size());
    last_doc.push_back(-1);
    pos_of.push_back(0);
    slots[at] = Slot{h, id};
    if (n_vocab() * 2 > mask) grow_table();
    return id;
  }

  void begin_doc() { ++cur_doc; }

  void add_token(const char* s, size_t n) {
    int32_t id = intern(s, n);
    if (last_doc[id] != cur_doc) {
      last_doc[id] = cur_doc;
      pos_of[id] = (int64_t)term_ids.size();
      term_ids.push_back(id);
      term_counts.push_back(1);
    } else {
      ++term_counts[pos_of[id]];
    }
  }

  void end_doc(int32_t n_tokens) {
    doc_lengths.push_back(n_tokens);
    indptr.push_back((int64_t)term_ids.size());
  }
};

CorpusResult* pack_corpus(CorpusBuild& b) {
  auto* res = new CorpusResult();
  // The interner's arena/offsets ARE the id-ordered vocab blob.
  std::string& vocab_blob = b.arena;
  std::vector<int64_t>& vocab_offsets = b.offs;
  auto& indptr = b.indptr;
  auto& term_ids = b.term_ids;
  auto& term_counts = b.term_counts;
  auto& doc_lengths = b.doc_lengths;

  res->n_vocab = (int64_t)b.n_vocab();
  res->nnz = (int64_t)term_ids.size();
  res->vocab_blob_size = (int64_t)vocab_blob.size();
  res->doc_indptr = new int64_t[indptr.size()];
  std::memcpy(res->doc_indptr, indptr.data(), indptr.size() * sizeof(int64_t));
  res->term_ids = new int32_t[term_ids.size() + 1];
  std::memcpy(res->term_ids, term_ids.data(),
              term_ids.size() * sizeof(int32_t));
  res->term_counts = new int32_t[term_counts.size() + 1];
  std::memcpy(res->term_counts, term_counts.data(),
              term_counts.size() * sizeof(int32_t));
  res->doc_lengths = new int32_t[doc_lengths.size() + 1];
  std::memcpy(res->doc_lengths, doc_lengths.data(),
              doc_lengths.size() * sizeof(int32_t));
  res->vocab_blob = new char[vocab_blob.size() + 1];
  std::memcpy(res->vocab_blob, vocab_blob.data(), vocab_blob.size());
  res->vocab_blob[vocab_blob.size()] = 0;
  res->vocab_offsets = new int64_t[vocab_offsets.size()];
  std::memcpy(res->vocab_offsets, vocab_offsets.data(),
              vocab_offsets.size() * sizeof(int64_t));
  return res;
}

}  // namespace

CorpusResult* bb25_build_corpus(const char* blob, const int64_t* offsets,
                                int64_t n_docs, int lowercase,
                                int remove_stop, int stem) {
  CorpusBuild b;
  std::vector<std::string> tokens;
  for (int64_t d = 0; d < n_docs; ++d) {
    tokens.clear();
    b.begin_doc();
    tokenize_one(blob + offsets[d], blob + offsets[d + 1], lowercase != 0,
                 remove_stop != 0, stem, &tokens);
    for (const auto& t : tokens) b.add_token(t.data(), t.size());
    b.end_doc((int32_t)tokens.size());
  }
  return pack_corpus(b);
}

// Pre-tokenized variant: tokens arrive as one NUL-joined blob (caller
// guarantees ASCII tokens without NUL) with per-doc token counts. This is
// the fresh-build fast path behind engine/index.py:build_index — vocab id
// assignment and per-doc ordering match the Python _corpus_to_csr
// (global/within-doc first-occurrence) bit-for-bit.
CorpusResult* bb25_build_corpus_tokens(const char* blob, int64_t blob_len,
                                       const int64_t* doc_counts,
                                       int64_t n_docs) {
  int64_t n_tokens = 0;
  for (int64_t d = 0; d < n_docs; ++d) n_tokens += doc_counts[d];

  std::vector<int64_t> tok_off;
  tok_off.reserve((size_t)n_tokens + 1);
  tok_off.push_back(0);
  const char* p = blob;
  const char* end = blob + blob_len;
  while (p < end) {
    const char* nul = (const char*)memchr(p, 0, (size_t)(end - p));
    if (!nul) break;
    tok_off.push_back(nul - blob);
    p = nul + 1;
  }
  tok_off.push_back(blob_len);
  if ((int64_t)tok_off.size() != n_tokens + 1) return nullptr;

  CorpusBuild b;
  int64_t i = 0;
  for (int64_t d = 0; d < n_docs; ++d) {
    b.begin_doc();
    for (int64_t j = 0; j < doc_counts[d]; ++j, ++i) {
      int64_t s = tok_off[i] + (i > 0 ? 1 : 0);
      b.add_token(blob + s, (size_t)(tok_off[i + 1] - s));
    }
    b.end_doc((int32_t)doc_counts[d]);
  }
  return pack_corpus(b);
}

void bb25_free_corpus(CorpusResult* res) {
  if (!res) return;
  delete[] res->doc_indptr;
  delete[] res->term_ids;
  delete[] res->term_counts;
  delete[] res->doc_lengths;
  delete[] res->vocab_blob;
  delete[] res->vocab_offsets;
  delete res;
}

// ----- Batch query encoding against a persistent vocabulary ----------------
//
// A VocabHandle owns a copy of the vocab blob and a string_view hashmap
// into it, so per-token lookups allocate nothing. Encoding dedups each
// query's in-vocabulary terms with multiplicities and returns flat
// (query, term, count) triples grouped by query (ascending) with term ids
// ascending within a query — bit-identical to the numpy np.unique path in
// engine/index.py:encode_queries / engine/split_index.py.

// Flat open-addressing table (linear probing, FNV-1a): one lookup is a
// hash + ~1 probe in a table that fits L2, vs unordered_map's chained
// nodes (2+ cache misses each). Measured ~2.5x on the batch-encode path.
struct VocabHandle {
  std::string blob;
  struct Slot {
    uint32_t hash;  // cached full hash; empty slots have id == -1
    int32_t id;
    int64_t off;
    int32_t len;
  };
  std::vector<Slot> slots;
  size_t mask = 0;

  static uint32_t fnv1a(const char* s, size_t n) {
    uint32_t h = 2166136261u;
    for (size_t i = 0; i < n; ++i) {
      h ^= (uint8_t)s[i];
      h *= 16777619u;
    }
    return h;
  }

  void build(const int64_t* offsets, int64_t n_vocab) {
    size_t cap = 16;
    while (cap < (size_t)n_vocab * 2) cap <<= 1;
    mask = cap - 1;
    slots.assign(cap, Slot{0, -1, 0, 0});
    for (int64_t i = 0; i < n_vocab; ++i) {
      int64_t off = offsets[i];
      int32_t len = (int32_t)(offsets[i + 1] - offsets[i]);
      uint32_t h = fnv1a(blob.data() + off, (size_t)len);
      size_t at = h & mask;
      while (slots[at].id != -1) at = (at + 1) & mask;
      slots[at] = Slot{h, (int32_t)i, off, len};
    }
  }

  int32_t find(const char* s, size_t n) const {
    uint32_t h = fnv1a(s, n);
    size_t at = h & mask;
    while (true) {
      const Slot& sl = slots[at];
      if (sl.id == -1) return -1;
      if (sl.hash == h && (size_t)sl.len == n &&
          std::memcmp(blob.data() + sl.off, s, n) == 0)
        return sl.id;
      at = (at + 1) & mask;
    }
  }
};

struct EncodeResult {
  int32_t* pair_q;  // n_pairs, query index (grouped ascending)
  int32_t* pair_t;  // n_pairs, term id (ascending within query)
  int32_t* pair_c;  // n_pairs, multiplicity
  int64_t n_pairs;
};

void* bb25_vocab_create(const char* blob, const int64_t* offsets,
                        int64_t n_vocab) {
  auto* h = new VocabHandle();
  h->blob.assign(blob, (size_t)offsets[n_vocab]);
  h->build(offsets, n_vocab);
  return h;
}

void bb25_vocab_free(void* h) { delete (VocabHandle*)h; }

namespace {

EncodeResult* pack_pairs(std::vector<int32_t>& pq, std::vector<int32_t>& pt,
                         std::vector<int32_t>& pc) {
  auto* res = new EncodeResult();
  res->n_pairs = (int64_t)pq.size();
  res->pair_q = new int32_t[pq.size() + 1];
  res->pair_t = new int32_t[pt.size() + 1];
  res->pair_c = new int32_t[pc.size() + 1];
  std::memcpy(res->pair_q, pq.data(), pq.size() * sizeof(int32_t));
  std::memcpy(res->pair_t, pt.data(), pt.size() * sizeof(int32_t));
  std::memcpy(res->pair_c, pc.data(), pc.size() * sizeof(int32_t));
  return res;
}

// Dedup one query's looked-up term ids into sorted (tid, count) pairs.
// Queries are short; a small vector + sort beats a hashmap here.
void emit_query(int32_t q, std::vector<int32_t>& tids,
                std::vector<int32_t>* pq, std::vector<int32_t>* pt,
                std::vector<int32_t>* pc) {
  if (tids.empty()) return;
  std::sort(tids.begin(), tids.end());
  for (size_t i = 0; i < tids.size();) {
    size_t j = i;
    while (j < tids.size() && tids[j] == tids[i]) ++j;
    pq->push_back(q);
    pt->push_back(tids[i]);
    pc->push_back((int32_t)(j - i));
    i = j;
  }
}

}  // namespace

EncodeResult* bb25_encode_tokens(void* vh, const char* blob,
                                 const int64_t* tok_offsets,
                                 const int64_t* q_offsets,
                                 int64_t n_queries) {
  auto* h = (VocabHandle*)vh;
  std::vector<int32_t> pq, pt, pc, tids;
  for (int64_t q = 0; q < n_queries; ++q) {
    tids.clear();
    for (int64_t i = q_offsets[q]; i < q_offsets[q + 1]; ++i) {
      int32_t id = h->find(blob + tok_offsets[i],
                           (size_t)(tok_offsets[i + 1] - tok_offsets[i]));
      if (id >= 0) tids.push_back(id);
    }
    emit_query((int32_t)q, tids, &pq, &pt, &pc);
  }
  return pack_pairs(pq, pt, pc);
}

// Separator-blob variant: tokens joined by '\0' (caller guarantees no
// token contains NUL). Boundary scan + hash lookups all happen here, so
// Python ships one join() — no per-token length pass. Lookup work is
// sharded across threads by query chunk; output order stays deterministic
// (chunks concatenate in order).
EncodeResult* bb25_encode_tokens_sep(void* vh, const char* blob,
                                     int64_t blob_len,
                                     const int64_t* q_counts,
                                     int64_t n_queries, int n_threads) {
  auto* h = (VocabHandle*)vh;
  int64_t n_tokens = 0;
  for (int64_t q = 0; q < n_queries; ++q) n_tokens += q_counts[q];

  // Token boundaries: n_tokens tokens joined by n_tokens-1 NULs.
  std::vector<int64_t> tok_off;
  tok_off.reserve((size_t)n_tokens + 1);
  tok_off.push_back(0);
  const char* p = blob;
  const char* end = blob + blob_len;
  while (p < end) {
    const char* nul = (const char*)memchr(p, 0, (size_t)(end - p));
    if (!nul) break;
    tok_off.push_back(nul - blob);
    p = nul + 1;
  }
  tok_off.push_back(blob_len);
  // Separator-count mismatch (e.g. a stray NUL) -> empty result; the
  // caller's pre-check makes this unreachable in practice.
  if ((int64_t)tok_off.size() != n_tokens + 1) {
    auto* res = new EncodeResult();
    res->n_pairs = 0;
    res->pair_q = new int32_t[1];
    res->pair_t = new int32_t[1];
    res->pair_c = new int32_t[1];
    return res;
  }

  std::vector<int64_t> q_off((size_t)n_queries + 1, 0);
  for (int64_t q = 0; q < n_queries; ++q) q_off[q + 1] = q_off[q] + q_counts[q];

  if (n_threads < 1) n_threads = 1;
  if (n_threads > (int)n_queries) n_threads = (int)(n_queries ? n_queries : 1);
  struct Chunk {
    std::vector<int32_t> pq, pt, pc;
  };
  std::vector<Chunk> chunks((size_t)n_threads);
  auto work = [&](int ti) {
    int64_t lo = n_queries * ti / n_threads;
    int64_t hi = n_queries * (ti + 1) / n_threads;
    std::vector<int32_t> tids;
    for (int64_t q = lo; q < hi; ++q) {
      tids.clear();
      for (int64_t i = q_off[q]; i < q_off[q + 1]; ++i) {
        // Joined-by-NUL layout: token i spans [tok_off[i] + (i>0),
        // tok_off[i+1]) — the +1 skips the separator byte.
        int64_t b = tok_off[i] + (i > 0 ? 1 : 0);
        int32_t id = h->find(blob + b, (size_t)(tok_off[i + 1] - b));
        if (id >= 0) tids.push_back(id);
      }
      emit_query((int32_t)q, tids, &chunks[ti].pq, &chunks[ti].pt,
                 &chunks[ti].pc);
    }
  };
  if (n_threads == 1) {
    work(0);
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(work, t);
    for (auto& t : threads) t.join();
  }

  size_t total = 0;
  for (auto& c : chunks) total += c.pq.size();
  auto* res = new EncodeResult();
  res->n_pairs = (int64_t)total;
  res->pair_q = new int32_t[total + 1];
  res->pair_t = new int32_t[total + 1];
  res->pair_c = new int32_t[total + 1];
  size_t at = 0;
  for (auto& c : chunks) {
    std::memcpy(res->pair_q + at, c.pq.data(), c.pq.size() * sizeof(int32_t));
    std::memcpy(res->pair_t + at, c.pt.data(), c.pt.size() * sizeof(int32_t));
    std::memcpy(res->pair_c + at, c.pc.data(), c.pc.size() * sizeof(int32_t));
    at += c.pq.size();
  }
  return res;
}

// Raw-text variant: tokenize (same pipeline as bb25_tokenize) and look up
// in one pass — query tokens never materialize host-side Python objects.
EncodeResult* bb25_encode_texts(void* vh, const char* blob,
                                const int64_t* offsets, int64_t n_queries,
                                int lowercase, int remove_stop, int stem) {
  auto* h = (VocabHandle*)vh;
  std::vector<int32_t> pq, pt, pc, tids;
  std::vector<std::string> tokens;
  for (int64_t q = 0; q < n_queries; ++q) {
    tokens.clear();
    tids.clear();
    tokenize_one(blob + offsets[q], blob + offsets[q + 1], lowercase != 0,
                 remove_stop != 0, stem, &tokens);
    for (const auto& t : tokens) {
      int32_t id = h->find(t.data(), t.size());
      if (id >= 0) tids.push_back(id);
    }
    emit_query((int32_t)q, tids, &pq, &pt, &pc);
  }
  return pack_pairs(pq, pt, pc);
}

void bb25_free_encode(EncodeResult* res) {
  if (!res) return;
  delete[] res->pair_q;
  delete[] res->pair_t;
  delete[] res->pair_c;
  delete res;
}

// ----- Split-index query encoding ------------------------------------------
//
// One native pass from the NUL-joined token blob to the PADDED arrays
// engine/split_index.py:encode_queries_split ships to the device:
// frequent-term (slot, count) rows for every query plus tail rows (term
// ids + counts) only for queries holding rare terms. Replaces the numpy
// np.unique/searchsorted group-by that followed bb25_encode_tokens_sep
// (the group-by cost ~2/3 of the host encode at 8192-query batches).
// Semantics are bit-identical: per query, in-vocabulary unique terms in
// ascending-term-id order, split by slot_of[tid] < K; Qf/Qt round up to
// the pad multiples (minimum one column); nt is the power-of-two bucket
// of the tail-query count (floor nt_min); pad slots carry K / query_pad
// and zero counts; pad tail rows point at query 0.

struct SplitEncodeResult {
  int32_t* fslots;  // (nq, Qf) row-major, pad K
  float* fcnt;      // (nq, Qf), pad 0
  int32_t* trows;   // (nt,), pad 0
  int32_t* qids;    // (nt, Qt), pad query_pad
  float* qcnt;      // (nt, Qt), pad 0
  int64_t nq, Qf, nt, Qt;
  int32_t has_pairs;  // 0 -> no query token was in vocabulary
};

SplitEncodeResult* bb25_encode_tokens_split(
    void* vh, const char* blob, int64_t blob_len, const int64_t* q_counts,
    int64_t n_queries, const int32_t* slot_of, int32_t K,
    int32_t query_pad, int32_t freq_pad, int32_t tail_pad,
    int32_t nt_min) {
  auto* h = (VocabHandle*)vh;
  int64_t n_tokens = 0;
  for (int64_t q = 0; q < n_queries; ++q) n_tokens += q_counts[q];

  auto* res = new SplitEncodeResult();
  res->nq = n_queries;
  res->has_pairs = 0;

  std::vector<int64_t> tok_off;
  tok_off.reserve((size_t)n_tokens + 1);
  tok_off.push_back(0);
  const char* p = blob;
  const char* end = blob + blob_len;
  while (p < end) {
    const char* nul = (const char*)memchr(p, 0, (size_t)(end - p));
    if (!nul) break;
    tok_off.push_back(nul - blob);
    p = nul + 1;
  }
  tok_off.push_back(blob_len);
  bool layout_ok = (int64_t)tok_off.size() == n_tokens + 1;

  // Pass 1: per-query sorted unique (tid, count) pairs, accumulated into
  // flat vectors with per-query (freq, tail) widths.
  std::vector<int32_t> all_t, all_c, tids;
  std::vector<int32_t> nf((size_t)n_queries, 0), ntl((size_t)n_queries, 0);
  all_t.reserve((size_t)n_tokens);
  all_c.reserve((size_t)n_tokens);
  int64_t maxf = 0, maxt = 0, n_tail_q = 0, tok_at = 0;
  if (layout_ok) {
    for (int64_t q = 0; q < n_queries; ++q) {
      tids.clear();
      for (int64_t i = tok_at; i < tok_at + q_counts[q]; ++i) {
        int64_t b = tok_off[i] + (i > 0 ? 1 : 0);
        int32_t id = h->find(blob + b, (size_t)(tok_off[i + 1] - b));
        if (id >= 0) tids.push_back(id);
      }
      tok_at += q_counts[q];
      if (tids.empty()) continue;
      std::sort(tids.begin(), tids.end());
      int32_t f = 0, t = 0;
      for (size_t i = 0; i < tids.size();) {
        size_t j = i;
        while (j < tids.size() && tids[j] == tids[i]) ++j;
        all_t.push_back(tids[i]);
        all_c.push_back((int32_t)(j - i));
        if (slot_of[tids[i]] < K) ++f; else ++t;
        i = j;
      }
      nf[(size_t)q] = f;
      ntl[(size_t)q] = t;
      if (f > maxf) maxf = f;
      if (t > maxt) maxt = t;
      if (t > 0) ++n_tail_q;
      res->has_pairs = 1;
    }
  }

  auto round_up = [](int64_t x, int64_t m) { return (x + m - 1) / m * m; };
  int64_t Qf = round_up(maxf > 0 ? maxf : 1, freq_pad);
  int64_t Qt = round_up(maxt > 0 ? maxt : 1, tail_pad);
  int64_t nt = nt_min;
  while (nt < n_tail_q) nt *= 2;
  res->Qf = Qf;
  res->Qt = Qt;
  res->nt = nt;

  res->fslots = new int32_t[(size_t)(n_queries * Qf)];
  res->fcnt = new float[(size_t)(n_queries * Qf)]();
  res->trows = new int32_t[(size_t)nt]();
  res->qids = new int32_t[(size_t)(nt * Qt)];
  res->qcnt = new float[(size_t)(nt * Qt)]();
  std::fill_n(res->fslots, n_queries * Qf, K);
  std::fill_n(res->qids, nt * Qt, query_pad);

  if (res->has_pairs) {
    int64_t at = 0, trow = 0;
    for (int64_t q = 0; q < n_queries; ++q) {
      int64_t w = nf[(size_t)q] + ntl[(size_t)q];
      int64_t fcol = 0, tcol = 0;
      int32_t* frow = res->fslots + q * Qf;
      float* fcrow = res->fcnt + q * Qf;
      int32_t* qrow = nullptr;
      float* qcrow = nullptr;
      if (ntl[(size_t)q] > 0) {
        res->trows[trow] = (int32_t)q;
        qrow = res->qids + trow * Qt;
        qcrow = res->qcnt + trow * Qt;
        ++trow;
      }
      for (int64_t i = at; i < at + w; ++i) {
        int32_t tid = all_t[(size_t)i];
        int32_t slot = slot_of[tid];
        if (slot < K) {
          frow[fcol] = slot;
          fcrow[fcol] = (float)all_c[(size_t)i];
          ++fcol;
        } else {
          qrow[tcol] = tid;
          qcrow[tcol] = (float)all_c[(size_t)i];
          ++tcol;
        }
      }
      at += w;
    }
  }
  return res;
}

void bb25_free_encode_split(SplitEncodeResult* res) {
  if (!res) return;
  delete[] res->fslots;
  delete[] res->fcnt;
  delete[] res->trows;
  delete[] res->qids;
  delete[] res->qcnt;
  delete res;
}

// ----- JSONL corpus loader (BEIR format) -----------------------------------
//
// Parses corpus/queries .jsonl files ({"_id", "title", "text", ...} per
// line) without materializing per-document Python strings: documents come
// back as concatenated blobs + offsets, ready for bb25_build_corpus. The
// parser walks each top-level object with depth tracking, so a "text" key
// inside a nested "metadata" object is never mistaken for the document
// text.

namespace {

// Append the decoded value of the JSON string starting at *p (after the
// opening quote) to out; advances *p past the closing quote. Returns
// false on malformed input.
bool decode_json_string(const char** p, const char* end, std::string* out) {
  const char* s = *p;
  while (s < end) {
    // Bulk-copy the run up to the next quote or escape: per-byte pushes
    // lose to Python's C json; memchr-driven runs win ~4x.
    const char* run = s;
    while (run < end && *run != '"' && *run != '\\') ++run;
    if (run > s) {
      out->append(s, (size_t)(run - s));
      s = run;
    }
    if (s >= end) break;
    char c = *s++;
    if (c == '"') {
      *p = s;
      return true;
    }
    if (c != '\\') {
      out->push_back(c);
      continue;
    }
    if (s >= end) return false;
    char e = *s++;
    switch (e) {
      case '"': out->push_back('"'); break;
      case '\\': out->push_back('\\'); break;
      case '/': out->push_back('/'); break;
      case 'b': out->push_back('\b'); break;
      case 'f': out->push_back('\f'); break;
      case 'n': out->push_back('\n'); break;
      case 'r': out->push_back('\r'); break;
      case 't': out->push_back('\t'); break;
      case 'u': {
        if (end - s < 4) return false;
        auto hex4 = [](const char* q) -> int {
          int v = 0;
          for (int i = 0; i < 4; ++i) {
            char h = q[i];
            v <<= 4;
            if (h >= '0' && h <= '9') v |= h - '0';
            else if (h >= 'a' && h <= 'f') v |= h - 'a' + 10;
            else if (h >= 'A' && h <= 'F') v |= h - 'A' + 10;
            else return -1;
          }
          return v;
        };
        int cp = hex4(s);
        if (cp < 0) return false;
        s += 4;
        if (cp >= 0xD800 && cp <= 0xDBFF && end - s >= 6 && s[0] == '\\' &&
            s[1] == 'u') {
          int lo = hex4(s + 2);
          if (lo >= 0xDC00 && lo <= 0xDFFF) {
            cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
            s += 6;
          }
        }
        // UTF-8 encode
        if (cp < 0x80) {
          out->push_back((char)cp);
        } else if (cp < 0x800) {
          out->push_back((char)(0xC0 | (cp >> 6)));
          out->push_back((char)(0x80 | (cp & 0x3F)));
        } else if (cp < 0x10000) {
          out->push_back((char)(0xE0 | (cp >> 12)));
          out->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
          out->push_back((char)(0x80 | (cp & 0x3F)));
        } else {
          out->push_back((char)(0xF0 | (cp >> 18)));
          out->push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
          out->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
          out->push_back((char)(0x80 | (cp & 0x3F)));
        }
        break;
      }
      default:
        return false;
    }
  }
  return false;
}

// Skip any JSON value starting at *p (string/number/bool/null/object/
// array), advancing past it. Depth-tracked; strings skipped with escape
// awareness.
bool skip_json_value(const char** p, const char* end) {
  const char* s = *p;
  while (s < end && (*s == ' ' || *s == '\t')) ++s;
  if (s >= end) return false;
  if (*s == '"') {
    ++s;
    while (s < end) {
      if (*s == '\\') { s += 2; continue; }
      if (*s == '"') { *p = s + 1; return true; }
      ++s;
    }
    return false;
  }
  if (*s == '{' || *s == '[') {
    int depth = 0;
    while (s < end) {
      char c = *s;
      if (c == '"') {
        ++s;
        while (s < end) {
          if (*s == '\\') { s += 2; continue; }
          if (*s == '"') break;
          ++s;
        }
        if (s >= end) return false;
        ++s;
        continue;
      }
      if (c == '{' || c == '[') ++depth;
      if (c == '}' || c == ']') {
        --depth;
        if (depth == 0) { *p = s + 1; return true; }
      }
      ++s;
    }
    return false;
  }
  // number / true / false / null: scan to a delimiter
  while (s < end && *s != ',' && *s != '}' && *s != ']') ++s;
  *p = s;
  return true;
}

// Parse one top-level JSONL object, extracting "_id", "title", "text"
// (any order, depth 1 only; first occurrence wins). Values decode
// DIRECTLY into the caller's accumulator blobs — no per-doc temporaries.
// Missing keys append nothing (the caller's offsets handle empties).
bool parse_beir_line(const char* line, const char* end, std::string* id,
                     std::string* title, std::string* text) {
  const char* s = line;
  while (s < end && *s != '{') ++s;
  if (s >= end) return false;
  ++s;
  bool saw_id = false, saw_title = false, saw_text = false;
  while (s < end) {
    while (s < end && (*s == ' ' || *s == '\t' || *s == ',')) ++s;
    if (s < end && *s == '}') return true;
    if (s >= end || *s != '"') return false;
    ++s;
    std::string key;
    if (!decode_json_string(&s, end, &key)) return false;
    while (s < end && (*s == ' ' || *s == '\t')) ++s;
    if (s >= end || *s != ':') return false;
    ++s;
    while (s < end && (*s == ' ' || *s == '\t')) ++s;
    std::string* target = nullptr;
    if (key == "_id" && !saw_id) { target = id; saw_id = true; }
    else if (key == "title" && !saw_title) { target = title; saw_title = true; }
    else if (key == "text" && !saw_text) { target = text; saw_text = true; }
    if (target != nullptr && s < end && *s == '"') {
      ++s;
      if (!decode_json_string(&s, end, target)) return false;
    } else if (target == id && s < end && *s != '{' && *s != '[') {
      // Non-string scalar _id (number/bool/null): BEIR exports from some
      // tools emit integer ids. Stringify the raw token so the document
      // is kept, matching the Python fallback's str(row["_id"]).
      const char* tok0 = s;
      if (!skip_json_value(&s, end)) return false;
      const char* tok1 = s;
      while (tok1 > tok0 && (tok1[-1] == ' ' || tok1[-1] == '\t')) --tok1;
      id->append(tok0, (size_t)(tok1 - tok0));
    } else {
      if (!skip_json_value(&s, end)) return false;
    }
  }
  return true;
}

}  // namespace

struct JsonlResult {
  char* id_blob;
  int64_t* id_offsets;
  char* title_blob;
  int64_t* title_offsets;
  char* text_blob;
  int64_t* text_offsets;
  int64_t n_docs;
  int64_t id_blob_size;
  int64_t title_blob_size;
  int64_t text_blob_size;
};

JsonlResult* bb25_load_jsonl(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  std::string data;
  char buf[1 << 16];
  size_t n;
  while ((n = fread(buf, 1, sizeof(buf), f)) > 0) data.append(buf, n);
  fclose(f);

  std::string ids, titles, texts;
  std::vector<int64_t> id_off{0}, title_off{0}, text_off{0};
  ids.reserve(data.size() / 16);
  texts.reserve(data.size());
  const char* p = data.data();
  const char* end = p + data.size();
  while (p < end) {
    const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
    const char* line_end = nl ? nl : end;
    if (line_end > p) {
      // Decode directly into the big blobs (no per-doc temp strings);
      // roll back on lines without an "_id".
      size_t id0 = ids.size(), ti0 = titles.size(), tx0 = texts.size();
      if (parse_beir_line(p, line_end, &ids, &titles, &texts)
          && ids.size() > id0) {
        id_off.push_back((int64_t)ids.size());
        title_off.push_back((int64_t)titles.size());
        text_off.push_back((int64_t)texts.size());
      } else {
        ids.resize(id0);
        titles.resize(ti0);
        texts.resize(tx0);
      }
    }
    p = nl ? nl + 1 : end;
  }

  auto* res = new JsonlResult();
  res->n_docs = (int64_t)id_off.size() - 1;
  auto pack_str = [](const std::string& s, char** blob, int64_t* size) {
    *blob = new char[s.size() + 1];
    std::memcpy(*blob, s.data(), s.size());
    (*blob)[s.size()] = 0;
    *size = (int64_t)s.size();
  };
  auto pack_off = [](const std::vector<int64_t>& v) {
    auto* o = new int64_t[v.size()];
    std::memcpy(o, v.data(), v.size() * sizeof(int64_t));
    return o;
  };
  pack_str(ids, &res->id_blob, &res->id_blob_size);
  pack_str(titles, &res->title_blob, &res->title_blob_size);
  pack_str(texts, &res->text_blob, &res->text_blob_size);
  res->id_offsets = pack_off(id_off);
  res->title_offsets = pack_off(title_off);
  res->text_offsets = pack_off(text_off);
  return res;
}

void bb25_free_jsonl(JsonlResult* res) {
  if (!res) return;
  delete[] res->id_blob;
  delete[] res->id_offsets;
  delete[] res->title_blob;
  delete[] res->title_offsets;
  delete[] res->text_blob;
  delete[] res->text_offsets;
  delete res;
}

// Build a corpus directly from a text blob + offsets (e.g. straight from
// bb25_load_jsonl's text arrays) — the document texts never exist as
// individual host-language strings.
CorpusResult* bb25_build_corpus_blob(const char* blob,
                                     const int64_t* offsets, int64_t n_docs,
                                     int lowercase, int remove_stop,
                                     int stem) {
  return bb25_build_corpus(blob, offsets, n_docs, lowercase, remove_stop,
                           stem);
}

}  // extern "C"
