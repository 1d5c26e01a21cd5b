// Fast in-situ JSON parser (C ABI).
//
// Fills the role of the reference's vendored gason C++ JSON parser
// (reference: cocoapi/common/gason.{h,cpp} — used by cocoapi's
// Matlab/Lua front-ends; the Python path parses with json.load). This
// implementation provides a validating tokenizer + DOM usable from C++
// and a ctypes-facing validation/stat entry point so the capability is
// exercised and testable from Python. A copy of icd_tpu/native/json.cpp,
// built with maskapi.cpp into one library (icd_tpu_torch/native/mask.py).

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum class Tag : uint8_t {
  kNumber, kString, kArray, kObject, kTrue, kFalse, kNull
};

struct Node {
  Tag tag;
  double number = 0;
  // string view into the source buffer
  const char* str = nullptr;
  size_t str_len = 0;
  // children (arrays: values; objects: alternating key-node/value-node)
  std::vector<uint32_t> children;
};

struct Parser {
  const char* p;
  const char* end;
  std::vector<Node>* nodes;
  bool ok = true;

  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
  }

  bool consume(char c) {
    skip_ws();
    if (p < end && *p == c) { ++p; return true; }
    return false;
  }

  uint32_t fail() { ok = false; return UINT32_MAX; }

  uint32_t parse_string_node() {
    // assumes leading '"' consumed by caller check
    if (p >= end || *p != '"') return fail();
    ++p;
    const char* start = p;
    while (p < end && *p != '"') {
      if (*p == '\\') {
        ++p;
        if (p >= end) return fail();
        switch (*p) {
          case '"': case '\\': case '/': case 'b': case 'f':
          case 'n': case 'r': case 't': break;
          case 'u':
            for (int i = 0; i < 4; ++i) {
              ++p;
              if (p >= end || !std::isxdigit(
                      static_cast<unsigned char>(*p)))
                return fail();
            }
            break;
          default: return fail();
        }
      }
      ++p;
    }
    if (p >= end) return fail();
    Node n;
    n.tag = Tag::kString;
    n.str = start;
    n.str_len = static_cast<size_t>(p - start);
    ++p;  // closing quote
    nodes->push_back(std::move(n));
    return static_cast<uint32_t>(nodes->size() - 1);
  }

  uint32_t parse_value() {
    skip_ws();
    if (p >= end) return fail();
    const char c = *p;
    if (c == '{') {
      ++p;
      Node n;
      n.tag = Tag::kObject;
      const uint32_t self = static_cast<uint32_t>(nodes->size());
      nodes->push_back(std::move(n));
      skip_ws();
      if (consume('}')) return self;
      while (true) {
        skip_ws();
        const uint32_t key = parse_string_node();
        if (!ok) return UINT32_MAX;
        if (!consume(':')) return fail();
        const uint32_t val = parse_value();
        if (!ok) return UINT32_MAX;
        (*nodes)[self].children.push_back(key);
        (*nodes)[self].children.push_back(val);
        if (consume(',')) continue;
        if (consume('}')) return self;
        return fail();
      }
    }
    if (c == '[') {
      ++p;
      Node n;
      n.tag = Tag::kArray;
      const uint32_t self = static_cast<uint32_t>(nodes->size());
      nodes->push_back(std::move(n));
      if (consume(']')) return self;
      while (true) {
        const uint32_t val = parse_value();
        if (!ok) return UINT32_MAX;
        (*nodes)[self].children.push_back(val);
        if (consume(',')) continue;
        if (consume(']')) return self;
        return fail();
      }
    }
    if (c == '"') return parse_string_node();
    if (c == 't') {
      if (end - p >= 4 && std::strncmp(p, "true", 4) == 0) {
        p += 4;
        nodes->push_back(Node{Tag::kTrue});
        return static_cast<uint32_t>(nodes->size() - 1);
      }
      return fail();
    }
    if (c == 'f') {
      if (end - p >= 5 && std::strncmp(p, "false", 5) == 0) {
        p += 5;
        nodes->push_back(Node{Tag::kFalse});
        return static_cast<uint32_t>(nodes->size() - 1);
      }
      return fail();
    }
    if (c == 'n') {
      if (end - p >= 4 && std::strncmp(p, "null", 4) == 0) {
        p += 4;
        nodes->push_back(Node{Tag::kNull});
        return static_cast<uint32_t>(nodes->size() - 1);
      }
      return fail();
    }
    // number — enforce the JSON grammar before strtod (which would
    // also accept '+1', '.5', '1.', hex, inf/nan).
    const char* q = p;
    if (q < end && *q == '-') ++q;
    if (q >= end || !std::isdigit(static_cast<unsigned char>(*q)))
      return fail();
    if (*q == '0') {
      ++q;
    } else {
      while (q < end && std::isdigit(static_cast<unsigned char>(*q))) ++q;
    }
    if (q < end && *q == '.') {
      ++q;
      if (q >= end || !std::isdigit(static_cast<unsigned char>(*q)))
        return fail();
      while (q < end && std::isdigit(static_cast<unsigned char>(*q))) ++q;
    }
    if (q < end && (*q == 'e' || *q == 'E')) {
      ++q;
      if (q < end && (*q == '+' || *q == '-')) ++q;
      if (q >= end || !std::isdigit(static_cast<unsigned char>(*q)))
        return fail();
      while (q < end && std::isdigit(static_cast<unsigned char>(*q))) ++q;
    }
    const std::string token(p, q);
    const double v = std::strtod(token.c_str(), nullptr);
    p = q;
    Node n;
    n.tag = Tag::kNumber;
    n.number = v;
    nodes->push_back(std::move(n));
    return static_cast<uint32_t>(nodes->size() - 1);
  }
};

}  // namespace

extern "C" {

// Parse and validate a JSON document. Returns 1 when valid; fills
// counts: [total_nodes, objects, arrays, strings, numbers, bools+nulls]
// and numeric_sum with the sum of all numbers (a cheap content
// fingerprint used by tests).
int icd_json_validate(const char* data, uint64_t len, uint64_t* counts,
                      double* numeric_sum) {
  std::vector<Node> nodes;
  Parser parser{data, data + len, &nodes};
  const uint32_t root = parser.parse_value();
  parser.skip_ws();
  if (!parser.ok || root == UINT32_MAX || parser.p != parser.end) return 0;

  uint64_t objs = 0, arrs = 0, strs = 0, nums = 0, lits = 0;
  double sum = 0;
  for (const Node& n : nodes) {
    switch (n.tag) {
      case Tag::kObject: ++objs; break;
      case Tag::kArray: ++arrs; break;
      case Tag::kString: ++strs; break;
      case Tag::kNumber: ++nums; sum += n.number; break;
      default: ++lits; break;
    }
  }
  if (counts) {
    counts[0] = nodes.size();
    counts[1] = objs;
    counts[2] = arrs;
    counts[3] = strs;
    counts[4] = nums;
    counts[5] = lits;
  }
  if (numeric_sum) *numeric_sum = sum;
  return 1;
}

}  // extern "C"
