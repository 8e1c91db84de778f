// picklite — a pickle-subset codec for the ray_tpu_torch wire protocol.
//
// The control plane frames every message as <u64 LE length><pickle bytes>
// (ref equivalent: the protobuf wire schemas under src/ray/protobuf/; here the
// schema is "python pickle of plain dicts", so native peers need a codec for
// exactly that subset). This header implements:
//
//   decode: the opcodes CPython's pickle protocol 5 emits for our envelopes —
//     dicts/lists/tuples/str/bytes/int/float/bool/None, memoization, framing,
//     out-of-band buffers (surfaced as bytes), and REDUCE-constructed objects
//     (TaskID/ObjectID/...) surfaced as Opaque{module, name, args}.
//   encode: a canonical subset (protocol 2 ops inside a protocol-5 header)
//     that CPython unpickles natively, including GLOBAL+REDUCE so native code
//     can raise real Python exception types on the driver.
//
// No Python, no dependencies. Header-only, C++17.
#pragma once

#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <stdexcept>
#include <string>
#include <utility>
#include <vector>

namespace picklite {

struct Value;
using ValuePtr = std::shared_ptr<Value>;

struct Value {
  enum Kind { kNone, kBool, kInt, kFloat, kStr, kBytes, kList, kTuple, kDict, kOpaque };
  Kind kind = kNone;
  bool b = false;
  int64_t i = 0;
  double d = 0.0;
  std::string s;                  // kStr / kBytes payload
  std::vector<ValuePtr> items;    // kList / kTuple elements; kOpaque ctor args
  std::vector<std::pair<ValuePtr, ValuePtr>> dict;  // kDict entries (insertion order)
  std::string mod, name;          // kOpaque: module + qualname of the callable

  static ValuePtr none() { return std::make_shared<Value>(); }
  static ValuePtr boolean(bool v) { auto p = std::make_shared<Value>(); p->kind = kBool; p->b = v; return p; }
  static ValuePtr integer(int64_t v) { auto p = std::make_shared<Value>(); p->kind = kInt; p->i = v; return p; }
  static ValuePtr real(double v) { auto p = std::make_shared<Value>(); p->kind = kFloat; p->d = v; return p; }
  static ValuePtr str(std::string v) { auto p = std::make_shared<Value>(); p->kind = kStr; p->s = std::move(v); return p; }
  static ValuePtr bytes(std::string v) { auto p = std::make_shared<Value>(); p->kind = kBytes; p->s = std::move(v); return p; }
  static ValuePtr list() { auto p = std::make_shared<Value>(); p->kind = kList; return p; }
  static ValuePtr tuple() { auto p = std::make_shared<Value>(); p->kind = kTuple; return p; }
  static ValuePtr dict_() { auto p = std::make_shared<Value>(); p->kind = kDict; return p; }
  static ValuePtr opaque(std::string m, std::string n) {
    auto p = std::make_shared<Value>(); p->kind = kOpaque; p->mod = std::move(m); p->name = std::move(n); return p;
  }

  // dict lookup by string key; nullptr when missing
  ValuePtr get(const std::string& key) const {
    for (auto& kv : dict)
      if (kv.first && kv.first->kind == kStr && kv.first->s == key) return kv.second;
    return nullptr;
  }
  void set(const std::string& key, ValuePtr v) {
    for (auto& kv : dict)
      if (kv.first && kv.first->kind == kStr && kv.first->s == key) { kv.second = std::move(v); return; }
    dict.emplace_back(Value::str(key), std::move(v));
  }
  bool truthy() const {
    switch (kind) {
      case kNone: return false;
      case kBool: return b;
      case kInt: return i != 0;
      case kFloat: return d != 0;
      case kStr: case kBytes: return !s.empty();
      case kList: case kTuple: return !items.empty();
      case kDict: return !dict.empty();
      default: return true;
    }
  }
};

class Error : public std::runtime_error {
 public:
  explicit Error(const std::string& m) : std::runtime_error("picklite: " + m) {}
};

// ------------------------------------------------------------------ decoder

class Decoder {
 public:
  // `buffers`: out-of-band pickle-5 buffers (NEXT_BUFFER pops in order),
  // surfaced to the value tree as kBytes.
  explicit Decoder(const uint8_t* data, size_t n,
                   std::vector<std::string> buffers = {})
      : p_(data), end_(data + n), buffers_(std::move(buffers)) {}

  ValuePtr parse() {
    std::vector<ValuePtr> stack;
    std::vector<size_t> marks;
    while (p_ < end_) {
      uint8_t op = *p_++;
      switch (op) {
        case 0x80: /*PROTO*/ need(1); ++p_; break;
        case 0x95: /*FRAME*/ need(8); p_ += 8; break;  // framing is advisory
        case '.': /*STOP*/
          if (stack.empty()) throw Error("STOP with empty stack");
          return stack.back();
        case 'N': stack.push_back(Value::none()); break;
        case 0x88: stack.push_back(Value::boolean(true)); break;
        case 0x89: stack.push_back(Value::boolean(false)); break;
        case 'K': /*BININT1*/ need(1); stack.push_back(Value::integer(*p_++)); break;
        case 'M': /*BININT2*/ { need(2); uint16_t v = rd16(); stack.push_back(Value::integer(v)); break; }
        case 'J': /*BININT*/ { need(4); int32_t v = (int32_t)rd32(); stack.push_back(Value::integer(v)); break; }
        case 0x8a: /*LONG1*/ { need(1); uint8_t n = *p_++; stack.push_back(Value::integer(rdlong(n))); break; }
        case 0x8b: /*LONG4*/ { need(4); uint32_t n = rd32(); stack.push_back(Value::integer(rdlong(n))); break; }
        case 'G': /*BINFLOAT (big-endian!)*/ {
          need(8);
          uint64_t u = 0;
          for (int k = 0; k < 8; ++k) u = (u << 8) | *p_++;
          double d; std::memcpy(&d, &u, 8);
          stack.push_back(Value::real(d));
          break;
        }
        case 0x8c: /*SHORT_BINUNICODE*/ { need(1); size_t n = *p_++; stack.push_back(Value::str(rdstr(n))); break; }
        case 'X': /*BINUNICODE*/ { need(4); size_t n = rd32(); stack.push_back(Value::str(rdstr(n))); break; }
        case 0x8d: /*BINUNICODE8*/ { need(8); size_t n = (size_t)rd64(); stack.push_back(Value::str(rdstr(n))); break; }
        case 'C': /*SHORT_BINBYTES*/ { need(1); size_t n = *p_++; stack.push_back(Value::bytes(rdstr(n))); break; }
        case 'B': /*BINBYTES*/ { need(4); size_t n = rd32(); stack.push_back(Value::bytes(rdstr(n))); break; }
        case 0x8e: /*BINBYTES8*/ { need(8); size_t n = (size_t)rd64(); stack.push_back(Value::bytes(rdstr(n))); break; }
        case 0x96: /*BYTEARRAY8*/ { need(8); size_t n = (size_t)rd64(); stack.push_back(Value::bytes(rdstr(n))); break; }
        case 0x97: /*NEXT_BUFFER*/ {
          if (buf_idx_ >= buffers_.size()) throw Error("NEXT_BUFFER underflow");
          stack.push_back(Value::bytes(buffers_[buf_idx_++]));
          break;
        }
        case 0x98: /*READONLY_BUFFER*/ break;  // view flag: no-op for us
        case ')': stack.push_back(Value::tuple()); break;
        case ']': stack.push_back(Value::list()); break;
        case '}': stack.push_back(Value::dict_()); break;
        case 0x8f: /*EMPTY_SET*/ stack.push_back(Value::list()); break;  // set ~ list
        case '(': /*MARK*/ marks.push_back(stack.size()); break;
        case 0x85: /*TUPLE1*/ collapse_tuple(stack, 1); break;
        case 0x86: /*TUPLE2*/ collapse_tuple(stack, 2); break;
        case 0x87: /*TUPLE3*/ collapse_tuple(stack, 3); break;
        case 't': /*TUPLE*/ {
          size_t m = pop_mark(marks);
          auto t = Value::tuple();
          t->items.assign(stack.begin() + m, stack.end());
          stack.resize(m);
          stack.push_back(t);
          break;
        }
        case 'a': /*APPEND*/ {
          auto v = pop(stack);
          top_kind(stack, Value::kList)->items.push_back(v);
          break;
        }
        case 'e': /*APPENDS*/ {
          size_t m = pop_mark(marks);
          auto lst = at_kind(stack, m - 1, Value::kList);
          lst->items.insert(lst->items.end(), stack.begin() + m, stack.end());
          stack.resize(m);
          break;
        }
        case 0x90: /*ADDITEMS (set)*/ {
          size_t m = pop_mark(marks);
          auto lst = at_kind(stack, m - 1, Value::kList);
          lst->items.insert(lst->items.end(), stack.begin() + m, stack.end());
          stack.resize(m);
          break;
        }
        case 's': /*SETITEM*/ {
          auto v = pop(stack), k = pop(stack);
          top_kind(stack, Value::kDict)->dict.emplace_back(k, v);
          break;
        }
        case 'u': /*SETITEMS*/ {
          size_t m = pop_mark(marks);
          auto d = at_kind(stack, m - 1, Value::kDict);
          if ((stack.size() - m) % 2) throw Error("odd SETITEMS");
          for (size_t k = m; k < stack.size(); k += 2)
            d->dict.emplace_back(stack[k], stack[k + 1]);
          stack.resize(m);
          break;
        }
        case 0x94: /*MEMOIZE*/ {
          if (stack.empty()) throw Error("MEMOIZE empty");
          memo_.push_back(stack.back());
          break;
        }
        case 'q': /*BINPUT*/ { need(1); size_t n = *p_++; put_memo(n, stack); break; }
        case 'r': /*LONG_BINPUT*/ { need(4); size_t n = rd32(); put_memo(n, stack); break; }
        case 'h': /*BINGET*/ { need(1); size_t n = *p_++; get_memo(n, stack); break; }
        case 'j': /*LONG_BINGET*/ { need(4); size_t n = rd32(); get_memo(n, stack); break; }
        case 0x93: /*STACK_GLOBAL*/ {
          auto name = pop(stack), mod = pop(stack);
          if (mod->kind != Value::kStr || name->kind != Value::kStr)
            throw Error("STACK_GLOBAL wants strings");
          stack.push_back(Value::opaque(mod->s, name->s));
          break;
        }
        case 'c': /*GLOBAL (newline text)*/ {
          std::string mod = rdline(), name = rdline();
          stack.push_back(Value::opaque(mod, name));
          break;
        }
        case 'R': /*REDUCE*/ {
          auto args = pop(stack), fn = pop(stack);
          stack.push_back(reduce(fn, args));
          break;
        }
        case 0x81: /*NEWOBJ*/ {
          auto args = pop(stack), cls = pop(stack);
          stack.push_back(reduce(cls, args));
          break;
        }
        case 0x92: /*NEWOBJ_EX*/ {
          pop(stack);  // kwargs
          auto args = pop(stack), cls = pop(stack);
          stack.push_back(reduce(cls, args));
          break;
        }
        case 'b': /*BUILD*/ { pop(stack); break; }  // drop state: opaque stays opaque
        default:
          throw Error("unsupported opcode 0x" + hex(op));
      }
    }
    throw Error("ran out of input before STOP");
  }

 private:
  const uint8_t* p_;
  const uint8_t* end_;
  std::vector<ValuePtr> memo_;
  std::map<size_t, ValuePtr> memo_map_;  // for BINPUT-addressed memos
  std::vector<std::string> buffers_;
  size_t buf_idx_ = 0;

  static std::string hex(uint8_t v) {
    static const char* digits = "0123456789abcdef";
    return std::string(1, digits[v >> 4]) + std::string(1, digits[v & 0xf]);
  }
  void need(size_t n) { if ((size_t)(end_ - p_) < n) throw Error("truncated"); }
  uint16_t rd16() { uint16_t v = p_[0] | (p_[1] << 8); p_ += 2; return v; }
  uint32_t rd32() { uint32_t v; std::memcpy(&v, p_, 4); p_ += 4; return v; }
  uint64_t rd64() { uint64_t v; std::memcpy(&v, p_, 8); p_ += 8; return v; }
  int64_t rdlong(size_t n) {
    need(n);
    if (n > 8) throw Error("LONG too wide for int64");
    uint64_t v = 0;
    for (size_t k = 0; k < n; ++k) v |= (uint64_t)p_[k] << (8 * k);
    if (n > 0 && n < 8 && (p_[n - 1] & 0x80)) v |= ~0ULL << (8 * n);  // sign-extend
    p_ += n;
    return (int64_t)v;
  }
  std::string rdstr(size_t n) { need(n); std::string s((const char*)p_, n); p_ += n; return s; }
  std::string rdline() {
    std::string s;
    while (p_ < end_ && *p_ != '\n') s.push_back((char)*p_++);
    if (p_ < end_) ++p_;
    return s;
  }
  static ValuePtr pop(std::vector<ValuePtr>& st) {
    if (st.empty()) throw Error("stack underflow");
    auto v = st.back(); st.pop_back(); return v;
  }
  static size_t pop_mark(std::vector<size_t>& marks) {
    if (marks.empty()) throw Error("no mark");
    size_t m = marks.back(); marks.pop_back(); return m;
  }
  static ValuePtr top_kind(std::vector<ValuePtr>& st, Value::Kind k) {
    if (st.empty() || st.back()->kind != k) throw Error("bad container on stack");
    return st.back();
  }
  static ValuePtr at_kind(std::vector<ValuePtr>& st, size_t idx, Value::Kind k) {
    if (idx >= st.size() || st[idx]->kind != k) throw Error("bad container at mark");
    return st[idx];
  }
  static void collapse_tuple(std::vector<ValuePtr>& st, size_t n) {
    if (st.size() < n) throw Error("tuple underflow");
    auto t = Value::tuple();
    t->items.assign(st.end() - n, st.end());
    st.resize(st.size() - n);
    st.push_back(t);
  }
  void put_memo(size_t n, std::vector<ValuePtr>& st) {
    if (st.empty()) throw Error("PUT empty");
    memo_map_[n] = st.back();
  }
  void get_memo(size_t n, std::vector<ValuePtr>& st) {
    auto it = memo_map_.find(n);
    if (it != memo_map_.end()) { st.push_back(it->second); return; }
    if (n < memo_.size()) { st.push_back(memo_[n]); return; }
    throw Error("memo miss");
  }
  // Callable application: keep REDUCE results opaque, carrying the ctor args
  // (enough to round-trip TaskID/ObjectID/... and to read e.g. id bytes).
  static ValuePtr reduce(const ValuePtr& fn, const ValuePtr& args) {
    auto v = Value::opaque(fn->mod, fn->name);
    if (fn->kind != Value::kOpaque) return v;  // degenerate; still opaque
    if (args->kind == Value::kTuple) v->items = args->items;
    else v->items.push_back(args);
    return v;
  }
};

// ------------------------------------------------------------------ encoder

class Encoder {
 public:
  std::string out;

  void header() { out += '\x80'; out += '\x05'; }  // PROTO 5 (ops below are <=2)
  void stop() { out += '.'; }

  void encode(const Value& v) {
    switch (v.kind) {
      case Value::kNone: out += 'N'; break;
      case Value::kBool: out += (v.b ? '\x88' : '\x89'); break;
      case Value::kInt: enc_int(v.i); break;
      case Value::kFloat: enc_float(v.d); break;
      case Value::kStr: enc_str(v.s); break;
      case Value::kBytes: enc_bytes(v.s); break;
      case Value::kTuple: enc_tuple(v.items); break;
      case Value::kList: {
        out += ']';
        if (!v.items.empty()) {
          out += '(';
          for (auto& it : v.items) encode(*it);
          out += 'e';
        }
        break;
      }
      case Value::kDict: {
        out += '}';
        if (!v.dict.empty()) {
          out += '(';
          for (auto& kv : v.dict) { encode(*kv.first); encode(*kv.second); }
          out += 'u';
        }
        break;
      }
      case Value::kOpaque: {
        // GLOBAL module\nname\n + args tuple + REDUCE: unpickles to
        // module.name(*args) on the Python side (how native code raises
        // e.g. ray_tpu_torch.core.ref.TaskError on the driver).
        out += 'c';
        out += v.mod; out += '\n';
        out += v.name; out += '\n';
        enc_tuple(v.items);
        out += 'R';
        break;
      }
    }
  }

  static std::string dumps(const Value& v) {
    Encoder e;
    e.header();
    e.encode(v);
    e.stop();
    return e.out;
  }

 private:
  void u32(uint32_t v) { out.append((const char*)&v, 4); }
  void u64(uint64_t v) { out.append((const char*)&v, 8); }
  void enc_int(int64_t v) {
    if (v >= INT32_MIN && v <= INT32_MAX) {
      out += 'J';
      int32_t x = (int32_t)v;
      out.append((const char*)&x, 4);
      return;
    }
    out += '\x8a';  // LONG1
    uint8_t buf[9];
    size_t n = 0;
    uint64_t u = (uint64_t)v;
    do { buf[n++] = u & 0xff; u >>= 8; } while (n < 8);
    while (n > 1) {  // trim redundant sign bytes
      uint8_t hi = buf[n - 1], next = buf[n - 2];
      if ((hi == 0x00 && !(next & 0x80)) || (hi == 0xff && (next & 0x80))) --n;
      else break;
    }
    out += (char)n;
    out.append((const char*)buf, n);
  }
  void enc_float(double d) {
    out += 'G';
    uint64_t u; std::memcpy(&u, &d, 8);
    for (int k = 7; k >= 0; --k) out += (char)((u >> (8 * k)) & 0xff);
  }
  // Strict UTF-8 (matches CPython's decoder): rejects overlong encodings,
  // UTF-16 surrogates (U+D800-DFFF), code points above U+10FFFF, and
  // invalid lead bytes — anything CPython's BINUNICODE decode would reject.
  static bool valid_utf8(const std::string& s) {
    size_t i = 0, n = s.size();
    while (i < n) {
      uint8_t c = (uint8_t)s[i];
      if (c < 0x80) { ++i; continue; }
      size_t extra;
      uint32_t cp;
      if ((c & 0xe0) == 0xc0) { extra = 1; cp = c & 0x1f; }
      else if ((c & 0xf0) == 0xe0) { extra = 2; cp = c & 0x0f; }
      else if ((c & 0xf8) == 0xf0) { extra = 3; cp = c & 0x07; }
      else return false;  // continuation or F8+ lead byte
      if (i + extra >= n) return false;
      for (size_t k = 1; k <= extra; ++k) {
        uint8_t cc = (uint8_t)s[i + k];
        if ((cc & 0xc0) != 0x80) return false;
        cp = (cp << 6) | (cc & 0x3f);
      }
      static const uint32_t kMin[4] = {0, 0x80, 0x800, 0x10000};
      if (cp < kMin[extra]) return false;                 // overlong
      if (cp >= 0xd800 && cp <= 0xdfff) return false;    // surrogate
      if (cp > 0x10ffff) return false;                   // out of range
      i += extra + 1;
    }
    return true;
  }
  void enc_str(const std::string& s) {
    // BINUNICODE payloads must be UTF-8 or the Python-side unpickle blows
    // up far from the producing task — fail here with a clear error instead
    if (!valid_utf8(s))
      throw Error("Value::str holds non-UTF-8 bytes; use Value::bytes for binary data");
    // >=4 GiB payloads need the 8-byte length opcode: a silent uint32
    // truncation would emit a corrupt frame, not an error
    if (s.size() > 0xffffffffULL) { out += (char)0x8d; u64(s.size()); }
    else { out += 'X'; u32((uint32_t)s.size()); }
    out += s;
  }
  void enc_bytes(const std::string& s) {
    if (s.size() > 0xffffffffULL) { out += (char)0x8e; u64(s.size()); }
    else { out += 'B'; u32((uint32_t)s.size()); }
    out += s;
  }
  void enc_tuple(const std::vector<ValuePtr>& items) {
    if (items.empty()) { out += ')'; return; }
    if (items.size() <= 3) {
      for (auto& it : items) encode(*it);
      out += (char)(0x85 + items.size() - 1);
      return;
    }
    out += '(';
    for (auto& it : items) encode(*it);
    out += 't';
  }
};

inline ValuePtr loads(const std::string& data, std::vector<std::string> buffers = {}) {
  Decoder d((const uint8_t*)data.data(), data.size(), std::move(buffers));
  return d.parse();
}

inline std::string dumps(const Value& v) { return Encoder::dumps(v); }

}  // namespace picklite
