// tik-state-server — native head-node state store.
//
// Reference parity: the reference's head state store is Redis, a native C
// server it installs and boots (core/_private/services.py:512, port 6789).
// This build's equivalent is ~600 lines of dependency-free C++ speaking
// the same wire protocol as the Python StateServer in control/state.py
// (4-byte big-endian length + a msgpack map), so TcpStateBackend clients
// are byte-compatible with either implementation.  The Python server
// remains the dev/test default; production heads run this binary for a
// GIL-free, allocation-light control plane (hundreds of node agents
// heartbeating every second).
//
// Ops: put / get / delete / keys / cas / ping, optional auth token.
// Build: g++ -O2 -std=c++17 -pthread -o tik-state-server state_server.cpp

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <signal.h>
#include <sys/prctl.h>
#include <sys/socket.h>
#include <unistd.h>

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <optional>
#include <shared_mutex>
#include <string>
#include <thread>
#include <vector>

// ---------------------------------------------------------------------------
// Minimal msgpack subset: everything the state protocol uses.
//   decode: nil, bool, fix/u/int, fixstr/str8/16/32, bin8/16/32,
//           fixmap/map16/32 (string keys)
//   encode: nil, bool, float64, fixstr/str8/16/32, bin8/16/32,
//           fixarray/array16/32, fixmap
// ---------------------------------------------------------------------------

struct Value {
  enum class Type { Nil, Bool, Int, Str, Bin } type = Type::Nil;
  bool b = false;
  int64_t i = 0;
  std::string s;  // str or bin payload
};

struct Decoder {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  bool need(size_t n) {
    if (static_cast<size_t>(end - p) < n) { ok = false; return false; }
    return true;
  }
  uint8_t u8() { return *p++; }
  uint16_t u16() { uint16_t v = (p[0] << 8) | p[1]; p += 2; return v; }
  uint32_t u32() {
    uint32_t v = (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
                 (uint32_t(p[2]) << 8) | uint32_t(p[3]);
    p += 4;
    return v;
  }

  std::string take(size_t n) {
    if (!need(n)) return {};
    std::string out(reinterpret_cast<const char*>(p), n);
    p += n;
    return out;
  }

  Value value() {
    Value v;
    if (!need(1)) return v;
    uint8_t t = u8();
    if (t <= 0x7f) { v.type = Value::Type::Int; v.i = t; return v; }
    if (t >= 0xe0) { v.type = Value::Type::Int; v.i = int8_t(t); return v; }
    if ((t & 0xe0) == 0xa0) {  // fixstr
      v.type = Value::Type::Str; v.s = take(t & 0x1f); return v;
    }
    switch (t) {
      case 0xc0: v.type = Value::Type::Nil; return v;
      case 0xc2: v.type = Value::Type::Bool; v.b = false; return v;
      case 0xc3: v.type = Value::Type::Bool; v.b = true; return v;
      case 0xcc: if (need(1)) { v.type = Value::Type::Int; v.i = u8(); } return v;
      case 0xcd: if (need(2)) { v.type = Value::Type::Int; v.i = u16(); } return v;
      case 0xce: if (need(4)) { v.type = Value::Type::Int; v.i = u32(); } return v;
      case 0xd9: if (need(1)) { v.type = Value::Type::Str; v.s = take(u8()); } return v;
      case 0xda: if (need(2)) { v.type = Value::Type::Str; v.s = take(u16()); } return v;
      case 0xdb: if (need(4)) { v.type = Value::Type::Str; v.s = take(u32()); } return v;
      case 0xc4: if (need(1)) { v.type = Value::Type::Bin; v.s = take(u8()); } return v;
      case 0xc5: if (need(2)) { v.type = Value::Type::Bin; v.s = take(u16()); } return v;
      case 0xc6: if (need(4)) { v.type = Value::Type::Bin; v.s = take(u32()); } return v;
      default: ok = false; return v;
    }
  }

  // top-level request: a map with string keys
  bool request(std::map<std::string, Value>* out) {
    if (!need(1)) return false;
    uint8_t t = u8();
    size_t n;
    if ((t & 0xf0) == 0x80) n = t & 0x0f;
    else if (t == 0xde) { if (!need(2)) return false; n = u16(); }
    else if (t == 0xdf) { if (!need(4)) return false; n = u32(); }
    else return false;
    for (size_t k = 0; k < n; ++k) {
      Value key = value();
      if (!ok || key.type != Value::Type::Str) return false;
      Value val = value();
      if (!ok) return false;
      (*out)[key.s] = std::move(val);
    }
    return true;
  }
};

struct Encoder {
  std::string out;

  void raw8(uint8_t v) { out.push_back(char(v)); }
  void raw16(uint16_t v) { raw8(v >> 8); raw8(v & 0xff); }
  void raw32(uint32_t v) { raw16(v >> 16); raw16(v & 0xffff); }

  void map_header(size_t n) { raw8(0x80 | uint8_t(n)); }  // n <= 15 here
  void array_header(size_t n) {
    if (n <= 15) raw8(0x90 | uint8_t(n));
    else if (n <= 0xffff) { raw8(0xdc); raw16(uint16_t(n)); }
    else { raw8(0xdd); raw32(uint32_t(n)); }
  }
  void nil() { raw8(0xc0); }
  void boolean(bool v) { raw8(v ? 0xc3 : 0xc2); }
  void str(const std::string& s) {
    size_t n = s.size();
    if (n <= 31) raw8(0xa0 | uint8_t(n));
    else if (n <= 0xff) { raw8(0xd9); raw8(uint8_t(n)); }
    else if (n <= 0xffff) { raw8(0xda); raw16(uint16_t(n)); }
    else { raw8(0xdb); raw32(uint32_t(n)); }
    out.append(s);
  }
  void bin(const std::string& s) {
    size_t n = s.size();
    if (n <= 0xff) { raw8(0xc4); raw8(uint8_t(n)); }
    else if (n <= 0xffff) { raw8(0xc5); raw16(uint16_t(n)); }
    else { raw8(0xc6); raw32(uint32_t(n)); }
    out.append(s);
  }
  void f64(double v) {
    raw8(0xcb);
    uint64_t bits;
    memcpy(&bits, &v, 8);
    raw32(uint32_t(bits >> 32));
    raw32(uint32_t(bits & 0xffffffffu));
  }
};

// ---------------------------------------------------------------------------
// Store: namespace -> key -> bytes, guarded by one shared_mutex (CAS takes
// the exclusive lock, making it atomic against every other writer — the
// property locks/leader-election build on).
// ---------------------------------------------------------------------------

class Store {
 public:
  void put(const std::string& ns, const std::string& key,
           std::string value) {
    std::unique_lock lock(mu_);
    data_[ns][key] = std::move(value);
  }

  std::optional<std::string> get(const std::string& ns,
                                 const std::string& key) const {
    std::shared_lock lock(mu_);
    auto nsit = data_.find(ns);
    if (nsit == data_.end()) return std::nullopt;
    auto it = nsit->second.find(key);
    if (it == nsit->second.end()) return std::nullopt;
    return it->second;
  }

  bool erase(const std::string& ns, const std::string& key) {
    std::unique_lock lock(mu_);
    auto nsit = data_.find(ns);
    if (nsit == data_.end()) return false;
    return nsit->second.erase(key) > 0;
  }

  // `after` is the ranged-read primitive (keys strictly greater than it,
  // lexicographic): pollers of seq-keyed tables pass their high-water key
  // and receive only new entries instead of the whole table.
  std::vector<std::string> keys(const std::string& ns,
                                const std::string& prefix,
                                const std::string& after) const {
    std::shared_lock lock(mu_);
    std::vector<std::string> out;
    auto nsit = data_.find(ns);
    if (nsit == data_.end()) return out;
    auto it = after.empty() ? nsit->second.begin()
                            : nsit->second.upper_bound(after);
    for (; it != nsit->second.end(); ++it)
      if (it->first.rfind(prefix, 0) == 0) out.push_back(it->first);
    return out;  // std::map iteration is already sorted
  }

  bool cas(const std::string& ns, const std::string& key,
           const std::optional<std::string>& expected, std::string value) {
    std::unique_lock lock(mu_);
    auto& table = data_[ns];
    auto it = table.find(key);
    std::optional<std::string> current;
    if (it != table.end()) current = it->second;
    if (current != expected) return false;
    table[key] = std::move(value);
    return true;
  }

 private:
  mutable std::shared_mutex mu_;
  std::map<std::string, std::map<std::string, std::string>> data_;
};

// ---------------------------------------------------------------------------
// Framing + per-connection loop
// ---------------------------------------------------------------------------

static bool recv_exact(int fd, void* buf, size_t n) {
  auto* p = static_cast<uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= size_t(r);
  }
  return true;
}

static bool send_all(int fd, const void* buf, size_t n) {
  auto* p = static_cast<const uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) return false;
    p += r;
    n -= size_t(r);
  }
  return true;
}

static bool send_frame(int fd, const std::string& payload) {
  uint32_t len = htonl(uint32_t(payload.size()));
  return send_all(fd, &len, 4) && send_all(fd, payload.data(),
                                           payload.size());
}

static void error_resp(Encoder* enc, const std::string& message) {
  enc->map_header(2);
  enc->str("ok"); enc->boolean(false);
  enc->str("error"); enc->str(message);
}

static void serve_connection(int fd, Store* store,
                             const std::string& token) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  std::vector<uint8_t> body;
  for (;;) {
    uint32_t len_be;
    if (!recv_exact(fd, &len_be, 4)) break;
    uint32_t len = ntohl(len_be);
    if (len > 64u * 1024 * 1024) break;
    body.resize(len);
    if (!recv_exact(fd, body.data(), len)) break;

    std::map<std::string, Value> req;
    Decoder dec{body.data(), body.data() + len};
    Encoder enc;
    if (!dec.request(&req)) {
      error_resp(&enc, "malformed request");
      if (!send_frame(fd, enc.out)) break;
      continue;
    }
    auto field = [&](const char* name) -> const Value* {
      auto it = req.find(name);
      return it == req.end() ? nullptr : &it->second;
    };
    auto str_field = [&](const char* name) -> std::string {
      const Value* v = field(name);
      return (v && v->type == Value::Type::Str) ? v->s : std::string();
    };

    if (!token.empty() && str_field("token") != token) {
      error_resp(&enc, "unauthorized");
      if (!send_frame(fd, enc.out)) break;
      continue;
    }

    const std::string op = str_field("op");
    const std::string ns = str_field("ns");
    const std::string key = str_field("key");

    if (op == "put") {
      const Value* v = field("value");
      store->put(ns, key, v ? v->s : std::string());
      enc.map_header(1);
      enc.str("ok"); enc.boolean(true);
    } else if (op == "get") {
      auto v = store->get(ns, key);
      enc.map_header(2);
      enc.str("ok"); enc.boolean(true);
      enc.str("value");
      if (v) enc.bin(*v); else enc.nil();
    } else if (op == "delete") {
      enc.map_header(2);
      enc.str("ok"); enc.boolean(true);
      enc.str("deleted"); enc.boolean(store->erase(ns, key));
    } else if (op == "keys") {
      auto keys = store->keys(ns, str_field("prefix"), str_field("after"));
      enc.map_header(2);
      enc.str("ok"); enc.boolean(true);
      enc.str("keys");
      enc.array_header(keys.size());
      for (const auto& k : keys) enc.str(k);
    } else if (op == "cas") {
      const Value* expected = field("expected");
      std::optional<std::string> exp;
      if (expected && expected->type != Value::Type::Nil)
        exp = expected->s;
      const Value* v = field("value");
      bool swapped = store->cas(ns, key, exp,
                                v ? v->s : std::string());
      enc.map_header(2);
      enc.str("ok"); enc.boolean(true);
      enc.str("swapped"); enc.boolean(swapped);
    } else if (op == "ping") {
      double now = std::chrono::duration<double>(
          std::chrono::system_clock::now().time_since_epoch()).count();
      enc.map_header(2);
      enc.str("ok"); enc.boolean(true);
      enc.str("time"); enc.f64(now);
    } else {
      error_resp(&enc, "bad op '" + op + "'");
    }
    if (!send_frame(fd, enc.out)) break;
  }
  close(fd);
}

int main(int argc, char** argv) {
  std::string host = "0.0.0.0";
  int port = 6879;
  std::string token;
  long fate_parent = 0;
  for (int i = 1; i < argc - 1; ++i) {
    if (!strcmp(argv[i], "--host")) host = argv[++i];
    else if (!strcmp(argv[i], "--port")) port = atoi(argv[++i]);
    else if (!strcmp(argv[i], "--token")) token = argv[++i];
    else if (!strcmp(argv[i], "--fate-parent"))
      fate_parent = atol(argv[++i]);
  }
  signal(SIGPIPE, SIG_IGN);
  if (fate_parent > 0) {
    // Self-armed fate-sharing: SIGTERM when the spawning parent dies.
    // In-binary (vs a Python preexec_fn) so the launcher can use
    // posix_spawn — fork()+preexec in a multithreaded JAX process is a
    // deadlock risk profile.  prctl binds to the parent THREAD; if the
    // parent already died between spawn and here, exit now.
    prctl(PR_SET_PDEATHSIG, SIGTERM);
    if (getppid() != fate_parent) return 0;
  }

  int listener = socket(AF_INET, SOCK_STREAM, 0);
  if (listener < 0) { perror("socket"); return 1; }
  int one = 1;
  setsockopt(listener, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(uint16_t(port));
  if (inet_pton(AF_INET, host.c_str(), &addr.sin_addr) != 1) {
    fprintf(stderr, "bad host %s\n", host.c_str());
    return 1;
  }
  if (bind(listener, reinterpret_cast<sockaddr*>(&addr),
           sizeof(addr)) < 0) {
    perror("bind");
    return 1;
  }
  if (listen(listener, 128) < 0) { perror("listen"); return 1; }
  // Report the bound port (port 0 = ephemeral) for the spawning wrapper.
  sockaddr_in bound{};
  socklen_t blen = sizeof(bound);
  getsockname(listener, reinterpret_cast<sockaddr*>(&bound), &blen);
  printf("tik-state-server listening on %s:%d\n", host.c_str(),
         ntohs(bound.sin_port));
  fflush(stdout);

  Store store;
  for (;;) {
    int fd = accept(listener, nullptr, nullptr);
    if (fd < 0) continue;
    std::thread(serve_connection, fd, &store, token).detach();
  }
}
