// sentinel_shim: native client shim for the sentinel-tpu token server.
//
// Role (SURVEY.md §2.9, §7 M4): the reference is pure Java, so its cluster
// clients live in-process; our TPU backend serves tokens over the TLV TCP
// protocol, and THIS library is the bridge by which any host runtime — a
// JVM via JNI, C++ services, Python via ctypes — talks to it without a
// Python dependency. It implements:
//
//   * the length-framed binary TLV codec (cluster/codec.py is the Python
//     twin; frame = u16 len | body; request body = i32 xid | u8 type |
//     entity; response body = i32 xid | u8 type | i8 status | entity),
//   * a pipelined token client with xid demultiplexing over one TCP
//     connection — N concurrent callers share one handle (PING namespace
//     registration on connect; FLOW / PARAM_FLOW acquires; batched FLOW
//     acquires; MSG_ENTRY/MSG_EXIT remote slot-chain bridge),
//   * a cached-tick millisecond clock (the reference TimeUtil's dedicated
//     tick thread — avoids a syscall per hot-path read).
//
// C ABI only: every symbol is extern "C" so ctypes/JNI/FFI can bind it.

#include <arpa/inet.h>
#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <netdb.h>
#include <string>
#include <sys/socket.h>
#include <thread>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint8_t MSG_PING = 0;
constexpr uint8_t MSG_FLOW = 1;
constexpr uint8_t MSG_PARAM_FLOW = 2;
// TPU-extension types (cluster/constants.py MSG_ENTRY/MSG_EXIT): the M4
// remote slot-chain bridge.
constexpr uint8_t MSG_ENTRY = 10;
constexpr uint8_t MSG_EXIT = 11;

constexpr int ST_FAIL = -1;

// -- wire helpers (big-endian, matching cluster/codec.py) --------------------

void put_u16(std::vector<uint8_t>& b, uint16_t v) {
  b.push_back(v >> 8);
  b.push_back(v & 0xff);
}
void put_i32(std::vector<uint8_t>& b, int32_t v) {
  for (int s = 24; s >= 0; s -= 8) b.push_back((uint32_t(v) >> s) & 0xff);
}
void put_i64(std::vector<uint8_t>& b, int64_t v) {
  for (int s = 56; s >= 0; s -= 8) b.push_back((uint64_t(v) >> s) & 0xff);
}
void put_f64(std::vector<uint8_t>& b, double v) {
  // IEEE-754 bits, big-endian (struct ">d" in cluster/codec.py).
  uint64_t bits;
  static_assert(sizeof(bits) == sizeof(v), "double is 64-bit");
  std::memcpy(&bits, &v, sizeof(bits));
  put_i64(b, int64_t(bits));
}
int32_t get_i32(const uint8_t* p) {
  return (int32_t(p[0]) << 24) | (int32_t(p[1]) << 16) | (int32_t(p[2]) << 8) |
         int32_t(p[3]);
}

// One outstanding request's parking slot: the receiver thread-of-the-
// moment fills it by xid and wakes the owner.
struct Waiter {
  bool done = false;
  bool failed = false;
  int8_t status = ST_FAIL;
  std::vector<uint8_t> entity;
};

// Multi-in-flight pipelined client: N threads may call() concurrently on
// ONE handle. Requests are xid-tagged; whichever caller reaches the
// socket first becomes the receiver, demuxes response frames into the
// waiter map by xid, and hands the receiver role off when its own
// response lands (the classic shared-receiver pattern — no dedicated IO
// thread, so a handle is just a socket + a mutex, safe to create per
// worker or to share). The reference's Netty client gets the same
// effect from its xid -> promise map (SURVEY.md §2.11).
struct Client {
  int fd = -1;
  std::mutex send_mu;                // frames hit the wire atomically
  std::mutex mu;                     // waiter map + receiver election
  std::condition_variable cv;
  std::unordered_map<int32_t, Waiter*> waiting;
  int32_t next_xid = 1;              // guarded by mu
  bool rx_active = false;            // someone is blocked in recv()
  bool dead = false;                 // transport failed: fail all callers
  int users = 0;                     // callers inside any entry point

  // RAII presence marker: st_client_close drains `users` to zero before
  // freeing the Client, so no caller can wake up on destroyed state.
  struct Use {
    Client* c;
    explicit Use(Client* c_) : c(c_) {
      std::lock_guard<std::mutex> lock(c->mu);
      ++c->users;
    }
    ~Use() {
      std::lock_guard<std::mutex> lock(c->mu);
      if (--c->users == 0) c->cv.notify_all();
    }
  };

  bool send_all(const uint8_t* data, size_t n) {
    size_t off = 0;
    while (off < n) {
      ssize_t w = ::send(fd, data + off, n - off, MSG_NOSIGNAL);
      if (w <= 0) return false;
      off += size_t(w);
    }
    return true;
  }

  bool recv_all(uint8_t* data, size_t n) {
    size_t off = 0;
    while (off < n) {
      ssize_t r = ::recv(fd, data + off, n - off, 0);
      if (r <= 0) return false;
      off += size_t(r);
    }
    return true;
  }

  // Read ONE response frame off the socket and complete its waiter.
  // Returns 1 on a processed frame, 0 on a CLEAN timeout (SO_RCVTIMEO
  // expired before any byte of the next frame arrived — the stream is
  // intact, only the current caller's patience ran out), -1 on
  // transport death (EOF, error, or a MID-frame timeout, which desyncs
  // the stream). Called with `mu` NOT held.
  int pump_one() {
    uint8_t lenbuf[2];
    ssize_t r = ::recv(fd, lenbuf, 1, 0);
    if (r == 0) return -1;
    if (r < 0) return (errno == EAGAIN || errno == EWOULDBLOCK) ? 0 : -1;
    if (!recv_all(lenbuf + 1, 1)) return -1;
    uint16_t len = (uint16_t(lenbuf[0]) << 8) | lenbuf[1];
    std::vector<uint8_t> resp(len);
    if (len > 0 && !recv_all(resp.data(), len)) return -1;
    if (len < 6) return 1;  // malformed frame: skip, stay alive
    int32_t xid = get_i32(resp.data());
    std::lock_guard<std::mutex> lock(mu);
    auto it = waiting.find(xid);
    if (it == waiting.end()) return 1;  // stale/timed-out xid: drop
    it->second->status = int8_t(resp[5]);
    it->second->entity.assign(resp.begin() + 6, resp.end());
    it->second->done = true;
    waiting.erase(it);
    cv.notify_all();
    return 1;
  }

  void fail_all_locked() {
    dead = true;
    for (auto& kv : waiting) {
      kv.second->failed = true;
      kv.second->done = true;
    }
    waiting.clear();
    cv.notify_all();
  }

  // Register `w`, send the frame, return its xid (or -1 on failure).
  int32_t post(uint8_t type, const std::vector<uint8_t>& entity, Waiter* w) {
    int32_t xid;
    {
      std::lock_guard<std::mutex> lock(mu);
      if (dead) return -1;
      xid = next_xid++;
      waiting.emplace(xid, w);
    }
    std::vector<uint8_t> body;
    put_i32(body, xid);
    body.push_back(type);
    body.insert(body.end(), entity.begin(), entity.end());
    std::vector<uint8_t> frame;
    put_u16(frame, uint16_t(body.size()));
    frame.insert(frame.end(), body.begin(), body.end());
    bool sent;
    {
      std::lock_guard<std::mutex> lock(send_mu);
      sent = send_all(frame.data(), frame.size());
    }
    if (!sent) {
      std::lock_guard<std::mutex> lock(mu);
      waiting.erase(xid);
      fail_all_locked();  // a broken pipe is fatal for every caller
      return -1;
    }
    return xid;
  }

  // Wait until `w` completes, pumping the socket when no one else is.
  // Returns false on failure; the waiter is deregistered either way.
  bool await(Waiter* w, int32_t xid) {
    std::unique_lock<std::mutex> lock(mu);
    for (;;) {
      if (w->done) return !w->failed;
      if (dead) return false;
      if (!rx_active) {
        rx_active = true;
        lock.unlock();
        int got = pump_one();
        lock.lock();
        rx_active = false;
        // A frame landed or the role freed: wake potential successors.
        cv.notify_all();
        if (got < 0) {
          fail_all_locked();
          return false;
        }
        if (got == 0 && !w->done) {
          // Clean timeout: THIS call gives up (its SO_RCVTIMEO budget
          // is spent) but the connection stays usable — a late response
          // is dropped by the stale-xid skip in pump_one. One slow
          // server response (e.g. a first-entry XLA compile) must not
          // brick the shared handle for every later caller.
          waiting.erase(xid);
          w->failed = true;
          w->done = true;
          return false;
        }
      } else {
        cv.wait(lock);
      }
    }
  }

  // Blocking single call; concurrent calls pipeline on the one socket.
  bool call(uint8_t type, const std::vector<uint8_t>& entity, int8_t* status,
            std::vector<uint8_t>* resp_entity) {
    Use use(this);
    Waiter w;
    int32_t xid = post(type, entity, &w);
    if (xid < 0) return false;
    if (!await(&w, xid)) return false;
    *status = w.status;
    *resp_entity = std::move(w.entity);
    return true;
  }
};

}  // namespace

extern "C" {

// -- token client ------------------------------------------------------------

// Connect + register the namespace via PING. NULL on failure.
void* st_client_connect(const char* host, int port, const char* ns,
                        int timeout_ms) {
  struct addrinfo hints {};
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  struct addrinfo* res = nullptr;
  std::string port_s = std::to_string(port);
  if (getaddrinfo(host, port_s.c_str(), &hints, &res) != 0) return nullptr;
  int fd = -1;
  for (auto* p = res; p; p = p->ai_next) {
    fd = ::socket(p->ai_family, p->ai_socktype, p->ai_protocol);
    if (fd < 0) continue;
    struct timeval tv { timeout_ms / 1000, (timeout_ms % 1000) * 1000 };
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
    if (::connect(fd, p->ai_addr, p->ai_addrlen) == 0) break;
    ::close(fd);
    fd = -1;
  }
  freeaddrinfo(res);
  if (fd < 0) return nullptr;

  auto* c = new Client();
  c->fd = fd;
  // PING entity: u8 len | namespace.
  std::vector<uint8_t> entity;
  std::string nss = ns ? ns : "default";
  if (nss.size() > 255) nss.resize(255);
  entity.push_back(uint8_t(nss.size()));
  entity.insert(entity.end(), nss.begin(), nss.end());
  int8_t status = ST_FAIL;
  std::vector<uint8_t> resp;
  if (!c->call(MSG_PING, entity, &status, &resp)) {
    ::close(c->fd);
    delete c;
    return nullptr;
  }
  return c;
}

// Acquire tokens. Returns the TokenResultStatus (OK=0, BLOCKED=1,
// SHOULD_WAIT=2, ...) or -1 on transport failure. out_extra receives
// remaining (OK) or wait-ms (SHOULD_WAIT) when non-null.
int st_request_token(void* handle, long long flow_id, int count,
                     int prioritized, int* out_extra) {
  if (!handle) return ST_FAIL;
  auto* c = static_cast<Client*>(handle);
  std::vector<uint8_t> entity;
  put_i64(entity, flow_id);
  put_i32(entity, count);
  entity.push_back(prioritized ? 1 : 0);
  int8_t status = ST_FAIL;
  std::vector<uint8_t> resp;
  if (!c->call(MSG_FLOW, entity, &status, &resp)) return ST_FAIL;
  if (out_extra) {
    *out_extra = 0;
    if (resp.size() >= 8) {
      int32_t remaining = get_i32(resp.data());
      int32_t wait_ms = get_i32(resp.data() + 4);
      *out_extra = (status == 2) ? wait_ms : remaining;
    }
  }
  return status;
}

// One hot-parameter value (mirror of sentinel_shim.h's st_param).
struct st_param {
  unsigned char tag;  // 0=int, 1=str, 2=bool, 3=float
  long long i;
  double d;
  const char* s;
};

namespace {
// Shared tagged-params encoder: MSG_PARAM_FLOW and MSG_ENTRY carry the
// identical block (u16 count | per-param u8 tag + typed payload) — one
// implementation so the two frame types can never drift apart. Returns
// false on an unencodable param (oversized string / unknown tag).
bool append_params(std::vector<uint8_t>& entity, const st_param* params,
                   int nparams) {
  entity.push_back(uint8_t(nparams >> 8));
  entity.push_back(uint8_t(nparams & 0xff));
  for (int k = 0; k < nparams; ++k) {
    const st_param& p = params[k];
    entity.push_back(p.tag);
    switch (p.tag) {
      case 0:  // int: i64
        put_i64(entity, p.i);
        break;
      case 1: {  // str: u16 len | utf-8
        size_t n = p.s ? std::strlen(p.s) : 0;
        // Oversized values can't fit the u16 frame anyway (the callers'
        // entity-size check would reject them) — fail fast rather than
        // truncate, which could split a multibyte UTF-8 char.
        if (n > 0xFFF0) return false;
        entity.push_back(uint8_t(n >> 8));
        entity.push_back(uint8_t(n & 0xff));
        if (n > 0) entity.insert(entity.end(), p.s, p.s + n);
        break;
      }
      case 2:  // bool: u8
        entity.push_back(p.i ? 1 : 0);
        break;
      case 3:  // float: f64 bits
        put_f64(entity, p.d);
        break;
      default:
        return false;
    }
  }
  return true;
}
}  // namespace

// Acquire param-flow tokens. Entity (cluster/codec.py
// encode_param_flow_request): flowId:i64 | count:i32 | nparams:u16 |
// per-param u8 tag + typed payload. Returns the TokenResultStatus or -1.
int st_request_param_token(void* handle, long long flow_id, int count,
                           const st_param* params, int nparams) {
  if (!handle || nparams < 0 || (nparams > 0 && !params)) return ST_FAIL;
  auto* c = static_cast<Client*>(handle);
  std::vector<uint8_t> entity;
  put_i64(entity, flow_id);
  put_i32(entity, count);
  if (!append_params(entity, params, nparams)) return ST_FAIL;
  if (entity.size() > 0xFFF0) return ST_FAIL;  // must fit one u16 frame
  int8_t status = ST_FAIL;
  std::vector<uint8_t> resp;
  if (!c->call(MSG_PARAM_FLOW, entity, &status, &resp)) return ST_FAIL;
  return status;
}

// Pipelined batch acquire: all `n` FLOW requests are sent back-to-back on
// the one connection before any response is awaited, so the wire carries
// one RTT for the whole batch (and the server's micro-batcher folds them
// into one device step). out_statuses[i] receives the TokenResultStatus
// (or -1), out_extras[i] (when non-null) remaining/wait-ms as in
// st_request_token. Returns 0 when every response arrived, -1 on
// transport failure (unanswered slots read -1).
int st_request_tokens_batch(void* handle, const long long* flow_ids,
                            const int* counts, const int* prioritized, int n,
                            int* out_statuses, int* out_extras) {
  if (!handle || n <= 0 || !flow_ids || !counts || !out_statuses)
    return ST_FAIL;
  auto* c = static_cast<Client*>(handle);
  Client::Use use(c);
  std::vector<Waiter> waiters(n);
  std::vector<int32_t> xids(n, -1);
  for (int k = 0; k < n; ++k) out_statuses[k] = ST_FAIL;
  int posted = 0;
  for (; posted < n; ++posted) {
    std::vector<uint8_t> entity;
    put_i64(entity, flow_ids[posted]);
    put_i32(entity, counts[posted]);
    entity.push_back((prioritized && prioritized[posted]) ? 1 : 0);
    xids[posted] = c->post(MSG_FLOW, entity, &waiters[posted]);
    if (xids[posted] < 0) break;
  }
  bool all_ok = posted == n;
  for (int k = 0; k < posted; ++k) {
    if (!c->await(&waiters[k], xids[k])) {
      all_ok = false;
      continue;
    }
    out_statuses[k] = waiters[k].status;
    if (out_extras) {
      out_extras[k] = 0;
      if (waiters[k].entity.size() >= 8) {
        int32_t remaining = get_i32(waiters[k].entity.data());
        int32_t wait_ms = get_i32(waiters[k].entity.data() + 4);
        out_extras[k] = (waiters[k].status == 2) ? wait_ms : remaining;
      }
    }
  }
  return all_ok ? 0 : ST_FAIL;
}

namespace {
// str8 (u8 len | utf-8), truncated on a CHARACTER boundary like the
// Python codec's _pack_str8 — a mid-sequence cut would cost the peer a
// mangled name at best.
void put_str8(std::vector<uint8_t>& b, const char* s) {
  size_t n = s ? std::strlen(s) : 0;
  if (n > 255) {
    n = 255;
    while (n > 0 && (uint8_t(s[n]) & 0xC0) == 0x80) --n;  // continuation?
  }
  b.push_back(uint8_t(n));
  if (n > 0) b.insert(b.end(), s, s + n);
}
}  // namespace

// Remote slot-chain entry (MSG_ENTRY — the M4 bridge): run the backend's
// FULL rule chain + stats commit for `resource`. Returns the
// TokenResultStatus (OK=0 pass, BLOCKED=1, -1 transport/backend failure
// -> caller falls open). On OK *out_entry_id receives the id to pass to
// st_remote_exit; on BLOCKED *out_reason receives the BlockReason code
// (1=flow 2=degrade 3=system 4=authority 5=param 7=custom).
int st_remote_entry(void* handle, const char* resource, const char* origin,
                    int count, int entry_type, int prioritized,
                    const st_param* params, int nparams,
                    long long* out_entry_id, int* out_reason) {
  if (!handle || !resource || nparams < 0 || (nparams > 0 && !params))
    return ST_FAIL;
  auto* c = static_cast<Client*>(handle);
  std::vector<uint8_t> entity;
  put_str8(entity, resource);
  put_str8(entity, origin);
  put_i32(entity, count);
  entity.push_back(uint8_t(entry_type));
  entity.push_back(prioritized ? 1 : 0);
  if (!append_params(entity, params, nparams)) return ST_FAIL;
  if (entity.size() > 0xFFF0) return ST_FAIL;
  int8_t status = ST_FAIL;
  std::vector<uint8_t> resp;
  if (!c->call(MSG_ENTRY, entity, &status, &resp)) return ST_FAIL;
  if (resp.size() >= 9) {
    int64_t id = 0;
    for (int k = 0; k < 8; ++k) id = (id << 8) | resp[size_t(k)];
    if (out_entry_id) *out_entry_id = id;
    if (out_reason) *out_reason = resp[8];
  } else {
    if (out_entry_id) *out_entry_id = 0;
    if (out_reason) *out_reason = 0;
  }
  return status;
}

// Remote exit (MSG_EXIT): commit RT/success and release the entry.
// `error` non-zero records a business exception; `count` < 0 keeps the
// count given at entry. Returns OK, BAD_REQUEST (unknown/already-exited
// id), or -1 on transport failure.
int st_remote_exit(void* handle, long long entry_id, int error, int count) {
  if (!handle) return ST_FAIL;
  auto* c = static_cast<Client*>(handle);
  std::vector<uint8_t> entity;
  put_i64(entity, entry_id);
  entity.push_back(error ? 1 : 0);
  put_i32(entity, count);
  int8_t status = ST_FAIL;
  std::vector<uint8_t> resp;
  if (!c->call(MSG_EXIT, entity, &status, &resp)) return ST_FAIL;
  return status;
}

// Close contract: no NEW calls may race st_client_close (wrappers
// serialize close against issuing requests); calls already in flight are
// failed and fully drained before the handle is freed.
void st_client_close(void* handle) {
  if (!handle) return;
  auto* c = static_cast<Client*>(handle);
  bool drained;
  {
    std::unique_lock<std::mutex> lock(c->mu);
    c->fail_all_locked();
    ::shutdown(c->fd, SHUT_RDWR);  // kick a receiver blocked in recv()
    // Drain EVERY caller out of the entry points — not just the
    // receiver: a waiter parked in cv.wait (or a sender in send_all)
    // waking on destroyed state would be use-after-free. fail_all woke
    // them; give them a bounded window to unwind through ~Use.
    drained = c->cv.wait_for(
        lock, std::chrono::seconds(5),
        [c] { return !c->rx_active && c->users == 0; });
  }
  ::close(c->fd);
  if (drained) {
    delete c;
  }
  // else: a caller is stuck (e.g. send blocked past its SO_SNDTIMEO);
  // deliberately LEAK this one Client rather than free state under a
  // live thread — close is rare and the fd is already closed.
}

// NOTE: the token-lease admission ring is NOT part of this shim. It
// lives in csrc/lease_ext.c as a CPython extension — a ctypes route
// through here was measured and its ~2-4µs trampoline erased the
// win, and a third copy of the admission math would be drift waiting to
// happen.

// -- cached-tick clock (reference: core:util/TimeUtil.java) ------------------

namespace {
std::atomic<long long> g_now_ms{0};
std::atomic<bool> g_tick_running{false};
std::thread g_tick_thread;

long long wall_ms() {
  return std::chrono::duration_cast<std::chrono::milliseconds>(
             std::chrono::system_clock::now().time_since_epoch())
      .count();
}
}  // namespace

void st_time_start(void) {
  bool expected = false;
  if (!g_tick_running.compare_exchange_strong(expected, true)) return;
  g_now_ms.store(wall_ms());
  g_tick_thread = std::thread([] {
    while (g_tick_running.load(std::memory_order_relaxed)) {
      g_now_ms.store(wall_ms(), std::memory_order_relaxed);
      std::this_thread::sleep_for(std::chrono::milliseconds(1));
    }
  });
  g_tick_thread.detach();
}

void st_time_stop(void) { g_tick_running.store(false); }

// Cached when the tick thread runs; falls back to a syscall otherwise.
long long st_now_ms(void) {
  long long v = g_now_ms.load(std::memory_order_relaxed);
  return (v != 0 && g_tick_running.load(std::memory_order_relaxed))
             ? v
             : wall_ms();
}

}  // extern "C"
