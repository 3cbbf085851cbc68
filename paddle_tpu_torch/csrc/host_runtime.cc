// paddle_tpu_torch host runtime: the bounded blob queue, the TCPStore
// server and client (leases, the server-side bounded wait) and the RPC
// transport (framing, HMAC-SHA256 auth, threaded server), plus pt_free and
// pt_now_ns.
//
// A copy of the parts of the JAX package's C++ runtime that the store, rpc
// and data loader need; the wire protocols are kept byte for byte, so a
// client of either package talks to a server of the other. It is plain
// C++17 with a flat C ABI consumed from Python via ctypes:
// utils/native.py compiles it with g++ at first use into
// build/paddle_tpu_torch/. All functions are thread-safe.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

#include <cerrno>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <set>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#define PT_API extern "C" __attribute__((visibility("default")))

namespace {

double now_monotonic_s() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

}  // namespace

PT_API void pt_free(void* p) { free(p); }

PT_API long long pt_now_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// ---------------------------------------------------------------------------
// Bounded blocking queue of byte blobs
// ---------------------------------------------------------------------------

namespace {

struct Blob {
  std::vector<uint8_t> data;
};

struct BlockingQueue {
  explicit BlockingQueue(int cap) : capacity(cap) {}
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::deque<Blob> items;
  int capacity;
  bool closed = false;
};

}  // namespace

PT_API void* pt_queue_new(int capacity) {
  return new BlockingQueue(capacity > 0 ? capacity : 1);
}

// 0 = ok, -1 = timeout, -2 = closed.
PT_API int pt_queue_push(void* q_, const void* data, long n, double timeout_s) {
  auto* q = (BlockingQueue*)q_;
  std::unique_lock<std::mutex> lk(q->mu);
  auto ready = [&] { return q->closed || (int)q->items.size() < q->capacity; };
  if (timeout_s < 0) {
    q->cv_push.wait(lk, ready);
  } else if (!q->cv_push.wait_for(lk, std::chrono::duration<double>(timeout_s),
                                  ready)) {
    return -1;
  }
  if (q->closed) return -2;
  Blob b;
  b.data.assign((const uint8_t*)data, (const uint8_t*)data + n);
  q->items.push_back(std::move(b));
  q->cv_pop.notify_one();
  return 0;
}

// Returns blob size (caller frees *out with pt_free), -1 = timeout,
// -2 = closed and drained.
PT_API long pt_queue_pop(void* q_, void** out, double timeout_s) {
  auto* q = (BlockingQueue*)q_;
  std::unique_lock<std::mutex> lk(q->mu);
  auto ready = [&] { return q->closed || !q->items.empty(); };
  if (timeout_s < 0) {
    q->cv_pop.wait(lk, ready);
  } else if (!q->cv_pop.wait_for(lk, std::chrono::duration<double>(timeout_s),
                                 ready)) {
    return -1;
  }
  if (q->items.empty()) return -2;  // closed + drained
  Blob b = std::move(q->items.front());
  q->items.pop_front();
  q->cv_push.notify_one();
  lk.unlock();
  long n = (long)b.data.size();
  *out = malloc((size_t)(n > 0 ? n : 1));
  memcpy(*out, b.data.data(), (size_t)n);
  return n;
}

PT_API int pt_queue_size(void* q_) {
  auto* q = (BlockingQueue*)q_;
  std::lock_guard<std::mutex> lk(q->mu);
  return (int)q->items.size();
}

PT_API void pt_queue_close(void* q_) {
  auto* q = (BlockingQueue*)q_;
  std::lock_guard<std::mutex> lk(q->mu);
  q->closed = true;
  q->cv_push.notify_all();
  q->cv_pop.notify_all();
}

PT_API void pt_queue_free(void* q_) { delete (BlockingQueue*)q_; }

// ---------------------------------------------------------------------------
// TCPStore — key/value rendezvous (master server + clients)
// ---------------------------------------------------------------------------
// Wire protocol (all little-endian):
//   request : u8 cmd | u32 keylen | key | u32 vallen | val
//   response: i64 status_or_value | u32 vallen | val
// cmds: 1=SET 2=GET(blocking until key exists) 3=ADD(i64 delta in val)
//       4=WAIT(blocking) 5=DELETE 6=PING
//       7=LEASE(grant/refresh; val = i64 ttl_ms; expiry on the SERVER clock)
//       8=LEASE_CHECK(status 1 = alive, 0 = expired/absent)
//       9=WAIT_TIMEOUT(val = i64 timeout_ms; status 0 = key present,
//         -3 = server-side deadline expired — the no-hang variant of WAIT)
// Leases give ETCD-style store-side liveness (reference
// fleet/elastic/manager.py:126): expiry is decided by the store's own
// clock, so every observer agrees regardless of its local timing.

namespace {

constexpr uint8_t kSet = 1, kGet = 2, kAdd = 3, kWait = 4, kDel = 5, kPing = 6,
                  kLease = 7, kLeaseCheck = 8, kWaitT = 9;

bool read_full(int fd, void* buf, size_t n) {
  auto* p = (uint8_t*)buf;
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r == 0) {
      errno = ECONNRESET;  // clean peer close must not report a stale EAGAIN
      return false;
    }
    if (r < 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

bool write_full(int fd, const void* buf, size_t n) {
  auto* p = (const uint8_t*)buf;
  while (n > 0) {
    ssize_t r = ::send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

struct StoreServer {
  int listen_fd = -1;
  int port = 0;
  std::atomic<bool> stopping{false};
  std::thread accept_thread;
  std::vector<std::thread> handlers;
  std::mutex mu;
  std::condition_variable cv;  // signalled on any mutation
  std::map<std::string, std::vector<uint8_t>> kv;
  std::map<std::string, std::chrono::steady_clock::time_point> leases;
  // live connection fds: stop() must shutdown() each so handlers blocked in
  // recv() on still-open (or half-dead) client connections actually wake up
  std::mutex conn_mu;
  std::set<int> conn_fds;

  void handle(int fd) {
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    for (;;) {
      uint8_t cmd;
      uint32_t klen, vlen;
      if (!read_full(fd, &cmd, 1) || !read_full(fd, &klen, 4)) break;
      if (klen > (1u << 20)) break;
      std::string key(klen, '\0');
      if (klen && !read_full(fd, &key[0], klen)) break;
      if (!read_full(fd, &vlen, 4)) break;
      if (vlen > (1u << 30)) break;
      std::vector<uint8_t> val(vlen);
      if (vlen && !read_full(fd, val.data(), vlen)) break;

      int64_t status = 0;
      std::vector<uint8_t> reply;
      switch (cmd) {
        case kSet: {
          std::lock_guard<std::mutex> lk(mu);
          kv[key] = std::move(val);
          cv.notify_all();
          break;
        }
        case kGet:
        case kWait: {
          std::unique_lock<std::mutex> lk(mu);
          cv.wait(lk, [&] { return stopping.load() || kv.count(key) > 0; });
          if (stopping.load() && !kv.count(key)) {
            status = -1;
          } else if (cmd == kGet) {
            reply = kv[key];
          }
          break;
        }
        case kWaitT: {
          // bounded WAIT: the server's own clock enforces the deadline, so
          // a waiter never hangs on a key its peer will never publish
          int64_t timeout_ms = 0;
          if (val.size() == 8) memcpy(&timeout_ms, val.data(), 8);
          std::unique_lock<std::mutex> lk(mu);
          bool ok = cv.wait_for(
              lk, std::chrono::milliseconds(timeout_ms),
              [&] { return stopping.load() || kv.count(key) > 0; });
          if (kv.count(key) > 0) {
            status = 0;
          } else if (stopping.load()) {
            status = -1;
          } else {
            status = ok ? -1 : -3;  // -3: deadline expired key still absent
          }
          break;
        }
        case kAdd: {
          int64_t delta = 0;
          if (val.size() == 8) memcpy(&delta, val.data(), 8);
          std::lock_guard<std::mutex> lk(mu);
          int64_t cur = 0;
          auto it = kv.find(key);
          if (it != kv.end()) {
            // counters are stored as decimal strings, like the reference
            cur = atoll(std::string(it->second.begin(), it->second.end()).c_str());
          }
          cur += delta;
          std::string s = std::to_string(cur);
          kv[key].assign(s.begin(), s.end());
          status = cur;
          cv.notify_all();
          break;
        }
        case kDel: {
          std::lock_guard<std::mutex> lk(mu);
          status = (int64_t)kv.erase(key);
          cv.notify_all();
          break;
        }
        case kLease: {
          int64_t ttl_ms = 0;
          if (val.size() == 8) memcpy(&ttl_ms, val.data(), 8);
          std::lock_guard<std::mutex> lk(mu);
          leases[key] = std::chrono::steady_clock::now() +
                        std::chrono::milliseconds(ttl_ms);
          break;
        }
        case kLeaseCheck: {
          std::lock_guard<std::mutex> lk(mu);
          auto it = leases.find(key);
          if (it == leases.end()) {
            status = 0;
          } else if (std::chrono::steady_clock::now() < it->second) {
            status = 1;
          } else {
            leases.erase(it);  // lazy expiry
            status = 0;
          }
          break;
        }
        case kPing:
          status = 42;
          break;
        default:
          status = -2;
      }
      uint32_t rlen = (uint32_t)reply.size();
      if (!write_full(fd, &status, 8) || !write_full(fd, &rlen, 4)) break;
      if (rlen && !write_full(fd, reply.data(), rlen)) break;
    }
    {
      std::lock_guard<std::mutex> lk(conn_mu);
      conn_fds.erase(fd);
    }
    ::close(fd);
  }

  void accept_loop() {
    for (;;) {
      int fd = ::accept(listen_fd, nullptr, nullptr);
      if (fd < 0) {
        if (stopping.load()) return;
        continue;
      }
      if (stopping.load()) {
        ::close(fd);
        return;
      }
      {
        std::lock_guard<std::mutex> lk(conn_mu);
        conn_fds.insert(fd);
      }
      handlers.emplace_back([this, fd] { handle(fd); });
    }
  }
};

}  // namespace

PT_API void* pt_store_server_start(int port) {
  auto* s = new StoreServer();
  s->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (s->listen_fd < 0) {
    delete s;
    return nullptr;
  }
  int one = 1;
  setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons((uint16_t)port);
  if (::bind(s->listen_fd, (sockaddr*)&addr, sizeof(addr)) < 0 ||
      ::listen(s->listen_fd, 128) < 0) {
    ::close(s->listen_fd);
    delete s;
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(s->listen_fd, (sockaddr*)&addr, &alen);
  s->port = ntohs(addr.sin_port);
  s->accept_thread = std::thread([s] { s->accept_loop(); });
  return s;
}

PT_API int pt_store_server_port(void* s_) { return ((StoreServer*)s_)->port; }

PT_API void pt_store_server_stop(void* s_) {
  auto* s = (StoreServer*)s_;
  s->stopping.store(true);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->cv.notify_all();
  }
  ::shutdown(s->listen_fd, SHUT_RDWR);
  ::close(s->listen_fd);
  // unblock accept() on platforms where shutdown is not enough
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd >= 0) {
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    addr.sin_port = htons((uint16_t)s->port);
    ::connect(fd, (sockaddr*)&addr, sizeof(addr));
    ::close(fd);
  }
  if (s->accept_thread.joinable()) s->accept_thread.join();
  {
    // accept loop is done: no new connections. Unblock handlers stuck in
    // recv() on connections whose peer never closed (e.g. a crashed node).
    std::lock_guard<std::mutex> lk(s->conn_mu);
    for (int cfd : s->conn_fds) ::shutdown(cfd, SHUT_RDWR);
  }
  for (auto& t : s->handlers)
    if (t.joinable()) t.join();
  delete s;
}

namespace {

struct StoreClient {
  int fd = -1;
  std::mutex mu;  // one request/response in flight per client
  double op_timeout_s = 0;  // 0 = unbounded (SO_RCVTIMEO/SO_SNDTIMEO off)
  // last transport error: 0 ok, -1 connection lost, -3 socket deadline
  // expired (the Python layer maps these to typed errors)
  std::atomic<int> last_err{0};
  // poisoned: a failed/interrupted rpc shutdown() the stream. The fd is
  // NOT closed until pt_store_client_free so pt_store_client_shutdown can
  // always safely shutdown() it from another thread (shutdown on a live
  // fd is thread-safe; close would let the number be recycled under a
  // concurrent recv).
  std::atomic<bool> dead{false};
};

void set_socket_deadline(int fd, double secs) {
  timeval tv{};
  if (secs > 0) {
    tv.tv_sec = (time_t)secs;
    tv.tv_usec = (suseconds_t)((secs - (double)tv.tv_sec) * 1e6);
  }
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
}

// deadline_s >= 0 overrides the client's default socket deadline for THIS
// call only (used by the bounded wait, whose server-side timeout outlives
// the per-op budget). The override is applied and restored under c->mu so
// a concurrent rpc on the same client never sees a foreign deadline.
bool client_rpc(StoreClient* c, uint8_t cmd, const std::string& key,
                const void* val, uint32_t vlen, int64_t* status,
                std::vector<uint8_t>* reply, double deadline_s = -1.0) {
  std::lock_guard<std::mutex> lk(c->mu);
  auto fail = [&]() {
    // a deadline expiry mid-message leaves the stream desynced: poison the
    // connection so no later op reads a stale half-reply as its own
    // (shutdown, not close — see StoreClient::dead)
    c->last_err.store((errno == EAGAIN || errno == EWOULDBLOCK) ? -3 : -1);
    if (c->fd >= 0) ::shutdown(c->fd, SHUT_RDWR);
    c->dead.store(true);
    return false;
  };
  if (c->fd < 0 || c->dead.load()) {
    c->last_err.store(-1);
    return false;
  }
  // one CUMULATIVE deadline across every chunk of the whole rpc: each
  // chunk re-arms SO_RCVTIMEO/SO_SNDTIMEO from the REMAINING budget, so a
  // peer trickling one byte per poll can't stretch one logical call past
  // the bound (mirrors utils/deadline.py recv_exact on the Python side)
  double eff = deadline_s >= 0 ? deadline_s : c->op_timeout_s;
  double abs_dl = eff > 0 ? now_monotonic_s() + eff : 0;
  auto io_full = [&](void* buf, size_t n, bool reading) {
    auto* p = (uint8_t*)buf;
    while (n > 0) {
      if (abs_dl > 0) {
        double left = abs_dl - now_monotonic_s();
        if (left <= 0) {
          errno = EAGAIN;  // classify as deadline expiry in fail()
          return false;
        }
        set_socket_deadline(c->fd, left < 0.01 ? 0.01 : left);
      }
      ssize_t r = reading ? ::recv(c->fd, p, n, 0)
                          : ::send(c->fd, p, n, MSG_NOSIGNAL);
      if (r == 0 && reading) {
        errno = ECONNRESET;
        return false;
      }
      if (r <= 0) return false;
      p += r;
      n -= (size_t)r;
    }
    return true;
  };
  auto io = [&]() {
    uint32_t klen = (uint32_t)key.size();
    uint8_t cmd_b = cmd;
    if (!io_full(&cmd_b, 1, false) || !io_full(&klen, 4, false) ||
        (klen && !io_full((void*)key.data(), klen, false)) ||
        !io_full(&vlen, 4, false) ||
        (vlen && !io_full((void*)val, vlen, false)))
      return false;
    uint32_t rlen;
    if (!io_full(status, 8, true) || !io_full(&rlen, 4, true)) return false;
    reply->resize(rlen);
    if (rlen && !io_full(reply->data(), rlen, true)) return false;
    return true;
  };
  if (!io()) return fail();
  if (abs_dl > 0) set_socket_deadline(c->fd, c->op_timeout_s);
  c->last_err.store(0);
  return true;
}

}  // namespace

PT_API void* pt_store_client_new(const char* host, int port, double timeout_s) {
  double deadline = now_monotonic_s() + (timeout_s > 0 ? timeout_s : 1e9);
  do {
    int fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return nullptr;
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)port);
    if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
      ::close(fd);
      return nullptr;  // caller resolves hostnames to IPv4 in Python
    }
    if (::connect(fd, (sockaddr*)&addr, sizeof(addr)) == 0) {
      int one = 1;
      setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      auto* c = new StoreClient();
      c->fd = fd;
      // bound the handshake: a listener that accepts but never answers the
      // ping (half-up master, wrong service) must not wedge the connect
      set_socket_deadline(fd, 5.0);
      int64_t status = 0;
      std::vector<uint8_t> reply;
      if (client_rpc(c, kPing, "", nullptr, 0, &status, &reply) &&
          status == 42) {
        set_socket_deadline(c->fd, c->op_timeout_s);
        return c;
      }
      if (c->fd >= 0) ::close(c->fd);  // sole owner: safe to really close
      delete c;
      return nullptr;
    }
    ::close(fd);
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
  } while (now_monotonic_s() < deadline);
  return nullptr;
}

PT_API int pt_store_set(void* c_, const char* key, const void* val, long n) {
  int64_t status = 0;
  std::vector<uint8_t> reply;
  if (!client_rpc((StoreClient*)c_, kSet, key, val, (uint32_t)n, &status, &reply))
    return -1;
  return 0;
}

PT_API long pt_store_get(void* c_, const char* key, void** out) {
  int64_t status = 0;
  std::vector<uint8_t> reply;
  if (!client_rpc((StoreClient*)c_, kGet, key, nullptr, 0, &status, &reply))
    return -1;
  if (status < 0) return -1;
  long n = (long)reply.size();
  *out = malloc((size_t)(n > 0 ? n : 1));
  memcpy(*out, reply.data(), (size_t)n);
  return n;
}

PT_API long long pt_store_add(void* c_, const char* key, long long delta) {
  int64_t status = 0;
  std::vector<uint8_t> reply;
  int64_t d = delta;
  if (!client_rpc((StoreClient*)c_, kAdd, key, &d, 8, &status, &reply))
    return INT64_MIN;
  return status;
}

PT_API int pt_store_wait(void* c_, const char* key) {
  int64_t status = 0;
  std::vector<uint8_t> reply;
  if (!client_rpc((StoreClient*)c_, kWait, key, nullptr, 0, &status, &reply))
    return -1;
  return status < 0 ? -1 : 0;
}

// Bounded wait: the SERVER enforces timeout_s (kWaitT) while the client
// socket deadline is temporarily widened past it, so the reply — present,
// timed out, or stopping — always arrives instead of the client guessing.
// Returns 0 key present, -3 deadline expired, -1 transport/server error.
PT_API int pt_store_wait_timeout(void* c_, const char* key, double timeout_s) {
  auto* c = (StoreClient*)c_;
  if (timeout_s < 0) timeout_s = 0;
  int64_t ms = (int64_t)(timeout_s * 1e3);
  int64_t status = 0;
  std::vector<uint8_t> reply;
  // per-call socket-deadline override is applied inside client_rpc under
  // c->mu, so a concurrent rpc on this client never runs with our widened
  // deadline (or has its fd's options mutated mid-read)
  bool ok = client_rpc(c, kWaitT, key, &ms, 8, &status, &reply,
                       timeout_s + 5.0);
  if (!ok) return c->last_err.load() == -3 ? -3 : -1;
  return status == 0 ? 0 : (status == -3 ? -3 : -1);
}

// Per-operation socket deadline for every subsequent rpc on this client
// (0 disables). A partitioned master then fails each call within the bound
// instead of hanging recv() forever.
PT_API void pt_store_client_set_op_timeout(void* c_, double secs) {
  auto* c = (StoreClient*)c_;
  std::lock_guard<std::mutex> lk(c->mu);
  c->op_timeout_s = secs > 0 ? secs : 0;
  if (c->fd >= 0) set_socket_deadline(c->fd, c->op_timeout_s);
}

// Last transport error on this client: 0 ok, -1 connection lost,
// -3 socket deadline expired (typed-error mapping happens in Python).
PT_API int pt_store_client_last_error(void* c_) {
  return ((StoreClient*)c_)->last_err.load();
}

// Interrupt an in-flight rpc from another thread: shutdown() wakes a
// blocked recv immediately and poisons the client, so stop() never waits
// out a long server-side wait. Safe without c->mu — the fd stays
// allocated until pt_store_client_free.
PT_API void pt_store_client_shutdown(void* c_) {
  auto* c = (StoreClient*)c_;
  c->dead.store(true);
  if (c->fd >= 0) ::shutdown(c->fd, SHUT_RDWR);
}

// 1 iff the client can still carry requests (connected and not poisoned).
// Lets the op layer detect dead-at-entry BEFORE sending, where reconnect
// is single-send safe even for non-idempotent ops like add.
PT_API int pt_store_client_ok(void* c_) {
  auto* c = (StoreClient*)c_;
  return (c->fd >= 0 && !c->dead.load()) ? 1 : 0;
}

PT_API int pt_store_delete(void* c_, const char* key) {
  int64_t status = 0;
  std::vector<uint8_t> reply;
  if (!client_rpc((StoreClient*)c_, kDel, key, nullptr, 0, &status, &reply))
    return -1;
  return (int)status;
}

PT_API int pt_store_lease(void* c_, const char* key, long long ttl_ms) {
  int64_t status = 0;
  std::vector<uint8_t> reply;
  int64_t t = ttl_ms;
  if (!client_rpc((StoreClient*)c_, kLease, key, &t, 8, &status, &reply))
    return -1;
  return 0;
}

PT_API int pt_store_lease_check(void* c_, const char* key) {
  int64_t status = 0;
  std::vector<uint8_t> reply;
  if (!client_rpc((StoreClient*)c_, kLeaseCheck, key, nullptr, 0, &status,
                  &reply))
    return -1;
  return (int)status;  // 1 alive, 0 expired/absent
}

PT_API void pt_store_client_free(void* c_) {
  auto* c = (StoreClient*)c_;
  if (c->fd >= 0) ::close(c->fd);
  delete c;
}

// ---------------------------------------------------------------------------
// RPC transport — native framing + HMAC-SHA256 auth + threaded server
// ---------------------------------------------------------------------------
// The Python layer (distributed/rpc.py) keeps pickle (de)serialization and
// request execution; this section owns everything the reference does in its
// brpc C++ transport (paddle/fluid/distributed/rpc/): sockets, framing,
// authentication, connection threads, request/response correlation.
// Wire format (unchanged from the bootstrap Python transport so both
// interoperate): u64le payload_len | 32-byte HMAC-SHA256(payload) | payload.

namespace {

// Compact SHA-256 (FIPS 180-4); message fits memory, single-shot.
struct Sha256 {
  static constexpr uint32_t K[64] = {
      0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
      0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
      0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
      0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
      0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
      0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
      0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
      0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
      0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
      0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
      0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

  static uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

  static void digest(const uint8_t* msg, size_t len, uint8_t out[32]) {
    uint32_t h[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                     0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
    size_t total = len;
    size_t padded = ((len + 8) / 64 + 1) * 64;
    std::vector<uint8_t> buf(padded, 0);
    memcpy(buf.data(), msg, len);
    buf[len] = 0x80;
    uint64_t bits = (uint64_t)total * 8;
    for (int i = 0; i < 8; ++i)
      buf[padded - 1 - i] = (uint8_t)(bits >> (8 * i));
    for (size_t off = 0; off < padded; off += 64) {
      uint32_t w[64];
      for (int i = 0; i < 16; ++i)
        w[i] = (uint32_t)buf[off + 4 * i] << 24 |
               (uint32_t)buf[off + 4 * i + 1] << 16 |
               (uint32_t)buf[off + 4 * i + 2] << 8 |
               (uint32_t)buf[off + 4 * i + 3];
      for (int i = 16; i < 64; ++i) {
        uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
        uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
        w[i] = w[i - 16] + s0 + w[i - 7] + s1;
      }
      uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
               g = h[6], hh = h[7];
      for (int i = 0; i < 64; ++i) {
        uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
        uint32_t ch = (e & f) ^ (~e & g);
        uint32_t t1 = hh + S1 + ch + K[i] + w[i];
        uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
        uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
        uint32_t t2 = S0 + maj;
        hh = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + t2;
      }
      h[0] += a; h[1] += b; h[2] += c; h[3] += d;
      h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
    }
    for (int i = 0; i < 8; ++i) {
      out[4 * i] = (uint8_t)(h[i] >> 24);
      out[4 * i + 1] = (uint8_t)(h[i] >> 16);
      out[4 * i + 2] = (uint8_t)(h[i] >> 8);
      out[4 * i + 3] = (uint8_t)h[i];
    }
  }
};

constexpr uint32_t Sha256::K[64];

void hmac_sha256(const uint8_t* key, size_t klen, const uint8_t* msg,
                 size_t mlen, uint8_t out[32]) {
  uint8_t k[64] = {0};
  if (klen > 64) {
    Sha256::digest(key, klen, k);
  } else {
    memcpy(k, key, klen);
  }
  std::vector<uint8_t> inner(64 + mlen);
  for (int i = 0; i < 64; ++i) inner[i] = k[i] ^ 0x36;
  memcpy(inner.data() + 64, msg, mlen);
  uint8_t ih[32];
  Sha256::digest(inner.data(), inner.size(), ih);
  uint8_t outer[64 + 32];
  for (int i = 0; i < 64; ++i) outer[i] = k[i] ^ 0x5c;
  memcpy(outer + 64, ih, 32);
  Sha256::digest(outer, sizeof(outer), out);
}

bool consteq(const uint8_t* a, const uint8_t* b, size_t n) {
  uint8_t acc = 0;
  for (size_t i = 0; i < n; ++i) acc |= a[i] ^ b[i];
  return acc == 0;
}

bool send_frame(int fd, const uint8_t* secret, size_t slen,
                const uint8_t* payload, uint64_t n) {
  uint8_t hdr[8 + 32];
  for (int i = 0; i < 8; ++i) hdr[i] = (uint8_t)(n >> (8 * i));  // u64le
  hmac_sha256(secret, slen, payload, n, hdr + 8);
  return write_full(fd, hdr, sizeof(hdr)) && write_full(fd, payload, n);
}

bool recv_frame(int fd, const uint8_t* secret, size_t slen,
                std::vector<uint8_t>* out) {
  uint8_t hdr[8 + 32];
  if (!read_full(fd, hdr, sizeof(hdr))) return false;
  uint64_t n = 0;
  for (int i = 7; i >= 0; --i) n = (n << 8) | hdr[i];
  // The length is UNAUTHENTICATED at this point: allocate in bounded chunks
  // while streaming, so a forged header cannot OOM the worker before the
  // HMAC check rejects it (the hash still runs over the full payload only
  // for genuinely-received bytes).
  constexpr uint64_t kMaxFrame = 1ull << 33;   // 8 GiB protocol ceiling
  constexpr uint64_t kChunk = 4ull << 20;      // 4 MiB allocation steps
  if (n > kMaxFrame) return false;
  out->clear();
  uint64_t got = 0;
  while (got < n) {
    uint64_t step = n - got < kChunk ? n - got : kChunk;
    out->resize(got + step);  // grows only as real bytes arrive
    if (!read_full(fd, out->data() + got, step)) return false;
    got += step;
  }
  uint8_t want[32];
  hmac_sha256(secret, slen, out->data(), n, want);
  return consteq(hdr + 8, want, 32);  // drop unauthenticated BEFORE any use
}

struct RpcRequest {
  long id;
  std::vector<uint8_t> payload;
};

struct RpcServer {
  int listen_fd = -1;
  int port = 0;
  std::vector<uint8_t> secret;
  std::atomic<bool> stopping{false};
  std::atomic<long> next_id{1};
  std::atomic<int> active_conns{0};
  std::thread accept_thread;

  std::mutex mu;
  std::condition_variable cv_req;    // inbound work for the executor
  std::condition_variable cv_resp;   // responses ready for conn threads
  std::deque<RpcRequest> inbound;
  std::map<long, std::vector<uint8_t>> responses;
  std::set<int> conn_fds;            // live accepted sockets (for teardown)

  void accept_loop() {
    while (!stopping.load()) {
      sockaddr_in peer{};
      socklen_t plen = sizeof(peer);
      int fd = ::accept(listen_fd, (sockaddr*)&peer, &plen);
      if (fd < 0) {
        if (stopping.load()) break;
        continue;
      }
      {
        std::lock_guard<std::mutex> g(mu);
        conn_fds.insert(fd);
      }
      // detached per-connection thread: a long-lived worker serves many
      // one-shot client connections, so finished threads must not pile up
      // in a join list; stop() waits on active_conns instead
      active_conns.fetch_add(1);
      std::thread([this, fd] { serve(fd); }).detach();
    }
  }

  void serve(int fd) {
    std::vector<uint8_t> req;
    while (!stopping.load() && recv_frame(fd, secret.data(), secret.size(), &req)) {
      long id = next_id.fetch_add(1);
      {
        std::lock_guard<std::mutex> g(mu);
        inbound.push_back({id, std::move(req)});
      }
      cv_req.notify_one();
      std::vector<uint8_t> resp;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_resp.wait(lk, [&] {
          return stopping.load() || responses.count(id) != 0;
        });
        if (stopping.load()) break;
        resp = std::move(responses[id]);
        responses.erase(id);
      }
      if (!send_frame(fd, secret.data(), secret.size(), resp.data(),
                      resp.size()))
        break;
      req.clear();
    }
    {
      // close under the same lock stop() iterates under, so a reused fd
      // number can never be shutdown() by teardown after we released it
      std::lock_guard<std::mutex> g(mu);
      conn_fds.erase(fd);
      ::close(fd);
    }
    active_conns.fetch_sub(1);
    cv_resp.notify_all();  // stop() may be waiting for the count to drain
  }
};

}  // namespace

PT_API void* pt_rpc_server_start(const char* bind_ip, const void* secret,
                                 int secret_len) {
  auto* s = new RpcServer();
  s->secret.assign((const uint8_t*)secret, (const uint8_t*)secret + secret_len);
  s->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = 0;
  inet_pton(AF_INET, bind_ip, &addr.sin_addr);
  if (bind(s->listen_fd, (sockaddr*)&addr, sizeof(addr)) != 0 ||
      listen(s->listen_fd, 64) != 0) {
    ::close(s->listen_fd);
    delete s;
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(s->listen_fd, (sockaddr*)&addr, &alen);
  s->port = ntohs(addr.sin_port);
  s->accept_thread = std::thread([s] { s->accept_loop(); });
  return s;
}

PT_API int pt_rpc_server_port(void* s_) { return ((RpcServer*)s_)->port; }

// Blocking pop of the next authenticated request for the Python executor.
// Returns payload length (caller frees *out with pt_free), -1 on timeout,
// -2 when the server is stopping. *id_out correlates pt_rpc_send_response.
PT_API long pt_rpc_next_request(void* s_, void** out, long* id_out,
                                double timeout_s) {
  auto* s = (RpcServer*)s_;
  std::unique_lock<std::mutex> lk(s->mu);
  bool ok = s->cv_req.wait_for(lk, std::chrono::duration<double>(timeout_s),
                               [&] { return s->stopping.load() ||
                                            !s->inbound.empty(); });
  if (s->stopping.load()) return -2;
  if (!ok) return -1;
  RpcRequest r = std::move(s->inbound.front());
  s->inbound.pop_front();
  lk.unlock();
  *id_out = r.id;
  long n = (long)r.payload.size();
  *out = malloc((size_t)n);
  memcpy(*out, r.payload.data(), (size_t)n);
  return n;
}

PT_API void pt_rpc_send_response(void* s_, long id, const void* data, long n) {
  auto* s = (RpcServer*)s_;
  {
    std::lock_guard<std::mutex> g(s->mu);
    s->responses[id].assign((const uint8_t*)data, (const uint8_t*)data + n);
  }
  s->cv_resp.notify_all();
}

PT_API void pt_rpc_server_stop(void* s_) {
  auto* s = (RpcServer*)s_;
  s->stopping.store(true);
  ::shutdown(s->listen_fd, SHUT_RDWR);
  ::close(s->listen_fd);
  {
    // unblock handler threads parked in recv_frame on open connections —
    // without this, a stalled/half-open peer would deadlock the join below
    std::lock_guard<std::mutex> g(s->mu);
    for (int fd : s->conn_fds) ::shutdown(fd, SHUT_RDWR);
  }
  s->cv_req.notify_all();
  s->cv_resp.notify_all();
  if (s->accept_thread.joinable()) s->accept_thread.join();
  // detached conn threads exit promptly once their fds are shutdown; wait
  // (bounded) for the count to drain so freeing the server is safe
  auto deadline = std::chrono::steady_clock::now() + std::chrono::seconds(10);
  std::unique_lock<std::mutex> lk(s->mu);
  s->cv_resp.wait_until(lk, deadline,
                        [&] { return s->active_conns.load() == 0; });
}

PT_API void pt_rpc_server_free(void* s_) { delete (RpcServer*)s_; }

// Native blocking client: connect, send one authenticated request frame,
// read the authenticated response. Returns response length into *out
// (pt_free), or a negative error (-1 connect, -2 send, -3 recv/auth).
PT_API long pt_rpc_call(const char* ip, int port, const void* secret,
                        int secret_len, const void* payload, long n,
                        void** out, double timeout_s) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  timeval tv{};
  tv.tv_sec = (long)timeout_s;
  tv.tv_usec = (long)((timeout_s - (double)tv.tv_sec) * 1e6);
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  inet_pton(AF_INET, ip, &addr.sin_addr);
  if (connect(fd, (sockaddr*)&addr, sizeof(addr)) != 0) {
    ::close(fd);
    return -1;
  }
  const auto* sec = (const uint8_t*)secret;
  if (!send_frame(fd, sec, (size_t)secret_len, (const uint8_t*)payload,
                  (uint64_t)n)) {
    ::close(fd);
    return -2;
  }
  std::vector<uint8_t> resp;
  bool ok = recv_frame(fd, sec, (size_t)secret_len, &resp);
  ::close(fd);
  if (!ok) return -3;
  long rn = (long)resp.size();
  *out = malloc((size_t)rn);
  memcpy(*out, resp.data(), (size_t)rn);
  return rn;
}
