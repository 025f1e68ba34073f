// Native parameter-server weight store.
//
// The reference's server is Flask/raw-socket Python moving *pickled*
// numpy lists — O(model bytes) of serialization per sync, with the GIL
// in the path (SURVEY.md §2 "Parameter server", §3.2 "the main
// scalability cliff"). This store is the native equivalent: a threaded
// TCP server over one contiguous float32 buffer, zero
// serialization (raw buffer on the wire), updates applied with a
// vectorizable in-place add. The async/hogwild distinction is the same
// one the reference makes: a mutex around the update, or not.
//
// Exposed as a C API for ctypes (no pybind11 in this environment).
//
// Wire protocol (all little-endian):
//   'g'                       -> server: u64 nbytes, raw buffer
//   'u', u64 nbytes, raw delta -> server applies weights += delta, replies 'k'
//   's', u64 nbytes, raw data  -> server overwrites weights, replies 'k'
//   'q'                       -> close

#include <arpa/inet.h>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Server {
  std::vector<float> weights;
  std::mutex mu;          // update lock ('asynchronous' mode)
  bool use_lock = true;   // false = hogwild
  int listen_fd = -1;
  int port = 0;
  std::atomic<bool> running{false};
  std::thread accept_thread;
  // open-connection registry: stop() closes these to unblock recv(),
  // then waits for the handler count to drain before the delete
  std::mutex conn_mu;
  std::vector<int> conn_fds;
  std::atomic<int> active_handlers{0};
};

void register_conn(Server* s, int fd) {
  std::lock_guard<std::mutex> g(s->conn_mu);
  s->conn_fds.push_back(fd);
}

void unregister_conn(Server* s, int fd) {
  std::lock_guard<std::mutex> g(s->conn_mu);
  for (auto it = s->conn_fds.begin(); it != s->conn_fds.end(); ++it) {
    if (*it == fd) {
      s->conn_fds.erase(it);
      break;
    }
  }
}

bool read_exact(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_exact(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t w = ::send(fd, p, n, 0);
    if (w <= 0) return false;
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

void handle_connection(Server* s, int fd) {
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  std::vector<float> scratch;
  while (s->running.load()) {
    char op = 0;
    if (!read_exact(fd, &op, 1)) break;
    if (op == 'g') {
      uint64_t nbytes = s->weights.size() * sizeof(float);
      // snapshot under the lock so readers never see a torn update
      std::vector<float> copy;
      {
        std::lock_guard<std::mutex> g(s->mu);
        copy = s->weights;
      }
      if (!write_exact(fd, &nbytes, 8)) break;
      if (!write_exact(fd, copy.data(), nbytes)) break;
    } else if (op == 'u' || op == 's') {
      uint64_t nbytes = 0;
      if (!read_exact(fd, &nbytes, 8)) break;
      if (nbytes != s->weights.size() * sizeof(float)) break;  // protocol error
      scratch.resize(nbytes / sizeof(float));
      if (!read_exact(fd, scratch.data(), nbytes)) break;
      float* w = s->weights.data();
      const float* d = scratch.data();
      size_t n = scratch.size();
      if (op == 's') {
        std::lock_guard<std::mutex> g(s->mu);
        std::memcpy(w, d, nbytes);
      } else if (s->use_lock) {
        std::lock_guard<std::mutex> g(s->mu);
        for (size_t i = 0; i < n; ++i) w[i] += d[i];
      } else {
        // hogwild: the reference's deliberate race, faithfully lock-free
        for (size_t i = 0; i < n; ++i) w[i] += d[i];
      }
      char ok = 'k';
      if (!write_exact(fd, &ok, 1)) break;
    } else {  // 'q' or unknown
      break;
    }
  }
  unregister_conn(s, fd);
  ::close(fd);
  s->active_handlers.fetch_sub(1);
}

void accept_loop(Server* s) {
  while (s->running.load()) {
    sockaddr_in peer{};
    socklen_t len = sizeof(peer);
    int fd = ::accept(s->listen_fd, reinterpret_cast<sockaddr*>(&peer), &len);
    if (fd < 0) {
      if (!s->running.load()) break;
      continue;
    }
    if (!s->running.load()) {
      ::close(fd);
      break;
    }
    register_conn(s, fd);
    s->active_handlers.fetch_add(1);
    std::thread(handle_connection, s, fd).detach();
  }
}

}  // namespace

extern "C" {

// Returns an opaque handle, or nullptr on bind failure.
void* eps_server_create(uint64_t num_floats, int use_lock, int port) {
  auto* s = new Server();
  s->weights.assign(num_floats, 0.0f);
  s->use_lock = use_lock != 0;
  s->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (s->listen_fd < 0) {
    delete s;
    return nullptr;
  }
  int one = 1;
  ::setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(s->listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      ::listen(s->listen_fd, 64) != 0) {
    ::close(s->listen_fd);
    delete s;
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  ::getsockname(s->listen_fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  s->port = ntohs(addr.sin_port);
  s->running.store(true);
  s->accept_thread = std::thread(accept_loop, s);
  return s;
}

int eps_server_port(void* handle) {
  return static_cast<Server*>(handle)->port;
}

// Both return 0 on success, -1 on size mismatch: a caller-side flattener
// built from differently-shaped weights must be an error, not a silent
// out-of-bounds memcpy (the wire path already validates nbytes).
int eps_server_set(void* handle, const float* data, uint64_t n) {
  auto* s = static_cast<Server*>(handle);
  if (n != s->weights.size()) return -1;
  std::lock_guard<std::mutex> g(s->mu);
  std::memcpy(s->weights.data(), data, n * sizeof(float));
  return 0;
}

int eps_server_get(void* handle, float* out, uint64_t n) {
  auto* s = static_cast<Server*>(handle);
  if (n != s->weights.size()) return -1;
  std::lock_guard<std::mutex> g(s->mu);
  std::memcpy(out, s->weights.data(), n * sizeof(float));
  return 0;
}

void eps_server_stop(void* handle) {
  auto* s = static_cast<Server*>(handle);
  s->running.store(false);
  ::shutdown(s->listen_fd, SHUT_RDWR);
  ::close(s->listen_fd);
  if (s->accept_thread.joinable()) s->accept_thread.join();
  // unblock every handler parked in recv(), then wait for all of them
  // to unregister before freeing the Server
  {
    std::lock_guard<std::mutex> g(s->conn_mu);
    for (int fd : s->conn_fds) ::shutdown(fd, SHUT_RDWR);
  }
  while (s->active_handlers.load() > 0) {
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
  }
  delete s;
}

}  // extern "C"
