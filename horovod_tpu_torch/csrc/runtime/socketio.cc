#include "socketio.h"

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cerrno>
#include <chrono>
#include <cstring>
#include <thread>

namespace hvdtorch {

double NowSeconds() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

Socket& Socket::operator=(Socket&& other) noexcept {
  if (this != &other) {
    Close();
    fd_ = other.fd_;
    other.fd_ = -1;
  }
  return *this;
}

Socket::~Socket() { Close(); }

void Socket::Close() {
  if (fd_ >= 0) {
    ::close(fd_);
    fd_ = -1;
  }
}

void Socket::Shutdown() {
  if (fd_ >= 0) ::shutdown(fd_, SHUT_RDWR);
}

Status Socket::WriteAll(const void* data, size_t n) {
  const char* p = static_cast<const char*>(data);
  while (n > 0) {
    ssize_t w = ::send(fd_, p, n, MSG_NOSIGNAL);
    if (w < 0) {
      if (errno == EINTR) continue;
      return Status::Error(std::string("send: ") + std::strerror(errno));
    }
    p += w;
    n -= static_cast<size_t>(w);
  }
  return Status::OK();
}

Status Socket::ReadAll(void* data, size_t n, double deadline) {
  char* p = static_cast<char*>(data);
  while (n > 0) {
    if (deadline > 0) {
      double remaining = deadline - NowSeconds();
      if (remaining <= 0) return Status::Error("read deadline exceeded");
      pollfd pfd{fd_, POLLIN, 0};
      int rc = ::poll(&pfd, 1, static_cast<int>(remaining * 1000) + 1);
      if (rc == 0) return Status::Error("read deadline exceeded");
      if (rc < 0 && errno != EINTR) {
        return Status::Error(std::string("poll: ") + std::strerror(errno));
      }
    }
    ssize_t r = ::recv(fd_, p, n, 0);
    if (r < 0) {
      if (errno == EINTR) continue;
      return Status::Error(std::string("recv: ") + std::strerror(errno));
    }
    if (r == 0) return Status::Error("peer closed connection");
    p += r;
    n -= static_cast<size_t>(r);
  }
  return Status::OK();
}

Status Socket::WriteFrame(const std::string& payload) {
  uint32_t len = static_cast<uint32_t>(payload.size());
  Status s = WriteAll(&len, sizeof(len));
  if (!s.ok) return s;
  return WriteAll(payload.data(), payload.size());
}

Status Socket::ReadFrame(std::string* payload, double deadline) {
  uint32_t len = 0;
  Status s = ReadAll(&len, sizeof(len), deadline);
  if (!s.ok) return s;
  payload->resize(len);
  if (len == 0) return Status::OK();
  return ReadAll(payload->data(), len, deadline);
}

std::string Socket::LocalAddr() const {
  sockaddr_in addr{};
  socklen_t len = sizeof(addr);
  if (::getsockname(fd_, reinterpret_cast<sockaddr*>(&addr), &len) != 0) {
    return "127.0.0.1";
  }
  char buf[INET_ADDRSTRLEN];
  ::inet_ntop(AF_INET, &addr.sin_addr, buf, sizeof(buf));
  return buf;
}

Status Socket::Connect(const std::string& host, int port, double timeout_s,
                       Socket* out) {
  addrinfo hints{};
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  addrinfo* res = nullptr;
  std::string port_str = std::to_string(port);
  double deadline = NowSeconds() + timeout_s;
  // Retry until deadline: the listener (rank 0) may not be up yet — this is
  // the worker-side rendezvous wait.
  while (true) {
    if (::getaddrinfo(host.c_str(), port_str.c_str(), &hints, &res) == 0) {
      int fd = ::socket(res->ai_family, res->ai_socktype, res->ai_protocol);
      if (fd >= 0) {
        int one = 1;
        ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
        if (::connect(fd, res->ai_addr, res->ai_addrlen) == 0) {
          ::freeaddrinfo(res);
          *out = Socket(fd);
          return Status::OK();
        }
        ::close(fd);
      }
      ::freeaddrinfo(res);
      res = nullptr;
    }
    if (NowSeconds() >= deadline) {
      return Status::Error("connect to " + host + ":" + port_str +
                           " timed out");
    }
    std::this_thread::sleep_for(std::chrono::milliseconds(20));
  }
}

Status Listener::Bind(int port) {
  fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd_ < 0) return Status::Error("socket() failed");
  int one = 1;
  ::setsockopt(fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = INADDR_ANY;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(fd_, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    return Status::Error(std::string("bind: ") + std::strerror(errno));
  }
  socklen_t len = sizeof(addr);
  ::getsockname(fd_, reinterpret_cast<sockaddr*>(&addr), &len);
  port_ = ntohs(addr.sin_port);
  if (::listen(fd_, 128) != 0) {
    return Status::Error(std::string("listen: ") + std::strerror(errno));
  }
  return Status::OK();
}

Status Listener::Accept(Socket* out, double timeout_s) {
  pollfd pfd{fd_, POLLIN, 0};
  // Clamp an already-passed deadline to an immediate poll — a negative
  // value would mean "block forever" and defeat the bootstrap timeout.
  int timeout_ms = timeout_s <= 0 ? 0 : static_cast<int>(timeout_s * 1000);
  int rc = ::poll(&pfd, 1, timeout_ms);
  if (rc == 0) return Status::Error("accept timed out");
  if (rc < 0) return Status::Error(std::string("poll: ") + std::strerror(errno));
  int cfd = ::accept(fd_, nullptr, nullptr);
  if (cfd < 0) return Status::Error(std::string("accept: ") + std::strerror(errno));
  int one = 1;
  ::setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  *out = Socket(cfd);
  return Status::OK();
}

void Listener::Close() {
  if (fd_ >= 0) {
    ::close(fd_);
    fd_ = -1;
  }
}

Listener::~Listener() { Close(); }

}  // namespace hvdtorch
