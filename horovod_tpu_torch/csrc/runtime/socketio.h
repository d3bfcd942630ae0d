// A copy of the JAX package's horovod_tpu/runtime/cpp/socketio.{h,cc} under
// the port's namespace, with Socket::Shutdown added for the teardown.
//
// Minimal TCP socket layer: framed messages + raw buffer IO.
//
// Reference role: the transport under gloo_controller/mpi_controller. This
// is an original design: blocking sockets, length-prefixed frames for the
// control plane, raw chunked reads/writes for the data plane.
#pragma once

#include <cstdint>
#include <string>
#include <vector>

#include "common.h"

namespace hvdtorch {

class Socket {
 public:
  Socket() = default;
  explicit Socket(int fd) : fd_(fd) {}
  Socket(const Socket&) = delete;
  Socket& operator=(const Socket&) = delete;
  Socket(Socket&& other) noexcept : fd_(other.fd_) { other.fd_ = -1; }
  Socket& operator=(Socket&& other) noexcept;
  ~Socket();

  bool valid() const { return fd_ >= 0; }
  int fd() const { return fd_; }
  void Close();
  // End both directions without closing the descriptor: a thread blocked
  // reading this socket returns with the connection ended.
  void Shutdown();

  // Raw IO: loop until all n bytes moved (or error). A nonzero deadline
  // (NowSeconds()-based) bounds the WHOLE read — a trickling peer cannot
  // reset it per recv the way SO_RCVTIMEO alone would allow.
  Status WriteAll(const void* data, size_t n);
  Status ReadAll(void* data, size_t n, double deadline = 0.0);

  // Framed IO: uint32 little-endian length prefix.
  Status WriteFrame(const std::string& payload);
  Status ReadFrame(std::string* payload, double deadline = 0.0);

  // The address this socket's local end binds to (for peer discovery).
  std::string LocalAddr() const;

  static Status Connect(const std::string& host, int port, double timeout_s,
                        Socket* out);

 private:
  int fd_ = -1;
};

class Listener {
 public:
  // Bind to port (0 = ephemeral). Port() returns the actual port.
  Status Bind(int port);
  Status Accept(Socket* out, double timeout_s);
  int Port() const { return port_; }
  void Close();
  ~Listener();

 private:
  int fd_ = -1;
  int port_ = 0;
};

}  // namespace hvdtorch
