// The control plane's star to rank 0 over TCP.
//
// A copy of the star legs of the JAX package's
// horovod_tpu/runtime/cpp/transport.{h,cc}: Create (the bootstrap),
// GatherToRoot and BcastFromRoot. The ring data plane is left out: the
// port's executor performs the responses over NCCL or gloo.
#pragma once

#include <memory>
#include <string>
#include <vector>

#include "common.h"
#include "socketio.h"

namespace hvdtorch {

class Transport {
 public:
  // Collective bootstrap: rank 0 listens on coord_port and every other
  // rank connects to it (coord_addr:coord_port) within timeout_s.
  static Status Create(int rank, int size, const std::string& coord_addr,
                       int coord_port, double timeout_s,
                       std::unique_ptr<Transport>* out);

  int rank() const { return rank_; }
  int size() const { return size_; }

  // Root gathers one frame from every rank (index = rank; root contributes
  // its own), then broadcasts one frame to all.
  Status GatherToRoot(const std::string& mine, std::vector<std::string>* all);
  Status BcastFromRoot(std::string* frame);  // root: in-out; others: out
  // End every socket (Socket::Shutdown): a cycle blocked in the star on
  // this rank returns with an error, and peers see the connection end.
  void Abort();

 private:
  Transport(int rank, int size) : rank_(rank), size_(size) {}

  int rank_, size_;
  // Root holds size-1 worker sockets (index rank-1); workers hold one
  // socket to root.
  std::vector<Socket> control_;
  Socket to_root_;
};

}  // namespace hvdtorch
