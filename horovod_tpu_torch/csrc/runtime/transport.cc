#include "transport.h"

#include <cstdio>

#include "logging.h"

namespace hvdtorch {

// -- bootstrap ---------------------------------------------------------------

Status Transport::Create(int rank, int size, const std::string& coord_addr,
                         int coord_port, double timeout_s,
                         std::unique_ptr<Transport>* out) {
  std::unique_ptr<Transport> t(new Transport(rank, size));
  if (size == 1) {
    *out = std::move(t);
    return Status::OK();
  }
  Status s;
  if (rank == 0) {
    Listener control_listener;
    s = control_listener.Bind(coord_port);
    if (!s.ok) return s;
    t->control_.resize(size - 1);
    int connected = 0;
    double deadline = NowSeconds() + timeout_s;
    while (connected < size - 1) {
      Socket sock;
      s = control_listener.Accept(&sock, deadline - NowSeconds());
      if (!s.ok) return s;
      // Hello frame: "<rank>". Deadline-bounded read: neither a silent nor
      // a trickling peer can hang the bootstrap.
      std::string hello;
      s = sock.ReadFrame(&hello, deadline);
      if (!s.ok) return s;
      int peer_rank = -1;
      if (std::sscanf(hello.c_str(), "%d", &peer_rank) != 1 ||
          peer_rank < 1 || peer_rank >= size ||
          t->control_[peer_rank - 1].valid()) {
        return Status::Error("bad hello frame: " + hello);
      }
      t->control_[peer_rank - 1] = std::move(sock);
      connected++;
    }
    // Every rank is connected: release the workers.
    for (auto& sock : t->control_) {
      s = sock.WriteFrame("ready");
      if (!s.ok) return s;
    }
  } else {
    s = Socket::Connect(coord_addr, coord_port, timeout_s, &t->to_root_);
    if (!s.ok) return s;
    s = t->to_root_.WriteFrame(std::to_string(rank));
    if (!s.ok) return s;
    std::string ready;
    s = t->to_root_.ReadFrame(&ready, NowSeconds() + timeout_s);
    if (!s.ok) return s;
    if (ready != "ready") return Status::Error("bad ready frame: " + ready);
  }
  *out = std::move(t);
  return Status::OK();
}

// -- control plane -----------------------------------------------------------

Status Transport::GatherToRoot(const std::string& mine,
                               std::vector<std::string>* all) {
  if (size_ == 1) {
    if (all) *all = {mine};
    return Status::OK();
  }
  if (rank_ == 0) {
    all->assign(size_, "");
    (*all)[0] = mine;
    for (int r = 1; r < size_; ++r) {
      Status s = control_[r - 1].ReadFrame(&(*all)[r]);
      if (!s.ok) return s;
    }
    return Status::OK();
  }
  return to_root_.WriteFrame(mine);
}

Status Transport::BcastFromRoot(std::string* frame) {
  if (size_ == 1) return Status::OK();
  if (rank_ == 0) {
    for (auto& sock : control_) {
      Status s = sock.WriteFrame(*frame);
      if (!s.ok) return s;
    }
    return Status::OK();
  }
  return to_root_.ReadFrame(frame);
}

void Transport::Abort() {
  for (auto& sock : control_) sock.Shutdown();
  to_root_.Shutdown();
}

}  // namespace hvdtorch
