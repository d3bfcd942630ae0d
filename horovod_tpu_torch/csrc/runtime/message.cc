#include "message.h"

#include <cstring>

namespace hvdtorch {

namespace {

class Writer {
 public:
  template <typename T>
  void Put(T v) {
    static_assert(std::is_trivially_copyable<T>::value, "scalar only");
    size_t off = buf_.size();
    buf_.resize(off + sizeof(T));
    std::memcpy(&buf_[off], &v, sizeof(T));
  }
  void PutString(const std::string& s) {
    Put<uint32_t>(static_cast<uint32_t>(s.size()));
    buf_.append(s);
  }
  std::string Take() { return std::move(buf_); }

 private:
  std::string buf_;
};

class Reader {
 public:
  explicit Reader(const std::string& data) : data_(data) {}
  template <typename T>
  bool Get(T* v) {
    if (pos_ + sizeof(T) > data_.size()) return false;
    std::memcpy(v, data_.data() + pos_, sizeof(T));
    pos_ += sizeof(T);
    return true;
  }
  bool GetString(std::string* s) {
    uint32_t len = 0;
    if (!Get(&len)) return false;
    if (pos_ + len > data_.size()) return false;
    s->assign(data_.data() + pos_, len);
    pos_ += len;
    return true;
  }

 private:
  const std::string& data_;
  size_t pos_ = 0;
};

void PutRequest(Writer* w, const Request& r) {
  w->PutString(r.name);
  w->Put<uint8_t>(static_cast<uint8_t>(r.op));
  w->Put<uint8_t>(static_cast<uint8_t>(r.reduce_op));
  w->Put<uint8_t>(static_cast<uint8_t>(r.dtype));
  w->Put<int64_t>(r.count);
  w->Put<int32_t>(r.root_rank);
  w->Put<double>(r.prescale);
  w->Put<double>(r.postscale);
  w->Put<int32_t>(r.process_set_id);
  w->PutString(r.group_key);
  w->Put<int32_t>(r.group_size);
}

bool GetRequest(Reader* rd, Request* r) {
  uint8_t op, rop, dt;
  if (!rd->GetString(&r->name) || !rd->Get(&op) || !rd->Get(&rop) ||
      !rd->Get(&dt) || !rd->Get(&r->count) || !rd->Get(&r->root_rank) ||
      !rd->Get(&r->prescale) || !rd->Get(&r->postscale) ||
      !rd->Get(&r->process_set_id) || !rd->GetString(&r->group_key) ||
      !rd->Get(&r->group_size)) {
    return false;
  }
  r->op = static_cast<OpType>(op);
  r->reduce_op = static_cast<ReduceOp>(rop);
  r->dtype = static_cast<DType>(dt);
  return true;
}

void PutResponse(Writer* w, const Response& r) {
  w->Put<uint8_t>(static_cast<uint8_t>(r.op));
  w->Put<uint8_t>(static_cast<uint8_t>(r.reduce_op));
  w->Put<uint8_t>(static_cast<uint8_t>(r.dtype));
  w->Put<int32_t>(r.active_ranks);
  w->Put<int32_t>(r.process_set_id);
  w->Put<uint8_t>(r.grouped ? 1 : 0);
  w->Put<int32_t>(r.root_rank);
  w->Put<double>(r.prescale);
  w->Put<double>(r.postscale);
  w->PutString(r.error);
  w->Put<uint32_t>(static_cast<uint32_t>(r.tensor_names.size()));
  for (size_t i = 0; i < r.tensor_names.size(); ++i) {
    w->PutString(r.tensor_names[i]);
    w->Put<int64_t>(r.counts[i]);
  }
}

bool GetResponse(Reader* rd, Response* r) {
  uint8_t op, rop, dt, grouped = 0;
  uint32_t n = 0;
  if (!rd->Get(&op) || !rd->Get(&rop) || !rd->Get(&dt) ||
      !rd->Get(&r->active_ranks) || !rd->Get(&r->process_set_id) ||
      !rd->Get(&grouped) || !rd->Get(&r->root_rank) ||
      !rd->Get(&r->prescale) || !rd->Get(&r->postscale) ||
      !rd->GetString(&r->error) || !rd->Get(&n)) {
    return false;
  }
  r->op = static_cast<OpType>(op);
  r->reduce_op = static_cast<ReduceOp>(rop);
  r->dtype = static_cast<DType>(dt);
  r->grouped = grouped != 0;
  r->tensor_names.resize(n);
  r->counts.resize(n);
  for (uint32_t i = 0; i < n; ++i) {
    if (!rd->GetString(&r->tensor_names[i]) || !rd->Get(&r->counts[i])) {
      return false;
    }
  }
  return true;
}

}  // namespace

std::string SerializeRequestList(const RequestList& list) {
  Writer w;
  w.Put<uint8_t>(list.shutdown ? 1 : 0);
  w.Put<uint8_t>(list.joined ? 1 : 0);
  w.Put<uint32_t>(static_cast<uint32_t>(list.cache_bits.size()));
  for (uint64_t word : list.cache_bits) w.Put<uint64_t>(word);
  w.Put<uint32_t>(static_cast<uint32_t>(list.requests.size()));
  for (const auto& r : list.requests) PutRequest(&w, r);
  return w.Take();
}

Status ParseRequestList(const std::string& data, RequestList* out) {
  Reader rd(data);
  uint8_t shutdown = 0, joined = 0;
  uint32_t nbits = 0, nreq = 0;
  if (!rd.Get(&shutdown) || !rd.Get(&joined) || !rd.Get(&nbits)) {
    return Status::Error("bad RequestList header");
  }
  out->shutdown = shutdown != 0;
  out->joined = joined != 0;
  out->cache_bits.resize(nbits);
  for (uint32_t i = 0; i < nbits; ++i) {
    if (!rd.Get(&out->cache_bits[i])) return Status::Error("bad cache bits");
  }
  if (!rd.Get(&nreq)) return Status::Error("bad RequestList count");
  out->requests.resize(nreq);
  for (uint32_t i = 0; i < nreq; ++i) {
    if (!GetRequest(&rd, &out->requests[i])) {
      return Status::Error("bad Request");
    }
  }
  return Status::OK();
}

std::string SerializeResponseList(const ResponseList& list) {
  Writer w;
  w.Put<uint8_t>(list.shutdown ? 1 : 0);
  w.Put<uint32_t>(static_cast<uint32_t>(list.responses.size()));
  for (const auto& r : list.responses) PutResponse(&w, r);
  return w.Take();
}

Status ParseResponseList(const std::string& data, ResponseList* out) {
  Reader rd(data);
  uint8_t shutdown = 0;
  uint32_t n = 0;
  if (!rd.Get(&shutdown) || !rd.Get(&n)) {
    return Status::Error("bad ResponseList header");
  }
  out->shutdown = shutdown != 0;
  out->responses.resize(n);
  for (uint32_t i = 0; i < n; ++i) {
    if (!GetResponse(&rd, &out->responses[i])) {
      return Status::Error("bad Response");
    }
  }
  return Status::OK();
}

}  // namespace hvdtorch
