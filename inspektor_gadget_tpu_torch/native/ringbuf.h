// Single-producer single-consumer lock-free ring buffer with drop-on-full
// loss accounting.
//
// Behavioral contract from the reference's transport chain: perf ring
// buffers report LostSamples (pkg/gadgets/trace/exec/tracer/tracer.go:148-151),
// the gadget service drops on a full 1024-slot buffer
// (pkg/gadget-service/service.go:160-167), and streams carry an EventLost
// marker (pkg/gadgettracermanager/stream). Same semantics here: producers
// never block; every drop is counted; the consumer sees a monotone sequence
// number so gaps are auditable end-to-end (grpc-runtime.go:312-314's seq-gap
// check is reproduced at the Python rim).

#pragma once
#include <atomic>
#include <cstdint>
#include <vector>

#include "events.h"

namespace ig {

class RingBuffer {
 public:
  explicit RingBuffer(size_t capacity_pow2)
      : cap_(capacity_pow2), mask_(capacity_pow2 - 1), slots_(capacity_pow2) {
    // capacity must be a power of two
  }

  // Producer side. Returns false (and counts a drop) when full.
  bool push(const Event& ev) {
    uint64_t head = head_.load(std::memory_order_relaxed);
    uint64_t tail = tail_.load(std::memory_order_acquire);
    if (head - tail >= cap_) {
      drops_.fetch_add(1, std::memory_order_relaxed);
      return false;
    }
    slots_[head & mask_] = ev;
    head_.store(head + 1, std::memory_order_release);
    return true;
  }

  // Consumer side: pop up to n events into out; returns count.
  size_t pop(Event* out, size_t n) {
    uint64_t tail = tail_.load(std::memory_order_relaxed);
    uint64_t head = head_.load(std::memory_order_acquire);
    size_t avail = static_cast<size_t>(head - tail);
    size_t take = avail < n ? avail : n;
    for (size_t i = 0; i < take; i++) out[i] = slots_[(tail + i) & mask_];
    tail_.store(tail + take, std::memory_order_release);
    return take;
  }

  uint64_t drops() const { return drops_.load(std::memory_order_relaxed); }

  // Account losses that happened before the ring (e.g. poll-window churn a
  // scanner provably missed) so downstream gap auditing sees them too.
  void count_external_drops(uint64_t n) {
    drops_.fetch_add(n, std::memory_order_relaxed);
  }
  uint64_t produced() const { return head_.load(std::memory_order_relaxed); }
  uint64_t consumed() const { return tail_.load(std::memory_order_relaxed); }
  size_t size() const {
    return static_cast<size_t>(head_.load(std::memory_order_acquire) -
                               tail_.load(std::memory_order_acquire));
  }
  size_t capacity() const { return cap_; }

 private:
  const size_t cap_;
  const size_t mask_;
  std::vector<Event> slots_;
  alignas(64) std::atomic<uint64_t> head_{0};
  alignas(64) std::atomic<uint64_t> tail_{0};
  alignas(64) std::atomic<uint64_t> drops_{0};
};

}  // namespace ig
