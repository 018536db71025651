// TSAN/stress harness for the SPSC ring (SURVEY §5: the reference relies
// on the BPF verifier + Go runtime for safety; this build runs its C++
// concurrency under ThreadSanitizer instead). Built and run by
// inspektor_gadget_tpu_torch/native.py StressHarness("ring_stress"),
// plain or with tsan=True.
//
// One producer pushes 2M events flat out against a small ring while a
// consumer drains; asserts conservation: produced == consumed + dropped.

#include <cassert>
#include <cstdio>
#include <thread>

#include "ringbuf.h"

int main() {
  ig::RingBuffer ring(1 << 10);
  const uint64_t N = 2'000'000;
  std::thread producer([&] {
    ig::Event ev{};
    for (uint64_t i = 0; i < N; i++) {
      ev.ts_ns = i;
      ring.push(ev);
    }
  });
  uint64_t consumed = 0;
  ig::Event out[256];
  std::thread consumer([&] {
    while (consumed + ring.drops() < N) {
      size_t got = ring.pop(out, 256);
      consumed += got;
      if (!got) std::this_thread::yield();
    }
  });
  producer.join();
  consumer.join();
  // drain the tail
  for (size_t got; (got = ring.pop(out, 256)) > 0;) consumed += got;
  uint64_t dropped = ring.drops();
  printf("produced=%llu consumed=%llu dropped=%llu\n",
         (unsigned long long)ring.produced() + dropped,
         (unsigned long long)consumed, (unsigned long long)dropped);
  assert(ring.produced() == consumed);
  assert(consumed + dropped == N);
  printf("ring stress OK\n");
  return 0;
}
