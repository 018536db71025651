// Fixed-width wire event — the slot format of the capture ring buffer.
//
// Reference contract being replaced: per-gadget eBPF structs shipped through
// perf ring buffers (e.g. trace/exec's event struct,
// pkg/gadgets/trace/exec/tracer/bpf/execsnoop.bpf.c:41-167) and read by
// perf.Reader in Go (tracer.go:134-188). Here capture shims fill one
// fixed 64-byte slot per event; string identity (comm, filenames, qnames)
// is FNV-1a-hashed at capture time so the analytics plane works on fixed
// width keys, with a side vocab for un-hashing heavy hitters.

#pragma once
#include <cstdint>
#include <cstring>

namespace ig {

// Event kinds — one per gadget source family.
enum EventKind : uint32_t {
  EV_EXEC = 1,
  EV_EXIT = 2,
  EV_OPEN = 3,
  EV_TCP_CONNECT = 4,
  EV_TCP_ACCEPT = 5,
  EV_TCP_CLOSE = 6,
  EV_DNS = 7,
  EV_BIND = 8,
  EV_SIGNAL = 9,
  EV_MOUNT = 10,
  EV_OOMKILL = 11,
  EV_CAPABILITY = 12,
  EV_FSSLOWER = 13,
  EV_FILE_RW = 14,
  EV_BLOCK_IO = 15,
  EV_SNI = 16,
  EV_NET_GRAPH = 17,
  EV_SYSCALL = 18,  // traceloop/seccomp-style raw syscall stream
  EV_PERF_SAMPLE = 19,  // CPU sampling profiler hit (profile/cpu)
  EV_CONTAINER = 20,    // container lifecycle from the runc fanotify watch
  EV_TCP_BYTES = 21,    // per-connection interval byte deltas (top/tcp)
  EV_AUDIT = 22,        // kernel audit record (host-wide capability/seccomp)
};

// 64-byte POD slot; layout is the ring-buffer ABI shared with Python.
struct Event {
  uint64_t ts_ns;     // capture timestamp
  uint64_t key_hash;  // FNV-1a64 of the primary string key (comm/qname/path)
  uint64_t aux1;      // per-kind: saddr<<32|daddr, bytes, latency_ns, ...
  uint64_t aux2;      // per-kind: sport<<16|dport, flags, ret, signal, ...
  uint64_t mntns;     // mount-namespace id (container filter key)
  uint32_t pid;
  uint32_t ppid;
  uint32_t uid;
  uint32_t kind;      // EventKind
  char comm[8];       // key-string prefix (display fast-path; vocab has full)
};
static_assert(sizeof(Event) == 64, "Event must stay one cache line");

inline uint64_t fnv1a64(const char* s, size_t n) {
  uint64_t h = 0xCBF29CE484222325ull;
  for (size_t i = 0; i < n; i++) {
    h ^= (unsigned char)s[i];
    h *= 0x100000001B3ull;
  }
  return h;
}

}  // namespace ig
