// PerfCpuSampler — a real sampling CPU profiler via perf_event_open.
//
// Reference contract: profile/cpu attaches a perf-event sampler at 49 Hz
// with a BPF program pushing stacks into a stack map, then symbolizes
// kernel frames from /proc/kallsyms in userspace
// (pkg/gadgets/profile/cpu/tracer/tracer.go:57-58,139-200,293-402,
// profile.bpf.c:1-116). Here the same perf_event_open window is used
// directly: software CPU-clock events per CPU, PERF_SAMPLE_CALLCHAIN for
// stacks, mmap ring buffers drained by the capture thread, kernel frames
// symbolized from kallsyms, user frames attributed to their mapping via
// /proc/<pid>/maps. One EV_PERF_SAMPLE per hit; the vocab payload is the
// folded stack ("comm;frameN;...;frame0") the flamegraph output consumes.

#ifdef __linux__
#include <fcntl.h>
#include <linux/perf_event.h>
#include <poll.h>
#include <sys/ioctl.h>
#include <sys/mman.h>
#include <sys/syscall.h>
#include <unistd.h>

#include <algorithm>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include "ringbuf.h"

namespace ig {

class KallsymsTable {
 public:
  void load() {
    FILE* f = fopen("/proc/kallsyms", "r");
    if (!f) return;
    char line[512];
    while (fgets(line, sizeof(line), f)) {
      unsigned long long addr;
      char type;
      char name[256];
      if (sscanf(line, "%llx %c %255s", &addr, &type, name) != 3) continue;
      if (addr == 0) continue;
      syms_.push_back({addr, name});
    }
    fclose(f);
    std::sort(syms_.begin(), syms_.end(),
              [](const Sym& a, const Sym& b) { return a.addr < b.addr; });
  }

  const char* resolve(uint64_t ip) const {
    if (syms_.empty()) return nullptr;
    // last symbol with addr <= ip
    size_t lo = 0, hi = syms_.size();
    while (lo < hi) {
      size_t mid = (lo + hi) / 2;
      if (syms_[mid].addr <= ip)
        lo = mid + 1;
      else
        hi = mid;
    }
    if (lo == 0) return nullptr;
    return syms_[lo - 1].name.c_str();
  }

  bool empty() const { return syms_.empty(); }

 private:
  struct Sym {
    uint64_t addr;
    std::string name;
  };
  std::vector<Sym> syms_;
};

class PerfCpuSampler : public Source {
 public:
  PerfCpuSampler(size_t ring_pow2, const std::string& cfg) : Source(ring_pow2) {
    freq_ = atoi(cfg_get(cfg, "freq", "49").c_str());
    if (freq_ <= 0) freq_ = 49;
    target_pid_ = atoi(cfg_get(cfg, "pid", "0").c_str());
    user_only_ = cfg_get(cfg, "user", "0") == "1";
    kernel_only_ = cfg_get(cfg, "kernel", "0") == "1";
  }
  ~PerfCpuSampler() override { stop(); }

  static bool supported() {
    struct perf_event_attr pe {};
    pe.type = PERF_TYPE_SOFTWARE;
    pe.size = sizeof(pe);
    pe.config = PERF_COUNT_SW_CPU_CLOCK;
    pe.disabled = 1;
    int fd = (int)syscall(SYS_perf_event_open, &pe, 0, -1, -1, 0);
    if (fd < 0) return false;
    close(fd);
    return true;
  }

 protected:
  static constexpr size_t kPages = 16;  // data pages per CPU (ref: 64/tracer)

  struct CpuBuf {
    int fd = -1;
    void* base = nullptr;
    size_t map_len = 0;
    uint64_t tail = 0;
  };

  void run() override {
    kallsyms_.load();
    int ncpu = (int)sysconf(_SC_NPROCESSORS_ONLN);
    if (ncpu <= 0) ncpu = 1;
    long page = sysconf(_SC_PAGESIZE);
    std::vector<CpuBuf> bufs;
    std::vector<struct pollfd> pfds;
    for (int cpu = 0; cpu < ncpu; cpu++) {
      struct perf_event_attr pe {};
      pe.type = PERF_TYPE_SOFTWARE;
      pe.size = sizeof(pe);
      pe.config = PERF_COUNT_SW_CPU_CLOCK;
      pe.freq = 1;
      pe.sample_freq = (uint64_t)freq_;
      pe.sample_type = PERF_SAMPLE_IP | PERF_SAMPLE_TID | PERF_SAMPLE_TIME |
                       PERF_SAMPLE_CPU | PERF_SAMPLE_CALLCHAIN;
      pe.disabled = 1;
      pe.exclude_kernel = user_only_ ? 1 : 0;
      pe.exclude_user = kernel_only_ ? 1 : 0;
      pe.wakeup_events = 1;
      int fd = (int)syscall(SYS_perf_event_open, &pe,
                            target_pid_ > 0 ? target_pid_ : -1, cpu, -1,
                            PERF_FLAG_FD_CLOEXEC);
      if (fd < 0) continue;
      size_t len = (size_t)page * (1 + kPages);
      void* base = mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
      if (base == MAP_FAILED) {
        close(fd);
        continue;
      }
      ioctl(fd, PERF_EVENT_IOC_ENABLE, 0);
      bufs.push_back(CpuBuf{fd, base, len, 0});
      pfds.push_back({fd, POLLIN, 0});
    }
    if (bufs.empty()) return;
    while (running_.load(std::memory_order_relaxed)) {
      poll(pfds.data(), (nfds_t)pfds.size(), 50);
      for (auto& b : bufs) drain(b, (size_t)page);
    }
    for (auto& b : bufs) {
      ioctl(b.fd, PERF_EVENT_IOC_DISABLE, 0);
      munmap(b.base, b.map_len);
      close(b.fd);
    }
  }

 private:
  void drain(CpuBuf& b, size_t page) {
    auto* meta = (struct perf_event_mmap_page*)b.base;
    uint64_t head = __atomic_load_n(&meta->data_head, __ATOMIC_ACQUIRE);
    uint64_t tail = b.tail;
    char* data = (char*)b.base + page;
    size_t mask = page * kPages - 1;
    while (tail < head) {
      auto* hdr = (struct perf_event_header*)(data + (tail & mask));
      // copy out (records can wrap the ring edge)
      std::vector<char> rec(hdr->size);
      for (size_t i = 0; i < hdr->size; i++)
        rec[i] = data[(tail + i) & mask];
      auto* rh = (struct perf_event_header*)rec.data();
      if (rh->type == PERF_RECORD_SAMPLE) parse_sample(rec.data(), rec.size());
      if (rh->type == PERF_RECORD_LOST) {
        // struct { header; u64 id; u64 lost; }
        if (rec.size() >= sizeof(*rh) + 16)
          ring_.count_external_drops(*(uint64_t*)(rec.data() + sizeof(*rh) + 8));
      }
      tail += hdr->size;
    }
    b.tail = tail;
    __atomic_store_n(&meta->data_tail, tail, __ATOMIC_RELEASE);
  }

  void parse_sample(const char* rec, size_t len) {
    // layout per sample_type order: IP, TID(pid,tid), TIME, CPU(cpu,res),
    // CALLCHAIN(nr, ips[])
    const char* p = rec + sizeof(struct perf_event_header);
    const char* end = rec + len;
    if (p + 8 * 4 + 8 > end) return;
    uint64_t ip = *(const uint64_t*)p; p += 8;
    uint32_t pid = *(const uint32_t*)p; p += 4;
    uint32_t tid = *(const uint32_t*)p; p += 4;
    uint64_t t = *(const uint64_t*)p; p += 8;
    uint32_t cpu = *(const uint32_t*)p; p += 8;  // cpu + res
    uint64_t nr = *(const uint64_t*)p; p += 8;
    if (p + nr * 8 > end) nr = (uint64_t)(end - p) / 8;

    Event ev{};
    ev.ts_ns = t;
    ev.kind = EV_PERF_SAMPLE;
    ev.pid = pid;
    ev.ppid = tid;
    ev.aux1 = ip;
    ev.aux2 = cpu;
    fill_proc_identity(ev, vocab_, pid);
    std::string comm = ev.key_hash ? vocab_lookup_comm(ev) : "unknown";

    // fold root-first: comm;outermost;...;leaf (reference folded format,
    // tracer.go collectResult), skipping perf context markers
    std::vector<std::string> frames;
    frames.reserve(nr);
    for (uint64_t i = 0; i < nr; i++) {
      uint64_t a = ((const uint64_t*)p)[i];
      if (a >= (uint64_t)PERF_CONTEXT_MAX) continue;  // context marker
      if (a >= 0xffff000000000000ull) {
        const char* s = kallsyms_.resolve(a);
        frames.emplace_back(s ? s : "[k]?");
      } else {
        frames.push_back(user_frame(pid, a));
      }
    }
    std::string folded = comm;
    for (auto it = frames.rbegin(); it != frames.rend(); ++it) {
      folded += ';';
      folded += *it;
    }
    ev.key_hash = fnv1a64(folded.data(), folded.size());
    vocab_.put(ev.key_hash, folded.data(), folded.size());
    emit(ev);
  }

  std::string vocab_lookup_comm(const Event& ev) {
    char buf[64];
    size_t n = vocab_.get(ev.key_hash, buf, sizeof(buf));
    return std::string(buf, n);
  }

  // Attribute a user-space address to its mapping ("module+0xoff"),
  // with a per-pid cache of /proc/<pid>/maps. On a miss the maps are
  // reloaded once (exec/dlopen invalidates old ranges); the cache is
  // bounded so system-wide sampling over many pids cannot grow unbounded.
  std::string user_frame(uint32_t pid, uint64_t addr) {
    if (maps_cache_.size() > 256) maps_cache_.clear();
    auto& maps = maps_cache_[pid];
    for (int attempt = 0; attempt < 2; attempt++) {
      if (maps.empty() || attempt == 1) {
        maps.clear();
        load_maps(pid, maps);
      }
      for (const auto& m : maps) {
        if (addr >= m.lo && addr < m.hi) {
          char buf[320];
          snprintf(buf, sizeof(buf), "%s+0x%llx", m.name.c_str(),
                   (unsigned long long)(addr - m.lo));
          return buf;
        }
      }
    }
    char buf[32];
    snprintf(buf, sizeof(buf), "[u]0x%llx", (unsigned long long)addr);
    return buf;
  }

  struct MapEnt {
    uint64_t lo, hi;
    std::string name;
  };

  void load_maps(uint32_t pid, std::vector<MapEnt>& out) {
    char path[64];
    snprintf(path, sizeof(path), "/proc/%u/maps", pid);
    FILE* f = fopen(path, "r");
    if (!f) return;
    char line[512];
    while (fgets(line, sizeof(line), f)) {
      unsigned long long lo, hi;
      char perms[8], name[256] = "";
      if (sscanf(line, "%llx-%llx %7s %*s %*s %*s %255s", &lo, &hi, perms,
                 name) < 3)
        continue;
      if (perms[2] != 'x') continue;  // executable mappings only
      const char* base = strrchr(name, '/');
      out.push_back(MapEnt{lo, hi, base ? base + 1 : (name[0] ? name : "anon")});
    }
    fclose(f);
  }

  int freq_;
  int target_pid_;
  bool user_only_ = false;
  bool kernel_only_ = false;
  KallsymsTable kallsyms_;
  std::unordered_map<uint32_t, std::vector<MapEnt>> maps_cache_;
};

}  // namespace ig
#endif  // __linux__
