// Tracefs-backed capture sources — block per-IO, host-wide fsslower, and
// the cap_capable tracepoint.
//
// Each source owns a PRIVATE tracing instance (instances/<name>: isolated
// ring buffers + event enables, never disturbs global tracing), reads its
// trace_pipe, and surfaces per-cpu ring overruns as drops. The shared
// lifecycle lives in TracefsInstanceSource; concrete sources supply the
// events to enable (with optional in-kernel filters) and a line parser.
//
// This file is included AFTER ptrace_source.cc (see api.cc) on purpose:
// FsTraceSource reuses its kSyscallNames (arch-native syscall numbers)
// and kSpecs fs_op classification so the per-target ptrace flavour and
// the host-wide tracepoint flavour can never disagree about which
// syscalls are fs ops.

#ifdef __linux__
#include <dirent.h>
#include <fcntl.h>
#include <poll.h>
#include <sys/stat.h>
#include <unistd.h>

#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include "ringbuf.h"

namespace ig {

// ---------------------------------------------------------------------------
// TracefsInstanceSource — shared private-instance lifecycle.
// ---------------------------------------------------------------------------

class TracefsInstanceSource : public Source {
 public:
  TracefsInstanceSource(size_t ring_pow2, const char* name_prefix,
                        const std::string& root = "")
      : Source(ring_pow2), root_(root) {
    if (root_.empty()) root_ = tracefs_root();
    static std::atomic<int> seq{0};
    char inst[64];
    snprintf(inst, sizeof(inst), "%s_%d_%d", name_prefix, (int)getpid(),
             seq.fetch_add(1));
    instance_ = inst;
  }
  ~TracefsInstanceSource() override { teardown_instance(); }

  // A usable tracefs needs WRITE access (instance creation + event
  // enables), not just readable event dirs — /sys is commonly mounted
  // read-only in containers and a read-only root must not be reported
  // as a working window.
  static bool root_usable(const std::string& root) {
    if (root.empty()) return false;
    return access((root + "/instances").c_str(), W_OK) == 0;
  }

 protected:
  // subclass contract -------------------------------------------------------
  // relative "events/..." paths to enable, with optional in-kernel filter
  struct EventEnable {
    std::string event;   // e.g. "events/block/block_rq_issue"
    std::string filter;  // "" = none
  };
  virtual std::vector<EventEnable> events() = 0;
  virtual void parse_line(const char* line, size_t len) = 0;
  // bound for per-source in-flight tables; called when the pipe drains
  virtual void prune() {}

  void run() override {
    if (root_.empty()) return;
    std::string inst = root_ + "/instances/" + instance_;
    mkdir(inst.c_str(), 0700);
    if (access(inst.c_str(), R_OK) != 0) return;
    made_instance_ = true;
    for (const EventEnable& e : events()) {
      if (!e.filter.empty() &&
          !write_file(inst + "/" + e.event + "/filter", e.filter.c_str()))
        return;
      if (!write_file(inst + "/" + e.event + "/enable", "1")) return;
      // recorded for teardown: the destructor must not dispatch to the
      // (already-destroyed) derived class's virtual events()
      enabled_events_.push_back(e.event);
    }
    int fd = open((inst + "/trace_pipe").c_str(),
                  O_RDONLY | O_NONBLOCK | O_CLOEXEC);
    if (fd < 0) return;
    struct pollfd pfd{fd, POLLIN, 0};
    std::string carry;
    uint64_t last_overrun_check = 0;
    while (running_.load(std::memory_order_relaxed)) {
      if (poll(&pfd, 1, 100) <= 0) continue;
      char buf[16384];
      ssize_t n = read(fd, buf, sizeof(buf));
      if (n <= 0) continue;
      carry.append(buf, (size_t)n);
      size_t pos = 0, nl;
      while ((nl = carry.find('\n', pos)) != std::string::npos) {
        parse_line(carry.data() + pos, nl - pos);
        pos = nl + 1;
      }
      carry.erase(0, pos);
      prune();
      uint64_t now = now_ns();
      if (now - last_overrun_check > 1000000000ull) {
        last_overrun_check = now;
        account_overruns(inst);
      }
    }
    close(fd);
  }

  // shared helpers ----------------------------------------------------------

  // leading "comm-pid" field of a trace_pipe line; runs up to the " [cpu]"
  // column, NOT the first space — comms may contain spaces. Returns pid
  // (0 on parse failure) and fills comm.
  static uint32_t parse_task(const std::string& s, std::string& comm) {
    size_t ns_ = s.find_first_not_of(' ');
    size_t br = s.find(" [", ns_);
    if (ns_ == std::string::npos || br == std::string::npos || br <= ns_)
      return 0;
    std::string task = s.substr(ns_, br - ns_);
    while (!task.empty() && task.back() == ' ') task.pop_back();
    size_t dash = task.rfind('-');
    if (dash == std::string::npos) return 0;
    comm = task.substr(0, dash);
    return (uint32_t)atoi(task.c_str() + dash + 1);
  }

  // "12345.678901:" timestamp token directly before the event name
  static double parse_ts(const std::string& s, size_t event_pos) {
    if (event_pos < 2) return 0.0;
    size_t ts_start = s.rfind(' ', event_pos - 2);
    if (ts_start == std::string::npos) return 0.0;
    return atof(s.c_str() + ts_start + 1);
  }

  void fill_task_identity(Event& ev, const std::string& comm) {
    if (!comm.empty()) {
      size_t c = comm.size() < sizeof(ev.comm) - 1 ? comm.size()
                                                   : sizeof(ev.comm) - 1;
      memcpy(ev.comm, comm.data(), c);
      if (ev.key_hash == 0) {
        ev.key_hash = fnv1a64(comm.data(), comm.size());
        vocab_.put(ev.key_hash, comm.data(), comm.size());
      }
    }
    if (ev.pid) {
      char path[64], link[64];
      snprintf(path, sizeof(path), "/proc/%u/ns/mnt", ev.pid);
      ssize_t ln = readlink(path, link, sizeof(link) - 1);
      if (ln > 0) {
        link[ln] = 0;
        const char* lb = strchr(link, '[');
        if (lb) ev.mntns = strtoull(lb + 1, nullptr, 10);
      }
    }
  }

  static bool write_file(const std::string& path, const char* val) {
    int fd = open(path.c_str(), O_WRONLY | O_CLOEXEC);
    if (fd < 0) return false;
    ssize_t n = write(fd, val, strlen(val));
    close(fd);
    return n > 0;
  }

  std::string root_;

 private:
  // per_cpu/*/stats "overrun: N" — events the ftrace ring discarded before
  // we read them; folded into the source's drop counter so loss stays
  // auditable end-to-end (ring_stress contract)
  void account_overruns(const std::string& inst) {
    uint64_t total = 0;
    DIR* d = opendir((inst + "/per_cpu").c_str());
    if (!d) return;
    struct dirent* de;
    while ((de = readdir(d))) {
      if (strncmp(de->d_name, "cpu", 3) != 0) continue;
      std::string sp = inst + "/per_cpu/" + de->d_name + "/stats";
      FILE* f = fopen(sp.c_str(), "r");
      if (!f) continue;
      char line[128];
      while (fgets(line, sizeof(line), f)) {
        unsigned long long v;
        if (sscanf(line, "overrun: %llu", &v) == 1) total += v;
      }
      fclose(f);
    }
    closedir(d);
    if (total > overrun_seen_) {
      ring_.count_external_drops(total - overrun_seen_);
      overrun_seen_ = total;
    }
  }

  void teardown_instance() {
    if (!made_instance_ || root_.empty()) return;
    std::string inst = root_ + "/instances/" + instance_;
    for (const std::string& e : enabled_events_)
      write_file(inst + "/" + e + "/enable", "0");
    rmdir(inst.c_str());  // removing the instance frees its buffers
  }

  std::string instance_;
  bool made_instance_ = false;
  uint64_t overrun_seen_ = 0;
  std::vector<std::string> enabled_events_;
};

// ---------------------------------------------------------------------------
// BlkTraceSource — profile/block-io via tracefs block events, PER-IO.
//
// The reference's biolatency.bpf.c (1-156) kprobes rq issue→complete and
// histograms each request's latency in-kernel. trace_pipe lines carry
// (dev, sector, rwbs, bytes) on issue and completion, so each IO's
// latency is the timestamp delta of its (dev,sector) pair. Events:
//   key_hash  dev "maj,min" (vocab)   aux1  latency_us
//   aux2      bytes<<8 | is_write     pid/comm  issuing task
// ---------------------------------------------------------------------------

class BlkTraceSource : public TracefsInstanceSource {
 public:
  BlkTraceSource(size_t ring_pow2, const std::string& cfg)
      : TracefsInstanceSource(ring_pow2, "igtpu_blk",
                              cfg_get(cfg, "tracefs", "")) {}
  ~BlkTraceSource() override { stop(); }

  static bool supported() {
    std::string root = tracefs_root();
    return root_usable(root) &&
           access((root + "/events/block").c_str(), R_OK) == 0;
  }

 protected:
  std::vector<EventEnable> events() override {
    return {{"events/block/block_rq_issue", ""},
            {"events/block/block_rq_complete", ""}};
  }

  void prune() override {
    // IOs whose completion we never see (requeues, remaps) must not leak
    if (inflight_.size() > 65536) inflight_.clear();
  }

  void parse_line(const char* line, size_t len) override {
    std::string s(line, len);
    // "  comm-pid  [cpu] flags ts.usec: block_rq_issue: maj,min RWBS bytes
    //  () sector + len [comm]"   (complete: no bytes field)
    size_t m_issue = s.find("block_rq_issue: ");
    size_t m_done = s.find("block_rq_complete: ");
    if (m_issue == std::string::npos && m_done == std::string::npos) return;
    double ts = parse_ts(
        s, m_issue != std::string::npos ? m_issue : m_done);
    if (m_issue != std::string::npos) {
      char dev[16] = "", rwbs[8] = "";
      unsigned long long bytes = 0, sector = 0;
      if (sscanf(s.c_str() + m_issue + 16, "%15s %7s %llu () %llu",
                 dev, rwbs, &bytes, &sector) != 4)
        return;
      Pending p{};
      p.ts = ts;
      p.bytes = bytes;
      p.is_write = strchr(rwbs, 'W') != nullptr;
      std::string comm;
      p.pid = parse_task(s, comm);
      size_t cn = comm.size() < sizeof(p.comm) - 1 ? comm.size()
                                                   : sizeof(p.comm) - 1;
      memcpy(p.comm, comm.data(), cn);
      p.comm[cn] = 0;
      inflight_[key(dev, sector)] = p;
    } else {
      char dev[16] = "";
      unsigned long long sector = 0;
      if (sscanf(s.c_str() + m_done + 19, "%15s %*s () %llu",
                 dev, &sector) != 2)
        return;
      auto it = inflight_.find(key(dev, sector));
      if (it == inflight_.end()) return;
      const Pending& p = it->second;
      double lat_us = (ts - p.ts) * 1e6;
      if (lat_us >= 0) {
        Event ev{};
        ev.ts_ns = now_ns();
        ev.kind = EV_BLOCK_IO;
        ev.aux1 = (uint64_t)lat_us;
        ev.aux2 = (p.bytes << 8) | (p.is_write ? 1 : 0);
        ev.pid = p.pid;
        size_t dn = strlen(dev);
        ev.key_hash = fnv1a64(dev, dn);
        vocab_.put(ev.key_hash, dev, dn);
        size_t cn = strlen(p.comm);
        memcpy(ev.comm, p.comm,
               cn < sizeof(ev.comm) - 1 ? cn : sizeof(ev.comm) - 1);
        emit(ev);
      }
      inflight_.erase(it);
    }
  }

 private:
  struct Pending {
    double ts;
    uint64_t bytes;
    uint32_t pid;
    char comm[16];
    bool is_write;
  };

  static std::string key(const char* dev, unsigned long long sector) {
    char k[48];
    snprintf(k, sizeof(k), "%s:%llu", dev, sector);
    return k;
  }

  std::unordered_map<std::string, Pending> inflight_;
};

// ---------------------------------------------------------------------------
// FsTraceSource — trace/fsslower HOST-WIDE via filtered raw_syscalls.
//
// The reference's fsslower.bpf.c (1-239) kprobes per-fs read/write/open/
// fsync entry+exit and reports ops slower than a threshold, system-wide.
// Here: events/raw_syscalls/{sys_enter,sys_exit} with an IN-KERNEL id
// filter (only fs syscalls reach the ring), entry/exit paired per
// (pid, nr):
//   sys_enter: NR 0 (fd_hex, buf, count, ...)     sys_exit: NR 0 = 4096
// Ops >= min_lat_us emit EV_FSSLOWER with
//   aux1 latency_us    aux2 op<<32 | bytes (ret of read/write)
//   key_hash           file path via /proc/<pid>/fd/<fd>, resolved only
//                      for the slow ops that get reported (cheap)
// The syscall set and op classes come from ptrace_source.cc's kSpecs
// (fs_op column) — one source of truth for both fsslower flavours.
// ---------------------------------------------------------------------------

class FsTraceSource : public TracefsInstanceSource {
 public:
  FsTraceSource(size_t ring_pow2, const std::string& cfg)
      : TracefsInstanceSource(ring_pow2, "igtpu_fs") {
    min_lat_us_ = strtoull(cfg_get(cfg, "min_lat_us", "10000").c_str(),
                           nullptr, 10);
    // arch-native nr → fs-op class, from the ptrace window's tables
    for (const SyscallName* s = kSyscallNames; s->name; s++) {
      for (const SysSpec* sp = kSpecs; sp->name; sp++) {
        if (strcmp(sp->name, s->name) == 0) {
          if (sp->fs_op > 0) op_by_nr_[s->nr] = sp->fs_op;
          break;
        }
      }
    }
  }
  ~FsTraceSource() override { stop(); }

  static bool supported() {
    std::string root = tracefs_root();
    return root_usable(root) &&
           access((root + "/events/raw_syscalls/sys_enter").c_str(),
                  R_OK) == 0;
  }

 protected:
  std::vector<EventEnable> events() override {
    std::string filter;
    for (auto& [nr, _op] : op_by_nr_) {
      if (!filter.empty()) filter += "||";
      filter += "id==" + std::to_string(nr);
    }
    return {{"events/raw_syscalls/sys_enter", filter},
            {"events/raw_syscalls/sys_exit", filter}};
  }

  void prune() override {
    if (inflight_.size() > 65536) inflight_.clear();
  }

  void parse_line(const char* line, size_t len) override {
    std::string s(line, len);
    size_t m_in = s.find("sys_enter: NR ");
    size_t m_out = s.find("sys_exit: NR ");
    if (m_in == std::string::npos && m_out == std::string::npos) return;
    std::string comm;
    uint32_t pid = parse_task(s, comm);
    if (!pid) return;
    double ts = parse_ts(s, m_in != std::string::npos ? m_in : m_out);
    if (m_in != std::string::npos) {
      long nr = 0;
      unsigned long long a0 = 0;
      if (sscanf(s.c_str() + m_in + 14, "%ld (%llx", &nr, &a0) < 1) return;
      if (!op_by_nr_.count((int)nr)) return;
      inflight_[((uint64_t)pid << 16) | (uint64_t)(nr & 0xFFFF)] =
          Pending{ts, a0};
    } else {
      long nr = 0;
      long long ret = 0;
      if (sscanf(s.c_str() + m_out + 13, "%ld = %lld", &nr, &ret) != 2)
        return;
      auto op_it = op_by_nr_.find((int)nr);
      if (op_it == op_by_nr_.end()) return;
      auto key = ((uint64_t)pid << 16) | (uint64_t)(nr & 0xFFFF);
      auto it = inflight_.find(key);
      if (it == inflight_.end()) return;
      double lat_us = (ts - it->second.ts) * 1e6;
      uint64_t fdnum = it->second.fd;
      inflight_.erase(it);
      if (lat_us < (double)min_lat_us_) return;
      Event ev{};
      ev.ts_ns = now_ns();
      ev.kind = EV_FSSLOWER;
      ev.pid = pid;
      ev.aux1 = (uint64_t)lat_us;
      uint64_t bytes =
          (op_it->second == 1 || op_it->second == 2) && ret > 0
              ? (uint64_t)ret : 0;
      ev.aux2 = ((uint64_t)op_it->second << 32) | (bytes & 0xFFFFFFFF);
      // only reported (slow) ops pay the fd→path resolve
      if (op_it->second != 3 && fdnum < 65536) {
        char link[64], path[512];
        snprintf(link, sizeof(link), "/proc/%u/fd/%llu", pid,
                 (unsigned long long)fdnum);
        ssize_t pn = readlink(link, path, sizeof(path) - 1);
        if (pn > 0) {
          ev.key_hash = fnv1a64(path, (size_t)pn);
          vocab_.put(ev.key_hash, path, (size_t)pn);
        }
      }
      fill_task_identity(ev, comm);
      emit(ev);
    }
  }

 private:
  struct Pending {
    double ts;
    uint64_t fd;
  };

  uint64_t min_lat_us_;
  std::unordered_map<int, int> op_by_nr_;
  std::unordered_map<uint64_t, Pending> inflight_;
};

// ---------------------------------------------------------------------------
// CapTraceSource — trace/capabilities via the cap_capable TRACEPOINT.
//
// The reference kprobes cap_capable (capable.bpf.c:1-250) to see every
// capability check on the host with its verdict. Kernels >= 6.7 expose
// the same function as a real tracepoint (events/capability/cap_capable
// with cap + ret fields) — the exact mechanism, no BPF:
//   comm-pid [cpu] flags ts: cap_capable: cred .., target_ns ..,
//   capable_ns .., cap 21, ret 0
// This window sees ALLOWS and DENIES system-wide, strictly stronger than
// the audit EPERM-rule flavour (denial-only). Events:
//   kind EV_CAPABILITY   aux1 = 1 allow / 0 deny   aux2 = capability nr
// ---------------------------------------------------------------------------

class CapTraceSource : public TracefsInstanceSource {
 public:
  CapTraceSource(size_t ring_pow2, const std::string& cfg)
      : TracefsInstanceSource(ring_pow2, "igtpu_cap") {
    (void)cfg;
  }
  ~CapTraceSource() override { stop(); }

  static bool supported() {
    std::string root = tracefs_root();
    return root_usable(root) &&
           access((root + "/events/capability/cap_capable").c_str(),
                  R_OK) == 0;
  }

 protected:
  std::vector<EventEnable> events() override {
    return {{"events/capability/cap_capable", ""}};
  }

  void parse_line(const char* line, size_t len) override {
    std::string s(line, len);
    size_t m = s.find("cap_capable: ");
    if (m == std::string::npos) return;
    int cap = -1, ret = 0;
    size_t cp = s.find("cap ", m);
    if (cp == std::string::npos ||
        sscanf(s.c_str() + cp, "cap %d, ret %d", &cap, &ret) != 2 || cap < 0)
      return;
    Event ev{};
    ev.ts_ns = now_ns();
    ev.kind = EV_CAPABILITY;
    ev.aux1 = ret == 0 ? 1 : 0;  // allow : deny (ret is -EPERM on denial)
    ev.aux2 = (uint64_t)cap;
    std::string comm;
    ev.pid = parse_task(s, comm);
    fill_task_identity(ev, comm);
    emit(ev);
  }
};

// ---------------------------------------------------------------------------
// SockStateSource — trace/tcp via the inet_sock_set_state TRACEPOINT.
//
// The reference kprobes tcp_v4/v6_connect, inet_csk_accept and tcp_close
// (tcptracer.bpf.c:1-375). The tracepoint window sees every TCP state
// transition host-wide, event-driven — no scan window, so short-lived
// connections can't slip between polls like the /proc/net diff scanner's:
//   inet_sock_set_state: family=AF_INET protocol=IPPROTO_TCP sport=N
//   dport=M saddr=a.b.c.d daddr=e.f.g.h ... oldstate=X newstate=Y
// Transition → event mapping (with honest pid attribution — state
// changes fire in softirq/timer context where the line's task is
// whatever got interrupted):
//   CLOSE→SYN_SENT          task context IS the connecting process; the
//                           tuple lacks sport, so identity is parked and
//                           EV_TCP_CONNECT emits on SYN_SENT→ESTABLISHED
//                           with the full tuple
//   SYN_RECV→ESTABLISHED    EV_TCP_ACCEPT; softirq context — identity is
//                           the LISTENER, resolved via the port→pid map
//   ESTABLISHED→FIN_WAIT1 / CLOSE_WAIT→LAST_ACK
//                           EV_TCP_CLOSE; both fire inside the closing
//                           process's close() — task context is right
// Event encoding matches the /proc scanner so the gadget decodes both:
//   aux1 = saddr_le<<32 | daddr_le     aux2 = sport<<16 | dport
// ---------------------------------------------------------------------------

class SockStateSource : public TracefsInstanceSource {
 public:
  SockStateSource(size_t ring_pow2, const std::string& cfg)
      : TracefsInstanceSource(ring_pow2, "igtpu_ss") {
    (void)cfg;
  }
  ~SockStateSource() override { stop(); }

  static bool supported() {
    std::string root = tracefs_root();
    return root_usable(root) &&
           access((root + "/events/sock/inet_sock_set_state").c_str(),
                  R_OK) == 0;
  }

 protected:
  std::vector<EventEnable> events() override {
    enricher_.refresh();  // listener map ready before the first accept
    last_refresh_ = now_ns();
    // TCP only; BOTH address families (the /proc fallback scans tcp6 too)
    return {{"events/sock/inet_sock_set_state", "protocol==6"}};
  }

  void prune() override {
    if (pending_connect_.size() > 16384) pending_connect_.clear();
    uint64_t now = now_ns();
    if (now - last_refresh_ > 500000000ull) {
      last_refresh_ = now;
      enricher_.refresh();
    }
  }

  void parse_line(const char* line, size_t len) override {
    std::string s(line, len);
    size_t m = s.find("inet_sock_set_state: ");
    if (m == std::string::npos) return;
    unsigned sport = 0, dport = 0;
    char fam[12] = "", saddr[48] = "", daddr[48] = "";
    char olds[20] = "", news[20] = "";
    const char* p = s.c_str() + m;
    if (sscanf(p, "inet_sock_set_state: family=%11s protocol=IPPROTO_TCP"
                  " sport=%u dport=%u saddr=%47s daddr=%47s",
               fam, &sport, &dport, saddr, daddr) != 5)
      return;
    bool v6 = strcmp(fam, "AF_INET6") == 0;
    if (v6) {
      // the dotted fields are mapped-v4 for v6 sockets; use the real ones
      size_t s6 = s.find("saddrv6=", m), d6 = s.find("daddrv6=", m);
      if (s6 == std::string::npos || d6 == std::string::npos) return;
      sscanf(s.c_str() + s6, "saddrv6=%47s", saddr);
      sscanf(s.c_str() + d6, "daddrv6=%47s", daddr);
    }
    size_t os_ = s.find("oldstate=", m);
    size_t ns2 = s.find("newstate=", m);
    if (os_ == std::string::npos || ns2 == std::string::npos) return;
    sscanf(s.c_str() + os_, "oldstate=%19s", olds);
    sscanf(s.c_str() + ns2, "newstate=%19s", news);
    std::string comm;
    uint32_t task_pid = parse_task(s, comm);
    uint32_t sa = v6 ? 0 : ip4_le(saddr), da = v6 ? 0 : ip4_le(daddr);
    uint64_t v6key = v6 ? put_v6(saddr, daddr) : 0;

    if (!strcmp(olds, "TCP_CLOSE") && !strcmp(news, "TCP_SYN_SENT")) {
      // Park the connecting task's identity; tuple completes on
      // ESTABLISHED. sport is 0 here, so concurrent connects to the same
      // target share a key — a collision from a DIFFERENT task makes the
      // slot ambiguous (pid 0 beats blaming the wrong process), and the
      // ambiguity must outlive the FIRST establishment (a refcount, not a
      // flag): with it erased early, a third connect re-parking would be
      // blamed for the second's connection.
      uint64_t key = conn_key(saddr, daddr, dport);
      auto it = pending_connect_.find(key);
      if (it == pending_connect_.end()) {
        pending_connect_[key] = {task_pid, comm, 1};
      } else {
        it->second.count++;
        if (it->second.pid != task_pid) it->second = {0, "", it->second.count};
      }
      return;
    }
    if (!strcmp(olds, "TCP_SYN_SENT")) {
      // honest attribution only: a miss means the parked identity is gone
      // (table pruned) — the line's task here is softirq-interrupted and
      // must NOT be blamed
      auto it = pending_connect_.find(conn_key(saddr, daddr, dport));
      uint32_t pid = 0;
      std::string who;
      if (it != pending_connect_.end()) {
        pid = it->second.pid;
        who = it->second.comm;
        if (--it->second.count <= 0) pending_connect_.erase(it);
      }
      if (strcmp(news, "TCP_ESTABLISHED") != 0) return;  // refused/reset
      push(EV_TCP_CONNECT, pid, who, sa, da, sport, dport, v6, v6key);
      return;
    }
    if (!strcmp(olds, "TCP_SYN_RECV") && !strcmp(news, "TCP_ESTABLISHED")) {
      uint32_t pid = 0;
      char owner[32] = "";
      bool hit = lookup_port_owner(sport, &pid, owner, sizeof(owner));
      push(EV_TCP_ACCEPT, hit ? pid : 0, hit ? owner : "", sa, da, sport,
           dport, v6, v6key);
      return;
    }
    // Closes. ESTABLISHED→FIN_WAIT1 and CLOSE_WAIT→LAST_ACK fire inside
    // the closing process's close() — task context is right. A direct
    // →TCP_CLOSE from a live state is an abort (RST received, SO_LINGER-0
    // close, tcp_abort), possibly in softirq — attribute via the port→pid
    // map instead of blaming the interrupted task.
    bool task_close =
        (!strcmp(olds, "TCP_ESTABLISHED") && !strcmp(news, "TCP_FIN_WAIT1"))
        || (!strcmp(olds, "TCP_CLOSE_WAIT") && !strcmp(news, "TCP_LAST_ACK"));
    bool abort_close =
        !strcmp(news, "TCP_CLOSE")
        && (!strcmp(olds, "TCP_ESTABLISHED")
            || !strcmp(olds, "TCP_CLOSE_WAIT"));
    if (task_close) {
      push(EV_TCP_CLOSE, task_pid, comm, sa, da, sport, dport, v6, v6key);
    } else if (abort_close) {
      uint32_t pid = 0;
      char owner[32] = "";
      bool hit = lookup_port_owner(sport, &pid, owner, sizeof(owner));
      push(EV_TCP_CLOSE, hit ? pid : 0, hit ? owner : "", sa, da, sport,
           dport, v6, v6key);
    }
  }

 private:
  struct PendingConnect {
    uint32_t pid;
    std::string comm;
    int count;  // concurrent connects sharing this key (sport is 0)
  };

  // keyed on the ADDRESS STRINGS (works for both families; sport is 0 at
  // SYN_SENT so it can't participate)
  static uint64_t conn_key(const char* saddr, const char* daddr,
                           unsigned dport) {
    uint64_t h = fnv1a64(saddr, strlen(saddr));
    h ^= fnv1a64(daddr, strlen(daddr)) * 0x100000001B3ull;
    return h ^ dport;
  }

  // dotted quad → the little-endian u32 the /proc scanner emits (the
  // gadget's decoder unpacks with "<I")
  static uint32_t ip4_le(const char* dotted) {
    unsigned a = 0, b = 0, c = 0, d = 0;
    if (sscanf(dotted, "%u.%u.%u.%u", &a, &b, &c, &d) != 4) return 0;
    return a | (b << 8) | (c << 16) | (d << 24);
  }

  // v6 address pair → vocab payload "saddr6\x1fdaddr6" keyed by hash
  uint64_t put_v6(const char* saddr, const char* daddr) {
    std::string payload = std::string(saddr) + '\x1f' + daddr;
    uint64_t h = fnv1a64(payload.data(), payload.size());
    vocab_.put(h, payload.data(), payload.size());
    return h;
  }

  // port → owning process, with a rate-limited refresh on miss (a miss
  // usually means the socket is younger than the last /proc scan)
  bool lookup_port_owner(unsigned port, uint32_t* pid, char* owner,
                         size_t cap) {
    bool hit = enricher_.lookup((uint16_t)port, pid, owner, cap);
    if (!hit) {
      uint64_t now = now_ns();
      if (now - last_refresh_ > 200000000ull) {
        last_refresh_ = now;
        enricher_.refresh();
        hit = enricher_.lookup((uint16_t)port, pid, owner, cap);
      }
    }
    return hit;
  }

  void push(uint32_t kind, uint32_t pid, const std::string& comm,
            uint32_t sa, uint32_t da, unsigned sport, unsigned dport,
            bool v6, uint64_t v6key) {
    Event ev{};
    ev.ts_ns = now_ns();
    ev.kind = kind;
    ev.pid = pid;
    ev.aux1 = v6 ? v6key : (((uint64_t)sa << 32) | da);
    ev.aux2 = ((uint64_t)(sport & 0xFFFF) << 16) | (dport & 0xFFFF);
    // ipversion flag for the decoder — bit 48, clear of the /proc
    // fallback's state field (sources.cc packs state<<32, values <= 12)
    if (v6) ev.aux2 |= 1ull << 48;
    fill_task_identity(ev, comm);
    emit(ev);
  }

  SocketEnricher enricher_;
  uint64_t last_refresh_ = 0;
  std::unordered_map<uint64_t, PendingConnect> pending_connect_;
};

// ---------------------------------------------------------------------------
// SignalTraceSource — trace/signal via the signal_generate TRACEPOINT.
//
// The reference's sigsnoop.bpf.c (1-175) hooks the signal_generate
// tracepoint; this is the same hook, host-wide, covering every signal —
// not just the fatal ones the netlink-exit window derives:
//   sig=9 errno=0 code=0 comm=target pid=123 grp=1 res=0
// The line's task is the SENDER; the record's comm/pid are the TARGET.
// Encoding matches the gadget: aux1=2 (sent), aux2=sig, pid=sender,
// ppid=target pid.
// ---------------------------------------------------------------------------

class SignalTraceSource : public TracefsInstanceSource {
 public:
  SignalTraceSource(size_t ring_pow2, const std::string& cfg)
      : TracefsInstanceSource(ring_pow2, "igtpu_sig") {
    (void)cfg;
  }
  ~SignalTraceSource() override { stop(); }

  static bool supported() {
    std::string root = tracefs_root();
    return root_usable(root) &&
           access((root + "/events/signal/signal_generate").c_str(),
                  R_OK) == 0;
  }

 protected:
  std::vector<EventEnable> events() override {
    return {{"events/signal/signal_generate", ""}};
  }

  void parse_line(const char* line, size_t len) override {
    std::string s(line, len);
    size_t m = s.find("signal_generate: ");
    if (m == std::string::npos) return;
    int sig = 0, res = 0;
    unsigned tpid = 0;
    if (sscanf(s.c_str() + m, "signal_generate: sig=%d", &sig) != 1)
      return;
    size_t pp = s.find(" pid=", m);
    if (pp != std::string::npos) sscanf(s.c_str() + pp, " pid=%u", &tpid);
    size_t rp = s.find(" res=", m);
    if (rp != std::string::npos) sscanf(s.c_str() + rp, " res=%d", &res);
    if (sig <= 0) return;
    std::string comm;
    uint32_t sender = parse_task(s, comm);
    Event ev{};
    ev.ts_ns = now_ns();
    ev.kind = EV_SIGNAL;
    ev.pid = sender;
    ev.ppid = tpid;  // target (the gadget's TPID column)
    ev.aux1 = 2;     // sent
    ev.aux2 = (uint64_t)(sig & 0x7F);
    fill_task_identity(ev, comm);
    emit(ev);
  }
};

}  // namespace ig
#endif  // __linux__
