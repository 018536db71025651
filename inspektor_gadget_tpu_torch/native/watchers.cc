// Real kernel-event watchers for the syscall-family trace gadgets.
//
// The reference implements these as eBPF programs; this build observes the
// same kernel facts through the non-BPF windows the kernel offers:
//  - FanotifyOpenSource  → trace/open   (ref: pkg/gadgets/trace/open/tracer/
//    bpf/opensnoop.bpf.c:1-163, openat tracepoints). fanotify mount marks
//    with FAN_OPEN|FAN_MODIFY deliver an fd whose /proc/self/fd link is the
//    opened path; pid identity comes with the event metadata.
//  - MountInfoSource     → trace/mount  (ref: mountsnoop.bpf.c:1-168).
//    /proc/self/mountinfo is pollable (POLLERR|POLLPRI on change); diffing
//    by mount id yields real mount/umount events with source/target/fstype.
//  - SockDiagBindSource  → trace/bind   (ref: bindsnoop.bpf.c:1-152).
//    NETLINK_SOCK_DIAG dumps of listening TCP + bound UDP sockets, diffed
//    by inode; pid resolved by a targeted /proc/*/fd socket-inode scan.
//  - KmsgOomSource       → trace/oomkill (ref: oomkill.bpf.c:1-51, kprobe
//    oom_kill_process). The OOM killer logs structured lines to the kernel
//    ring; /dev/kmsg streams them with no polling loss.
//
// All sources emit through Source::emit() so the capture-side mntns filter
// and filtered-event accounting apply uniformly.

#ifdef __linux__
#include <fcntl.h>
#include <poll.h>
#include <sched.h>
#include <sys/fanotify.h>
#include <sys/mount.h>
#include <sys/stat.h>
#include <unistd.h>

#include <mutex>

#include <dirent.h>
#include <linux/inet_diag.h>
#include <linux/netlink.h>
#include <linux/rtnetlink.h>
#include <linux/sock_diag.h>
#include <linux/tcp.h>
#include <netinet/in.h>
#include <sys/socket.h>

#include <cstring>
#include <map>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "ringbuf.h"

namespace ig {

// "key=value\x1fkey=value" config-string access (the string-configured
// source analogue of the reference's RewriteConstants at BPF load time).
inline std::string cfg_get(const std::string& cfg, const char* key,
                           const char* dflt = "") {
  std::string needle = std::string(key) + "=";
  size_t pos = 0;
  while (pos < cfg.size()) {
    size_t end = cfg.find('\x1f', pos);
    if (end == std::string::npos) end = cfg.size();
    if (cfg.compare(pos, needle.size(), needle) == 0)
      return cfg.substr(pos + needle.size(), end - pos - needle.size());
    pos = end + 1;
  }
  return dflt;
}

inline std::vector<std::string> split_str(const std::string& s, char sep) {
  std::vector<std::string> out;
  size_t pos = 0;
  while (pos <= s.size()) {
    size_t end = s.find(sep, pos);
    if (end == std::string::npos) end = s.size();
    if (end > pos) out.push_back(s.substr(pos, end - pos));
    pos = end + 1;
  }
  return out;
}

// ---------------------------------------------------------------------------
// FanotifyOpenSource — trace/open via fanotify mount marks.
// ---------------------------------------------------------------------------

// mountinfo octal-escapes spaces/tabs/backslashes in path fields
inline std::string mountinfo_unescape(const std::string& s) {
  if (s.find('\\') == std::string::npos) return s;
  std::string out;
  out.reserve(s.size());
  for (size_t i = 0; i < s.size();) {
    if (s[i] == '\\' && i + 3 < s.size() && s[i + 1] >= '0' &&
        s[i + 1] <= '7' && s[i + 2] >= '0' && s[i + 2] <= '7' &&
        s[i + 3] >= '0' && s[i + 3] <= '7') {
      out.push_back((char)(((s[i + 1] - '0') << 6) | ((s[i + 2] - '0') << 3) |
                           (s[i + 3] - '0')));
      i += 4;
    } else {
      out.push_back(s[i++]);
    }
  }
  return out;
}

// One mountinfo parser for every consumer (the remark loop and
// MountInfoSource::scan must never disagree on escaping/fields).
struct MountInfoEnt {
  unsigned long id;
  std::string target, source, fstype;
};

// Read fd from offset 0 and parse every line (target/source unescaped).
// Returns false when nothing could be read — the watched pid is gone.
inline bool read_mountinfo(int fd, std::vector<MountInfoEnt>& out) {
  if (lseek(fd, 0, SEEK_SET) != 0) return false;
  std::string content;
  char buf[8192];
  ssize_t n;
  while ((n = read(fd, buf, sizeof(buf))) > 0) content.append(buf, (size_t)n);
  if (content.empty()) return false;
  // line: "36 35 98:0 /root /mnt rw,noatime master:1 - ext3 /dev/sda rw"
  for (const auto& line : split_str(content, '\n')) {
    size_t dash = line.find(" - ");
    if (dash == std::string::npos) continue;
    char root[256], target[256], fstype[64], source[256];
    unsigned long id = 0, parent = 0;
    if (sscanf(line.c_str(), "%lu %lu %*s %255s %255s", &id, &parent, root,
               target) != 4)
      continue;
    if (sscanf(line.c_str() + dash + 3, "%63s %255s", fstype, source) != 2)
      continue;
    out.push_back({id, mountinfo_unescape(target), mountinfo_unescape(source),
                   fstype});
  }
  return true;
}

// kernel pseudo-filesystems: no value marking them (mirror of the Python
// attach-time skip list, source_gadget.py _FANOTIFY_SKIP_FSTYPES)
inline bool fanotify_skip_fstype(const std::string& t) {
  static const std::unordered_set<std::string> kSkip = {
      "proc",       "sysfs",   "devpts", "devtmpfs", "cgroup",
      "cgroup2",    "securityfs", "debugfs", "tracefs", "mqueue",
      "bpf",        "fusectl", "configfs", "pstore",  "efivarfs"};
  return kSkip.count(t) != 0;
}

class FanotifyOpenSource : public Source {
 public:
  FanotifyOpenSource(size_t ring_pow2, const std::string& cfg)
      : Source(ring_pow2) {
    // list values arrive \x1e-separated (make_cfg's list contract) since
    // ':' is legal inside mount points; the user-facing CLI colon syntax
    // stays supported when no \x1e is present
    std::string raw = cfg_get(cfg, "paths", "/");
    paths_ = split_str(raw, raw.find('\x1e') != std::string::npos ? '\x1e'
                                                                  : ':');
    if (paths_.empty()) paths_ = {"/"};
    include_modify_ = cfg_get(cfg, "modify", "1") != "0";
    // live re-mark: watch this pid's mountinfo and mark mounts created
    // AFTER attach (closes the snapshot gap vs the reference's kprobes,
    // opensnoop.bpf.c full-coverage semantics)
    remark_pid_ = atoi(cfg_get(cfg, "remark_pid", "0").c_str());
  }
  ~FanotifyOpenSource() override { stop(); }

 protected:
  // Re-mark every markable mount in the watched pid's mount ns. Marks
  // are re-added idempotently each pass (FAN_MARK_ADD on a marked mount
  // merges masks, no duplicate events): a mount REPLACED at the same
  // target between polls gets a fresh mark instead of being skipped, and
  // dead mounts stop counting against the budget (their marks die with
  // the mount). Returns false when the target pid is gone.
  bool remark(int fan, uint64_t mask, int mi_fd, const std::string& root) {
    std::vector<MountInfoEnt> ents;
    if (!read_mountinfo(mi_fd, ents)) return false;  // pid exited
    size_t live = 0;
    for (const auto& e : ents) {
      if (e.target.empty() || e.target == "/") continue;
      if (fanotify_skip_fstype(e.fstype)) continue;
      if (live >= kMaxMarks) {
        if (!marks_capped_) {
          marks_capped_ = true;
          fprintf(stderr,
                  "ig: fanotify remark budget (%zu) exceeded for pid %d — "
                  "later mounts are NOT watched\n",
                  kMaxMarks, remark_pid_);
        }
        break;
      }
      std::string full = root + e.target;
      if (fanotify_mark(fan, FAN_MARK_ADD | FAN_MARK_MOUNT, mask, AT_FDCWD,
                        full.c_str()) == 0)
        live++;
    }
    return true;
  }

  void run() override {
    int fan = fanotify_init(FAN_CLASS_NOTIF | FAN_NONBLOCK,
                            O_RDONLY | O_LARGEFILE | O_CLOEXEC);
    if (fan < 0) return;
    uint64_t mask = FAN_OPEN;
    if (include_modify_) mask |= FAN_MODIFY;
    bool any = false;
    std::unordered_set<std::string> marked;
    for (const auto& p : paths_) {
      if (fanotify_mark(fan, FAN_MARK_ADD | FAN_MARK_MOUNT, mask, AT_FDCWD,
                        p.c_str()) == 0) {
        any = true;
        marked.insert(p);
      }
    }
    if (!any) {
      close(fan);
      return;
    }
    int mi_fd = -1;
    std::string root;
    if (remark_pid_ > 0) {
      char mp[64];
      snprintf(mp, sizeof(mp), "/proc/%d/mountinfo", remark_pid_);
      mi_fd = open(mp, O_RDONLY | O_CLOEXEC);
      snprintf(mp, sizeof(mp), "/proc/%d/root", remark_pid_);
      root = mp;
      // initial sweep: the poll baseline is set at open(), so a mount
      // created between the Python attach-time snapshot and this open
      // would otherwise never fire POLLPRI and never get marked
      if (mi_fd >= 0 && !remark(fan, mask, mi_fd, root)) {
        close(mi_fd);
        mi_fd = -1;
      }
    }
    const uint32_t self = (uint32_t)getpid();
    char buf[8192];
    struct pollfd pfds[2] = {{fan, POLLIN, 0},
                             {mi_fd, POLLERR | POLLPRI, 0}};
    while (running_.load(std::memory_order_relaxed)) {
      nfds_t nf = mi_fd >= 0 ? 2 : 1;
      if (poll(pfds, nf, 100) <= 0) continue;
      if (nf == 2 && (pfds[1].revents & (POLLERR | POLLPRI))) {
        if (!remark(fan, mask, mi_fd, root)) {
          close(mi_fd);
          mi_fd = -1;  // target gone; keep serving existing marks
        }
      }
      if (!(pfds[0].revents & POLLIN)) continue;
      ssize_t len = read(fan, buf, sizeof(buf));
      if (len <= 0) continue;
      auto* md = (struct fanotify_event_metadata*)buf;
      while (FAN_EVENT_OK(md, len)) {
        // Skip our own accesses (the identity fill below reads /proc, which
        // is a different mount, but the event fd close and any library IO
        // on a marked mount would feed back otherwise).
        if ((uint32_t)md->pid != self &&
            (md->mask & (FAN_OPEN | FAN_MODIFY))) {
          Event ev{};
          ev.ts_ns = now_ns();
          ev.kind = EV_OPEN;
          ev.pid = (uint32_t)md->pid;
          // aux2: bit0 = open, bit1 = modify (write) — the flags analogue
          ev.aux2 = ((md->mask & FAN_OPEN) ? 1u : 0u) |
                    ((md->mask & FAN_MODIFY) ? 2u : 0u);
          if (md->fd >= 0) {
            char fdp[64], path[512];
            snprintf(fdp, sizeof(fdp), "/proc/self/fd/%d", md->fd);
            ssize_t n = readlink(fdp, path, sizeof(path) - 1);
            if (n > 0) {
              ev.aux1 = fnv1a64(path, (size_t)n);
              vocab_.put(ev.aux1, path, (size_t)n);
            }
          }
          fill_proc_identity(ev, vocab_, ev.pid);
          emit(ev);
        }
        if (md->fd >= 0) close(md->fd);
        md = FAN_EVENT_NEXT(md, len);
      }
    }
    if (mi_fd >= 0) close(mi_fd);
    close(fan);
  }

 private:
  static constexpr size_t kMaxMarks = 64;
  std::vector<std::string> paths_;
  bool include_modify_ = true;
  int remark_pid_ = 0;
  bool marks_capped_ = false;
};

// ---------------------------------------------------------------------------
// MountInfoSource — trace/mount via pollable /proc/self/mountinfo diffs.
// ---------------------------------------------------------------------------

class MountInfoSource : public Source {
 public:
  MountInfoSource(size_t ring_pow2, const std::string& cfg = "")
      : Source(ring_pow2) {
    // a container's private mount ns is invisible in the host mountinfo;
    // the per-container attach passes its pid and we poll THAT process's
    // view (/proc/<pid>/mountinfo is pollable exactly like self's)
    pid_ = atoi(cfg_get(cfg, "pid", "0").c_str());
  }
  ~MountInfoSource() override { stop(); }

 protected:
  struct MountEnt {
    std::string target, source, fstype;
  };

  void run() override {
    char path[64];
    if (pid_ > 0)
      snprintf(path, sizeof(path), "/proc/%d/mountinfo", pid_);
    else
      snprintf(path, sizeof(path), "/proc/self/mountinfo");
    int fd = open(path, O_RDONLY);
    if (fd < 0) return;
    std::map<uint64_t, MountEnt> known;
    scan(fd, known);  // baseline: no events for pre-existing mounts
    struct pollfd pfd{fd, POLLERR | POLLPRI, 0};
    while (running_.load(std::memory_order_relaxed)) {
      int r = poll(&pfd, 1, 200);
      if (r <= 0) continue;
      std::map<uint64_t, MountEnt> cur;
      scan(fd, cur);
      // An EMPTY scan means the window died, not that every mount went
      // away: a per-container poller whose pid exited reads nothing (the
      // mount ns may live on in sibling containers) — ending quietly
      // beats emitting a spurious umount flood. A real mount ns always
      // has at least the root mount.
      if (cur.empty()) break;
      uint64_t ts = now_ns();
      for (auto& [id, m] : cur)
        if (!known.count(id)) push_mount(ts, m, /*umount=*/false);
      for (auto& [id, m] : known)
        if (!cur.count(id)) push_mount(ts, m, /*umount=*/true);
      known.swap(cur);
    }
    close(fd);
  }

 private:
  void push_mount(uint64_t ts, const MountEnt& m, bool umount) {
    Event ev{};
    ev.ts_ns = ts;
    ev.kind = EV_MOUNT;
    ev.aux2 = umount ? 1 : 0;
    // vocab payload: source \x1f target \x1f fstype (Python splits)
    std::string payload = m.source + '\x1f' + m.target + '\x1f' + m.fstype;
    ev.key_hash = fnv1a64(payload.data(), payload.size());
    vocab_.put(ev.key_hash, payload.data(), payload.size());
    size_t c = m.target.size() < sizeof(ev.comm) - 1 ? m.target.size()
                                                     : sizeof(ev.comm) - 1;
    memcpy(ev.comm, m.target.data(), c);
    emit(ev);
  }

  void scan(int fd, std::map<uint64_t, MountEnt>& out) {
    // shared parser (read_mountinfo) so every mountinfo consumer agrees
    // on fields + octal escaping
    std::vector<MountInfoEnt> ents;
    if (!read_mountinfo(fd, ents)) return;
    for (auto& e : ents) out[e.id] = MountEnt{e.target, e.source, e.fstype};
  }

  int pid_ = 0;
};

// One /proc pass resolving socket inodes to owning pids (shared by the
// sock_diag sources; the reference gets pid identity in-kernel from the
// calling task, a luxury the netlink window lacks).
inline void resolve_socket_inodes(const std::vector<uint64_t>& inodes,
                                  std::unordered_map<uint64_t, uint32_t>& owner) {
  std::unordered_set<uint64_t> want(inodes.begin(), inodes.end());
  DIR* proc = opendir("/proc");
  if (!proc) return;
  struct dirent* de;
  while ((de = readdir(proc)) && !want.empty()) {
    char* end;
    unsigned long pid = strtoul(de->d_name, &end, 10);
    if (*end || !pid) continue;
    char fdpath[64];
    snprintf(fdpath, sizeof(fdpath), "/proc/%lu/fd", pid);
    DIR* fds = opendir(fdpath);
    if (!fds) continue;
    struct dirent* fd;
    while ((fd = readdir(fds))) {
      char link[384], target[64];
      snprintf(link, sizeof(link), "%s/%s", fdpath, fd->d_name);
      ssize_t n = readlink(link, target, sizeof(target) - 1);
      if (n <= 9 || strncmp(target, "socket:[", 8) != 0) continue;
      target[n] = 0;
      uint64_t inode = strtoull(target + 8, nullptr, 10);
      if (want.count(inode)) {
        owner[inode] = (uint32_t)pid;
        want.erase(inode);
      }
    }
    closedir(fds);
  }
  closedir(proc);
}

// ---------------------------------------------------------------------------
// SockDiagBindSource — trace/bind via NETLINK_SOCK_DIAG dumps.
// ---------------------------------------------------------------------------

class SockDiagBindSource : public Source {
 public:
  SockDiagBindSource(size_t ring_pow2, const std::string& cfg)
      : Source(ring_pow2) {
    interval_ms_ = atoi(cfg_get(cfg, "interval_ms", "50").c_str());
    if (interval_ms_ <= 0) interval_ms_ = 50;
  }
  ~SockDiagBindSource() override { stop(); }

 protected:
  struct SockEnt {
    uint8_t family, proto;
    uint16_t port;      // host order
    uint64_t addr;      // v4: host-order u32; v6: first 8 bytes
    char addr_str[48];
  };

  void run() override {
    std::unordered_map<uint64_t, SockEnt> known;  // inode -> socket
    bool first = true;
    while (running_.load(std::memory_order_relaxed)) {
      std::unordered_map<uint64_t, SockEnt> cur;
      for (uint8_t fam : {AF_INET, AF_INET6}) {
        dump(fam, IPPROTO_TCP, 1u << 10 /*TCP_LISTEN*/, cur);
        dump(fam, IPPROTO_UDP, 0xffffffff, cur);
      }
      // Kernels without udp_diag return an empty dump; procfs covers UDP.
      scan_proc_udp("/proc/net/udp", AF_INET, cur);
      scan_proc_udp("/proc/net/udp6", AF_INET6, cur);
      if (!first) {
        std::vector<uint64_t> fresh;
        for (auto& [inode, s] : cur)
          if (!known.count(inode)) fresh.push_back(inode);
        if (!fresh.empty()) {
          // one targeted /proc pass resolves pids for all new binds
          std::unordered_map<uint64_t, uint32_t> owner;
          resolve_inodes(fresh, owner);
          uint64_t ts = now_ns();
          for (uint64_t inode : fresh) {
            const SockEnt& s = cur[inode];
            Event ev{};
            ev.ts_ns = ts;
            ev.kind = EV_BIND;
            ev.aux1 = s.addr;
            ev.aux2 = ((uint64_t)(s.family == AF_INET6 ? 1 : 0) << 24 |
                       (uint64_t)s.proto << 16 | s.port);
            auto it = owner.find(inode);
            if (it != owner.end()) {
              ev.pid = it->second;
              fill_proc_identity(ev, vocab_, ev.pid);
            }
            // aux-key: "addr:port" for display/sketch
            char key[64];
            int kn = snprintf(key, sizeof(key), "%s:%u", s.addr_str, s.port);
            uint64_t kh = fnv1a64(key, (size_t)kn);
            vocab_.put(kh, key, (size_t)kn);
            if (ev.key_hash == 0) ev.key_hash = kh;
            ev.aux1 = kh;  // addr string hash (addr itself derivable)
            emit(ev);
          }
        }
      }
      known.swap(cur);
      first = false;
      std::this_thread::sleep_for(std::chrono::milliseconds(interval_ms_));
    }
  }

 private:
  void dump(uint8_t family, uint8_t proto, uint32_t states,
            std::unordered_map<uint64_t, SockEnt>& out) {
    int sd = socket(AF_NETLINK, SOCK_RAW | SOCK_CLOEXEC, NETLINK_SOCK_DIAG);
    if (sd < 0) return;
    struct {
      struct nlmsghdr nlh;
      struct inet_diag_req_v2 req;
    } r{};
    r.nlh.nlmsg_len = sizeof(r);
    r.nlh.nlmsg_type = SOCK_DIAG_BY_FAMILY;
    r.nlh.nlmsg_flags = NLM_F_REQUEST | NLM_F_DUMP;
    r.req.sdiag_family = family;
    r.req.sdiag_protocol = proto;
    r.req.idiag_states = states;
    if (send(sd, &r, sizeof(r), 0) < 0) {
      close(sd);
      return;
    }
    char buf[32768];
    bool done = false;
    while (!done) {
      ssize_t len = recv(sd, buf, sizeof(buf), 0);
      if (len <= 0) break;
      for (struct nlmsghdr* h = (struct nlmsghdr*)buf; NLMSG_OK(h, (size_t)len);
           h = NLMSG_NEXT(h, len)) {
        if (h->nlmsg_type == NLMSG_DONE || h->nlmsg_type == NLMSG_ERROR) {
          done = true;
          break;
        }
        auto* msg = (struct inet_diag_msg*)NLMSG_DATA(h);
        SockEnt s{};
        s.family = family;
        s.proto = proto;
        s.port = ntohs(msg->id.idiag_sport);
        if (family == AF_INET) {
          uint32_t a = ntohl(msg->id.idiag_src[0]);
          s.addr = a;
          snprintf(s.addr_str, sizeof(s.addr_str), "%u.%u.%u.%u", a >> 24,
                   (a >> 16) & 0xff, (a >> 8) & 0xff, a & 0xff);
        } else {
          memcpy(&s.addr, msg->id.idiag_src, 8);
          snprintf(s.addr_str, sizeof(s.addr_str), "[%08x:%08x:%08x:%08x]",
                   ntohl(msg->id.idiag_src[0]), ntohl(msg->id.idiag_src[1]),
                   ntohl(msg->id.idiag_src[2]), ntohl(msg->id.idiag_src[3]));
        }
        out[(uint64_t)msg->idiag_inode] = s;
      }
    }
    close(sd);
  }

  void scan_proc_udp(const char* path, uint8_t family,
                     std::unordered_map<uint64_t, SockEnt>& out) {
    FILE* f = fopen(path, "r");
    if (!f) return;
    char line[512];
    if (!fgets(line, sizeof(line), f)) {  // header
      fclose(f);
      return;
    }
    while (fgets(line, sizeof(line), f)) {
      char local[128];
      unsigned long long inode = 0;
      if (sscanf(line, " %*u: %127s %*s %*x %*s %*s %*s %*u %*u %llu", local,
                 &inode) < 2 || !inode)
        continue;
      char* colon = strrchr(local, ':');
      if (!colon) continue;
      SockEnt s{};
      s.family = family;
      s.proto = IPPROTO_UDP;
      s.port = (uint16_t)strtoul(colon + 1, nullptr, 16);
      if (family == AF_INET) {
        uint32_t a = (uint32_t)strtoul(local, nullptr, 16);  // little-endian
        a = __builtin_bswap32(a);
        s.addr = a;
        snprintf(s.addr_str, sizeof(s.addr_str), "%u.%u.%u.%u", a >> 24,
                 (a >> 16) & 0xff, (a >> 8) & 0xff, a & 0xff);
      } else {
        snprintf(s.addr_str, sizeof(s.addr_str), "[%.32s]", local);
      }
      out[inode] = s;
    }
    fclose(f);
  }

  void resolve_inodes(const std::vector<uint64_t>& inodes,
                      std::unordered_map<uint64_t, uint32_t>& owner) {
    resolve_socket_inodes(inodes, owner);
  }

  int interval_ms_;
};

// ---------------------------------------------------------------------------
// TcpBytesSource — top/tcp via sock_diag INET_DIAG_INFO byte counters.
//
// The reference's tcptop.bpf.c (1-133) kprobes tcp_sendmsg/tcp_cleanup_rbuf
// and sums bytes per connection in a BPF map drained each interval
// (tracer.go:222-314). The kernel exports the same per-socket totals with
// no probes: sock_diag with ext INET_DIAG_INFO returns struct tcp_info per
// socket, whose tcpi_bytes_acked (RFC4898 tcpEStatsAppHCThruOctetsAcked ≈
// bytes sent and acked) and tcpi_bytes_received are cumulative since
// connection start (kernel >= 4.1). Dumping every interval and diffing per
// socket inode yields real SENT/RECV deltas per connection. Events:
//   key_hash  "saddr:sport->daddr:dport" (vocab)   kind EV_TCP_BYTES
//   aux1 sent-bytes delta     aux2 recv-bytes delta
//   pid/comm/mntns  socket owner, resolved once per socket via /proc
// Sockets that existed before the first dump contribute deltas only (their
// pre-existing totals are the baseline); sockets born later contribute
// everything — i.e. bytes are counted "since gadget start", the reference's
// semantics. Two limits vs the kprobe window, both documented to users:
// a connection opening AND closing within one poll tick is never seen, and
// the dump is scoped to this process's network namespace (kprobes are
// system-wide) — containers with private netns need the per-netns path.
// ---------------------------------------------------------------------------

class TcpBytesSource : public Source {
 public:
  TcpBytesSource(size_t ring_pow2, const std::string& cfg)
      : Source(ring_pow2) {
    interval_ms_ = atoi(cfg_get(cfg, "interval_ms", "500").c_str());
    if (interval_ms_ <= 0) interval_ms_ = 500;
    // The sock_diag dump is netns-scoped; a container with a private
    // netns needs its own source whose capture THREAD enters that netns
    // (setns is per-thread, the rawsock/netnsenter contract) before
    // dumping — the per-container Attacher path passes the init pid here.
    netns_pid_ = atoi(cfg_get(cfg, "netns_pid", "0").c_str());
  }
  ~TcpBytesSource() override { stop(); }

  // The window exists only when a dumped socket actually carries the byte
  // counters: a dump can answer fine on kernels whose tcp_info is shorter
  // than tcpi_bytes_received (< 4.1), and then the source would emit
  // nothing forever while claiming to be real. A loopback listen socket
  // guarantees at least one dumpable socket to length-check even on an
  // otherwise idle host.
  static bool supported() {
    int probe = socket(AF_INET, SOCK_STREAM | SOCK_CLOEXEC, 0);
    if (probe >= 0) {
      struct sockaddr_in a{};
      a.sin_family = AF_INET;
      a.sin_addr.s_addr = htonl(0x7f000001);
      if (bind(probe, (struct sockaddr*)&a, sizeof(a)) != 0 ||
          listen(probe, 1) != 0) {
        close(probe);
        probe = -1;
      }
    }
    int sd = socket(AF_NETLINK, SOCK_RAW | SOCK_CLOEXEC, NETLINK_SOCK_DIAG);
    if (sd < 0) {
      if (probe >= 0) close(probe);
      return false;
    }
    struct {
      struct nlmsghdr nlh;
      struct inet_diag_req_v2 req;
    } r{};
    r.nlh.nlmsg_len = sizeof(r);
    r.nlh.nlmsg_type = SOCK_DIAG_BY_FAMILY;
    r.nlh.nlmsg_flags = NLM_F_REQUEST | NLM_F_DUMP;
    r.req.sdiag_family = AF_INET;
    r.req.sdiag_protocol = IPPROTO_TCP;
    r.req.idiag_states = 0xffffffff;
    r.req.idiag_ext = 1u << (INET_DIAG_INFO - 1);
    bool ok = false;
    if (send(sd, &r, sizeof(r), 0) == (ssize_t)sizeof(r)) {
      char buf[65536];
      bool done = false;
      while (!done) {
        ssize_t len = recv(sd, buf, sizeof(buf), 0);
        if (len <= 0) break;
        for (struct nlmsghdr* h = (struct nlmsghdr*)buf;
             NLMSG_OK(h, (size_t)len); h = NLMSG_NEXT(h, len)) {
          if (h->nlmsg_type == NLMSG_DONE || h->nlmsg_type == NLMSG_ERROR) {
            done = true;
            break;
          }
          auto* msg = (struct inet_diag_msg*)NLMSG_DATA(h);
          int rem = (int)(h->nlmsg_len - NLMSG_LENGTH(sizeof(*msg)));
          auto* rta =
              (struct rtattr*)((char*)msg + NLMSG_ALIGN(sizeof(*msg)));
          for (; RTA_OK(rta, rem); rta = RTA_NEXT(rta, rem)) {
            if (rta->rta_type == INET_DIAG_INFO &&
                RTA_PAYLOAD(rta) >=
                    offsetof(struct tcp_info, tcpi_bytes_received) +
                        sizeof(uint64_t))
              ok = true;
          }
        }
      }
    }
    close(sd);
    if (probe >= 0) close(probe);
    return ok;
  }

 protected:
  struct ConnState {
    uint64_t acked = 0, received = 0;
    uint64_t conn_hash = 0;
    uint32_t pid = 0;
    uint8_t family = 0;
    bool seen = false;  // present in the current scan
  };

  void run() override {
    if (netns_pid_ > 0) {
      char path[64];
      snprintf(path, sizeof(path), "/proc/%d/ns/net", netns_pid_);
      int nfd = open(path, O_RDONLY | O_CLOEXEC);
      if (nfd < 0) {
        // distinguishable in agent logs: EPERM is a capability problem,
        // ENOENT means the container is simply gone
        fprintf(stderr, "igcapture: tcp-bytes netns open %s failed: %s\n",
                path, strerror(errno));
        return;
      }
      int rc = setns(nfd, CLONE_NEWNET);
      close(nfd);
      if (rc != 0) {
        fprintf(stderr,
                "igcapture: tcp-bytes setns(pid %d) failed: %s "
                "(needs CAP_SYS_ADMIN)\n", netns_pid_, strerror(errno));
        return;
      }
    }
    bool first = true;
    while (running_.load(std::memory_order_relaxed)) {
      for (auto& [inode, c] : conns_) c.seen = false;
      std::vector<uint64_t> fresh;
      bool v4_ok = dump_family(AF_INET, first, fresh);
      bool v6_ok = dump_family(AF_INET6, first, fresh);
      if (!fresh.empty()) {
        std::unordered_map<uint64_t, uint32_t> owner;
        resolve_socket_inodes(fresh, owner);
        for (uint64_t ino : fresh) {
          auto it = owner.find(ino);
          if (it != owner.end()) conns_[ino].pid = it->second;
        }
        // newborn sockets' whole history belongs to this window: emit it
        // now that the pid is known (deltas were parked in pending_)
        for (auto& [ino, delta] : pending_) {
          auto ct = conns_.find(ino);
          if (ct != conns_.end())
            push(ct->second, delta.first, delta.second);
        }
      }
      pending_.clear();
      // Closed sockets disappear from the dump; drop their state — but
      // only for families whose dump ran to NLMSG_DONE. A transiently
      // failed dump (fd exhaustion, ENOBUFS) must keep state: erasing
      // would make every live connection look newborn next tick and
      // re-emit its whole cumulative history as one interval's delta.
      // Per-family so a host whose v6 dump always errors still reaps v4.
      for (auto it = conns_.begin(); it != conns_.end();) {
        bool dumped = it->second.family == AF_INET6 ? v6_ok : v4_ok;
        it = (!it->second.seen && dumped) ? conns_.erase(it) : std::next(it);
      }
      first = false;
      int waited = 0;
      while (waited < interval_ms_ &&
             running_.load(std::memory_order_relaxed)) {
        std::this_thread::sleep_for(std::chrono::milliseconds(20));
        waited += 20;
      }
    }
  }

 private:
  // Returns true only when the dump ran to NLMSG_DONE (a partial or failed
  // dump must not be mistaken for "those sockets closed").
  bool dump_family(uint8_t family, bool first, std::vector<uint64_t>& fresh) {
    int sd = socket(AF_NETLINK, SOCK_RAW | SOCK_CLOEXEC, NETLINK_SOCK_DIAG);
    if (sd < 0) return false;
    struct {
      struct nlmsghdr nlh;
      struct inet_diag_req_v2 req;
    } r{};
    r.nlh.nlmsg_len = sizeof(r);
    r.nlh.nlmsg_type = SOCK_DIAG_BY_FAMILY;
    r.nlh.nlmsg_flags = NLM_F_REQUEST | NLM_F_DUMP;
    r.req.sdiag_family = family;
    r.req.sdiag_protocol = IPPROTO_TCP;
    r.req.idiag_states = 0xffffffff;  // every state; LISTEN skipped in parse
    r.req.idiag_ext = 1u << (INET_DIAG_INFO - 1);
    if (send(sd, &r, sizeof(r), 0) < 0) {
      close(sd);
      return false;
    }
    char buf[65536];
    bool done = false, clean = false;
    while (!done) {
      ssize_t len = recv(sd, buf, sizeof(buf), 0);
      if (len <= 0) break;
      for (struct nlmsghdr* h = (struct nlmsghdr*)buf; NLMSG_OK(h, (size_t)len);
           h = NLMSG_NEXT(h, len)) {
        if (h->nlmsg_type == NLMSG_DONE || h->nlmsg_type == NLMSG_ERROR) {
          done = true;
          clean = h->nlmsg_type == NLMSG_DONE;
          break;
        }
        parse_sock(h, family, first, fresh);
      }
    }
    close(sd);
    return clean;
  }

  void parse_sock(struct nlmsghdr* h, uint8_t family, bool first,
                  std::vector<uint64_t>& fresh) {
    auto* msg = (struct inet_diag_msg*)NLMSG_DATA(h);
    if (msg->idiag_state == 10 /*TCP_LISTEN*/ || msg->idiag_inode == 0)
      return;
    // walk the attribute list for INET_DIAG_INFO (struct tcp_info; may be
    // truncated on old kernels — require the byte counters to be present)
    int rem = (int)(h->nlmsg_len - NLMSG_LENGTH(sizeof(*msg)));
    auto* rta = (struct rtattr*)((char*)msg + NLMSG_ALIGN(sizeof(*msg)));
    const struct tcp_info* ti = nullptr;
    for (; RTA_OK(rta, rem); rta = RTA_NEXT(rta, rem)) {
      if (rta->rta_type == INET_DIAG_INFO &&
          RTA_PAYLOAD(rta) >= offsetof(struct tcp_info, tcpi_bytes_received) +
                                  sizeof(uint64_t)) {
        ti = (const struct tcp_info*)RTA_DATA(rta);
        break;
      }
    }
    if (!ti) return;
    uint64_t inode = msg->idiag_inode;
    auto it = conns_.find(inode);
    if (it == conns_.end()) {
      ConnState c;
      c.conn_hash = put_conn_key(msg, family);
      c.family = family;
      c.seen = true;
      if (first) {
        // pre-existing connection: its history is the baseline, but the
        // owner still needs resolving for later deltas
        fresh.push_back(inode);
        c.acked = ti->tcpi_bytes_acked;
        c.received = ti->tcpi_bytes_received;
      } else {
        // born inside the window: everything counts; emit after the pid
        // resolve pass (one /proc scan for all newborns, not one each)
        fresh.push_back(inode);
        if (ti->tcpi_bytes_acked || ti->tcpi_bytes_received)
          pending_[inode] = {ti->tcpi_bytes_acked, ti->tcpi_bytes_received};
        c.acked = ti->tcpi_bytes_acked;
        c.received = ti->tcpi_bytes_received;
      }
      conns_.emplace(inode, c);
      return;
    }
    ConnState& c = it->second;
    c.seen = true;
    uint64_t ds = ti->tcpi_bytes_acked >= c.acked
                      ? ti->tcpi_bytes_acked - c.acked : 0;
    uint64_t dr = ti->tcpi_bytes_received >= c.received
                      ? ti->tcpi_bytes_received - c.received : 0;
    c.acked = ti->tcpi_bytes_acked;
    c.received = ti->tcpi_bytes_received;
    if (ds || dr) push(c, ds, dr);
  }

  uint64_t put_conn_key(const struct inet_diag_msg* msg, uint8_t family) {
    char key[128];
    int kn;
    uint16_t sport = ntohs(msg->id.idiag_sport);
    uint16_t dport = ntohs(msg->id.idiag_dport);
    if (family == AF_INET) {
      uint32_t s = ntohl(msg->id.idiag_src[0]);
      uint32_t d = ntohl(msg->id.idiag_dst[0]);
      kn = snprintf(key, sizeof(key), "%u.%u.%u.%u:%u->%u.%u.%u.%u:%u",
                    s >> 24, (s >> 16) & 0xff, (s >> 8) & 0xff, s & 0xff,
                    sport, d >> 24, (d >> 16) & 0xff, (d >> 8) & 0xff,
                    d & 0xff, dport);
    } else {
      kn = snprintf(key, sizeof(key),
                    "[%08x:%08x:%08x:%08x]:%u->[%08x:%08x:%08x:%08x]:%u",
                    ntohl(msg->id.idiag_src[0]), ntohl(msg->id.idiag_src[1]),
                    ntohl(msg->id.idiag_src[2]), ntohl(msg->id.idiag_src[3]),
                    sport,
                    ntohl(msg->id.idiag_dst[0]), ntohl(msg->id.idiag_dst[1]),
                    ntohl(msg->id.idiag_dst[2]), ntohl(msg->id.idiag_dst[3]),
                    dport);
    }
    uint64_t h = fnv1a64(key, (size_t)kn);
    vocab_.put(h, key, (size_t)kn);
    return h;
  }

  void push(const ConnState& c, uint64_t sent, uint64_t received) {
    Event ev{};
    ev.ts_ns = now_ns();
    ev.kind = EV_TCP_BYTES;
    ev.aux1 = sent;
    ev.aux2 = received;
    if (c.pid) {
      ev.pid = c.pid;
      fill_proc_identity(ev, vocab_, c.pid);
    }
    ev.key_hash = c.conn_hash;  // after identity fill: the conn is the key
    emit(ev);
  }

  int interval_ms_;
  int netns_pid_ = 0;
  std::unordered_map<uint64_t, ConnState> conns_;
  std::unordered_map<uint64_t, std::pair<uint64_t, uint64_t>> pending_;
};

// ---------------------------------------------------------------------------
// KmsgOomSource — trace/oomkill via the kernel log stream.
// ---------------------------------------------------------------------------

class KmsgOomSource : public Source {
 public:
  explicit KmsgOomSource(size_t ring_pow2) : Source(ring_pow2) {}
  ~KmsgOomSource() override { stop(); }

 protected:
  void run() override {
    int fd = open("/dev/kmsg", O_RDONLY | O_NONBLOCK | O_CLOEXEC);
    if (fd < 0) return;
    lseek(fd, 0, SEEK_END);  // live events only, skip history
    struct pollfd pfd{fd, POLLIN, 0};
    // The trigger's pid is not present in any kmsg line the OOM killer
    // emits (only its comm, in "<comm> invoked oom-killer"); ppid stays 0.
    char killer_comm[32] = "";
    while (running_.load(std::memory_order_relaxed)) {
      if (poll(&pfd, 1, 100) <= 0) continue;
      char buf[2048];
      ssize_t n;
      while ((n = read(fd, buf, sizeof(buf) - 1)) > 0) {
        buf[n] = 0;
        // kmsg record: "pri,seq,ts,-;message"
        char* msg = strchr(buf, ';');
        msg = msg ? msg + 1 : buf;
        // "<comm> invoked oom-killer:" — remember the trigger
        char* inv = strstr(msg, " invoked oom-killer");
        if (inv) {
          size_t cl = (size_t)(inv - msg);
          if (cl >= sizeof(killer_comm)) cl = sizeof(killer_comm) - 1;
          memcpy(killer_comm, msg, cl);
          killer_comm[cl] = 0;
        }
        // "Out of memory: Killed process 123 (comm) total-vm:456kB, ..."
        // (also "Memory cgroup out of memory: Killed process ...")
        char* kp = strstr(msg, "Killed process ");
        if (kp) {
          unsigned pid = 0;
          char comm[64] = "";
          unsigned long long vm_kb = 0;
          sscanf(kp, "Killed process %u (%63[^)])", &pid, comm);
          char* tv = strstr(kp, "total-vm:");
          if (tv) sscanf(tv, "total-vm:%llukB", &vm_kb);
          Event ev{};
          ev.ts_ns = now_ns();
          ev.kind = EV_OOMKILL;
          ev.pid = pid;         // victim
          ev.aux1 = vm_kb / 4;  // pages (4k)
          size_t cn = strlen(comm);
          if (cn) {
            ev.key_hash = fnv1a64(comm, cn);
            vocab_.put(ev.key_hash, comm, cn);
            memcpy(ev.comm, comm,
                   cn < sizeof(ev.comm) - 1 ? cn : sizeof(ev.comm) - 1);
          }
          // aux2: trigger comm hash (vocab-resolvable)
          size_t kn = strlen(killer_comm);
          if (kn) {
            ev.aux2 = fnv1a64(killer_comm, kn);
            vocab_.put(ev.aux2, killer_comm, kn);
          }
          // victim may already be gone; mntns best-effort
          fill_mntns(ev);
          emit(ev);
        }
      }
    }
    close(fd);
  }

 private:
  static void fill_mntns(Event& ev) {
    char path[64], link[64];
    snprintf(path, sizeof(path), "/proc/%u/ns/mnt", ev.pid);
    ssize_t ln = readlink(path, link, sizeof(link) - 1);
    if (ln > 0) {
      link[ln] = 0;
      const char* lb = strchr(link, '[');
      if (lb) ev.mntns = strtoull(lb + 1, nullptr, 10);
    }
  }
};


// Shared tracefs root discovery with auto-mount. The reference's
// entrypoint remounts kernel filesystems the capture layer needs
// (entrypoint.sh bpffs remount); the tracefs analogue: when neither
// standard mount point exists, mount a private tracefs instance under
// /run — requires CAP_SYS_ADMIN, degrades to "" without it. The mount is
// left in place (like the entrypoint's bpffs) — it is a kernel view, not
// per-process state, and repeated mounts are satisfied by the cache.
inline std::string tracefs_root() {
  static std::mutex mu;
  static std::string cached;
  static bool resolved = false;
  std::lock_guard<std::mutex> g(mu);
  if (resolved) return cached;
  for (const char* p : {"/sys/kernel/tracing", "/sys/kernel/debug/tracing"}) {
    std::string ev = std::string(p) + "/events";
    if (access(ev.c_str(), R_OK) == 0) {
      cached = p;
      resolved = true;
      return cached;
    }
  }
  const char* priv = "/run/igtpu_tracefs";
  mkdir(priv, 0700);
  std::string ev = std::string(priv) + "/events";
  if (access(ev.c_str(), R_OK) == 0 ||
      mount("tracefs", priv, "tracefs", 0, nullptr) == 0) {
    if (access(ev.c_str(), R_OK) == 0) cached = priv;
  }
  resolved = true;
  return cached;
}

}  // namespace ig
#endif  // __linux__
