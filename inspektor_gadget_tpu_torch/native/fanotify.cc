// FanotifyExecSource — container-runtime detection via fanotify.
//
// Reference contract: pkg/runcfanotify/runcfanotify.go — watches runc
// binaries with FAN_OPEN_EXEC_PERM, reads the OCI bundle's config.json,
// and emits container add/remove without any runtime hook (:144-300).
// Here: FAN_OPEN_EXEC (non-permission flavour — observe, never gate) marks
// on the configured binaries; each exec of a watched binary emits an
// EV_EXEC event whose mntns/pid identify the new workload root. The
// ContainerCollection consumes these as container-start candidates.

#ifdef __linux__
#include <fcntl.h>
#include <sys/fanotify.h>
#include <unistd.h>

#include <cstring>
#include <string>
#include <vector>

#include "ringbuf.h"

namespace ig {

class FanotifyExecSource : public Source {
 public:
  FanotifyExecSource(size_t ring_pow2, std::vector<std::string> paths)
      : Source(ring_pow2), paths_(std::move(paths)) {
    if (paths_.empty())
      paths_ = {"/usr/bin/runc", "/usr/sbin/runc", "/usr/local/bin/runc"};
  }
  ~FanotifyExecSource() override { stop(); }

  static bool supported() {  // ref: runcfanotify.go Supported():144
    int fd = fanotify_init(FAN_CLASS_NOTIF | FAN_NONBLOCK,
                           O_RDONLY | O_CLOEXEC);
    if (fd < 0) return false;
    close(fd);
    return true;
  }

 protected:
  void run() override {
    int fan = fanotify_init(FAN_CLASS_NOTIF | FAN_NONBLOCK,
                            O_RDONLY | O_LARGEFILE | O_CLOEXEC);
    if (fan < 0) return;
    bool any = false;
    for (const auto& p : paths_) {
      if (fanotify_mark(fan, FAN_MARK_ADD, FAN_OPEN_EXEC, AT_FDCWD,
                        p.c_str()) == 0)
        any = true;
    }
    if (!any) {
      close(fan);
      return;
    }
    char buf[4096];
    while (running_.load(std::memory_order_relaxed)) {
      ssize_t len = read(fan, buf, sizeof(buf));
      if (len <= 0) {
        std::this_thread::sleep_for(std::chrono::milliseconds(10));
        continue;
      }
      auto* md = (struct fanotify_event_metadata*)buf;
      while (FAN_EVENT_OK(md, len)) {
        if (md->mask & FAN_OPEN_EXEC) {
          Event ev{};
          ev.ts_ns = now_ns();
          ev.kind = EV_EXEC;
          ev.pid = (uint32_t)md->pid;
          fill_identity(ev);
          emit(ev);
        }
        if (md->fd >= 0) close(md->fd);
        md = FAN_EVENT_NEXT(md, len);
      }
    }
    close(fan);
  }

 private:
  void fill_identity(Event& ev) {
    char path[64], buf[64];
    snprintf(path, sizeof(path), "/proc/%u/comm", ev.pid);
    int fd = open(path, O_RDONLY);
    ssize_t n = fd >= 0 ? read(fd, buf, sizeof(buf) - 1) : 0;
    if (fd >= 0) close(fd);
    if (n > 0 && buf[n - 1] == '\n') n--;
    if (n > 0) {
      ev.key_hash = fnv1a64(buf, (size_t)n);
      vocab_.put(ev.key_hash, buf, (size_t)n);
      size_t c = (size_t)n < sizeof(ev.comm) - 1 ? (size_t)n : sizeof(ev.comm) - 1;
      memcpy(ev.comm, buf, c);
    }
    snprintf(path, sizeof(path), "/proc/%u/ns/mnt", ev.pid);
    char link[64];
    ssize_t ln = readlink(path, link, sizeof(link) - 1);
    if (ln > 0) {
      link[ln] = 0;
      const char* lb = strchr(link, '[');
      if (lb) ev.mntns = strtoull(lb + 1, nullptr, 10);
    }
  }

  std::vector<std::string> paths_;
};

// ---------------------------------------------------------------------------
// FanotifyRuncSource — container identity from the runtime, hookless.
//
// Reference contract: pkg/runcfanotify/runcfanotify.go:160-300 — watch runc
// binaries, parse the command line for the OCI verb + --bundle + --pid-file
// + container id, then watch the pid file to learn the container init pid,
// and watch that pid for termination. The config.json itself is parsed by
// the Python rim (containers/options.py), which has a JSON parser; this
// source delivers the kernel-real detection chain:
//   EV_CONTAINER aux2=1 create / 2 start / 3 run / 4 delete  (runc exec seen)
//   EV_CONTAINER aux2=10 started  (pid file written; ev.pid = init pid)
//   EV_CONTAINER aux2=11 removed  (init pid vanished)
// vocab payload under key_hash: "<id>\x1f<bundle>\x1f<pidfile>".
// ---------------------------------------------------------------------------

class FanotifyRuncSource : public Source {
 public:
  FanotifyRuncSource(size_t ring_pow2, const std::string& cfg)
      : Source(ring_pow2) {
    std::string p = cfg_get(cfg, "paths");
    if (!p.empty()) paths_ = split_str(p, ':');
    if (paths_.empty())
      paths_ = {"/usr/bin/runc", "/usr/sbin/runc", "/usr/local/bin/runc",
                "/usr/local/sbin/runc"};
  }
  ~FanotifyRuncSource() override { stop(); }

 protected:
  struct PidWait {
    std::string pidfile;
    uint64_t key_hash;
    uint64_t deadline_ns;
  };
  struct TermWait {
    uint32_t pid;
    uint64_t key_hash;
  };

  void run() override {
    int fan = fanotify_init(FAN_CLASS_NOTIF | FAN_NONBLOCK,
                            O_RDONLY | O_LARGEFILE | O_CLOEXEC);
    if (fan < 0) return;
    bool any = false;
    for (const auto& p : paths_)
      if (fanotify_mark(fan, FAN_MARK_ADD, FAN_OPEN_EXEC, AT_FDCWD,
                        p.c_str()) == 0)
        any = true;
    if (!any) {
      close(fan);
      return;
    }
    char buf[4096];
    while (running_.load(std::memory_order_relaxed)) {
      ssize_t len = read(fan, buf, sizeof(buf));
      if (len > 0) {
        auto* md = (struct fanotify_event_metadata*)buf;
        while (FAN_EVENT_OK(md, len)) {
          if (md->mask & FAN_OPEN_EXEC) on_runc_exec((uint32_t)md->pid);
          if (md->fd >= 0) close(md->fd);
          md = FAN_EVENT_NEXT(md, len);
        }
      }
      poll_waiters();
      std::this_thread::sleep_for(std::chrono::milliseconds(10));
    }
    close(fan);
  }

 private:
  void on_runc_exec(uint32_t pid) {
    // /proc/<pid>/cmdline is NUL-separated argv
    char path[64];
    snprintf(path, sizeof(path), "/proc/%u/cmdline", pid);
    int fd = open(path, O_RDONLY);
    if (fd < 0) return;
    char raw[4096];
    ssize_t n = read(fd, raw, sizeof(raw) - 1);
    close(fd);
    if (n <= 0) return;
    raw[n] = 0;
    std::vector<std::string> argv;
    for (ssize_t i = 0; i < n;) {
      size_t l = strnlen(raw + i, (size_t)(n - i));
      argv.emplace_back(raw + i, l);
      i += (ssize_t)l + 1;
    }
    // parse: runc [global flags] <verb> [--bundle B] [--pid-file P] <id>
    int verb = 0;
    std::string bundle, pidfile, id;
    for (size_t i = 1; i < argv.size(); i++) {
      const std::string& a = argv[i];
      if (a == "create") verb = 1;
      else if (a == "start") verb = 2;
      else if (a == "run") verb = 3;
      else if (a == "delete") verb = 4;
      else if ((a == "--bundle" || a == "-b") && i + 1 < argv.size())
        bundle = argv[++i];
      else if (a == "--pid-file" && i + 1 < argv.size())
        pidfile = argv[++i];
      else if (verb && a[0] != '-')
        id = a;  // last non-flag arg after the verb
    }
    if (!verb || id.empty()) return;
    if (bundle.empty()) {
      // runc defaults the bundle to the invoking cwd (runc spec)
      char cwdlink[64], cwd[512];
      snprintf(cwdlink, sizeof(cwdlink), "/proc/%u/cwd", pid);
      ssize_t cn = readlink(cwdlink, cwd, sizeof(cwd) - 1);
      if (cn > 0) bundle.assign(cwd, (size_t)cn);
    }
    // One key per container id: create/run registers it; start/delete
    // reuse it so the whole lifecycle chain correlates by key_hash.
    uint64_t kh;
    auto known = id_keys_.find(id);
    if (known != id_keys_.end() && verb != 1 && verb != 3) {
      kh = known->second;
    } else {
      std::string payload = id + '\x1f' + bundle + '\x1f' + pidfile;
      kh = fnv1a64(payload.data(), payload.size());
      vocab_.put(kh, payload.data(), payload.size());
      id_keys_[id] = kh;
    }
    Event ev{};
    ev.ts_ns = now_ns();
    ev.kind = EV_CONTAINER;
    ev.pid = pid;
    ev.aux2 = (uint64_t)verb;
    ev.key_hash = kh;
    size_t c = id.size() < sizeof(ev.comm) - 1 ? id.size() : sizeof(ev.comm) - 1;
    memcpy(ev.comm, id.data(), c);
    emit(ev);
    if ((verb == 1 || verb == 3) && !pidfile.empty())
      pid_waits_.push_back(
          PidWait{pidfile, kh, now_ns() + 5000000000ull /*5s*/});
    if (verb == 4) {
      // delete verb: authoritative removal; drop any pending term watch so
      // the consumer does not see a duplicate removal for the same key
      for (size_t i = 0; i < term_waits_.size();) {
        if (term_waits_[i].key_hash == kh)
          term_waits_.erase(term_waits_.begin() + (long)i);
        else
          i++;
      }
      Event rv = ev;
      rv.aux2 = 11;
      rv.pid = 0;  // init pid unknown at delete time
      emit(rv);
      id_keys_.erase(id);
    }
  }

  void poll_waiters() {
    uint64_t now = now_ns();
    for (size_t i = 0; i < pid_waits_.size();) {
      PidWait& w = pid_waits_[i];
      FILE* f = fopen(w.pidfile.c_str(), "r");
      unsigned pid = 0;
      if (f) {
        if (fscanf(f, "%u", &pid) != 1) pid = 0;
        fclose(f);
      }
      if (pid) {
        Event ev{};
        ev.ts_ns = now;
        ev.kind = EV_CONTAINER;
        ev.pid = pid;
        ev.aux2 = 10;  // started
        ev.key_hash = w.key_hash;
        fill_mntns(ev, pid);
        emit(ev);
        term_waits_.push_back(TermWait{pid, w.key_hash});
        pid_waits_.erase(pid_waits_.begin() + (long)i);
      } else if (now > w.deadline_ns) {
        pid_waits_.erase(pid_waits_.begin() + (long)i);
      } else {
        i++;
      }
    }
    for (size_t i = 0; i < term_waits_.size();) {
      char p[64];
      snprintf(p, sizeof(p), "/proc/%u", term_waits_[i].pid);
      if (access(p, F_OK) != 0) {
        Event ev{};
        ev.ts_ns = now;
        ev.kind = EV_CONTAINER;
        ev.pid = term_waits_[i].pid;
        ev.aux2 = 11;  // removed
        ev.key_hash = term_waits_[i].key_hash;
        emit(ev);
        term_waits_.erase(term_waits_.begin() + (long)i);
      } else {
        i++;
      }
    }
  }

  static void fill_mntns(Event& ev, uint32_t pid) {
    char path[64], link[64];
    snprintf(path, sizeof(path), "/proc/%u/ns/mnt", pid);
    ssize_t ln = readlink(path, link, sizeof(link) - 1);
    if (ln > 0) {
      link[ln] = 0;
      const char* lb = strchr(link, '[');
      if (lb) ev.mntns = strtoull(lb + 1, nullptr, 10);
    }
  }

  std::vector<std::string> paths_;
  std::vector<PidWait> pid_waits_;
  std::vector<TermWait> term_waits_;
  std::unordered_map<std::string, uint64_t> id_keys_;
};

}  // namespace ig
#endif  // __linux__
