// PtraceSyscallSource — a real per-process syscall stream.
//
// Reference contract: traceloop's raw tracepoints on sys_enter/sys_exit
// feeding per-container ring buffers (pkg/gadgets/traceloop/tracer/bpf/
// traceloop.bpf.c:1-470) with userspace arg-decode tables
// (pkg/gadgets/traceloop/tracer/tracer.go:246-632). Here the kernel window
// is ptrace: PTRACE_SYSCALL stops deliver every entry/exit of the traced
// tree (children auto-attached via TRACECLONE/FORK/VFORK), registers carry
// nr/args/ret, and process_vm_readv reads string arguments. Each completed
// syscall is one EV_SYSCALL event whose vocab payload is the decoded
// "name(arg, "str", ...) = ret" line.
//
// The same stream derives three more gadget families the reference covers
// with dedicated BPF programs, because the syscalls themselves are the
// ground truth being traced:
//  - EV_SIGNAL: ptrace signal-delivery-stops (receiver side, sigsnoop's
//    exact semantics for the traced tree) + kill/tkill/tgkill exits
//    (sender side).
//  - EV_CAPABILITY: syscalls that imply a capability check (mount →
//    CAP_SYS_ADMIN, setuid → CAP_SETUID, bind(<1024) →
//    CAP_NET_BIND_SERVICE, ...) with the verdict inferred from the
//    observed outcome (-EPERM/-EACCES = deny). Ref: capable.bpf.c's
//    kprobe on cap_capable; here the check's *result* is observed.
//  - EV_FSSLOWER: read/write/openat/fsync latency measured between the
//    entry and exit stops, fd resolved to a path via /proc/<tid>/fd while
//    the tracee is stopped. Ref: fsslower.bpf.c's kprobe pairs.
//
// Tracing is opt-in per target (cmd= spawns, pid= attaches) — matching the
// reference's traceloop, which also attaches per-container rather than
// system-wide.

#ifdef __linux__
#include <elf.h>
#include <fcntl.h>
#include <signal.h>
#include <sys/ptrace.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <sys/user.h>
#include <sys/wait.h>
#include <unistd.h>

#include <cerrno>

#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "ringbuf.h"

namespace ig {

// Generated from <asm/unistd.h> by the Makefile (arch-correct nr → name).
struct SyscallName {
  long nr;
  const char* name;
};
static const SyscallName kSyscallNames[] = {
#include "syscall_names.inc"
    {-1, nullptr},
};

// Arg decode spec, keyed by syscall name (arch-independent).
//  i=int f=fd x=hex s=tracee string o=octal S=signal a=sockaddr(fd-style)
//  p=pointer -=end
struct SysSpec {
  const char* name;
  const char* args;   // up to 6 type chars
  int8_t cap;         // implied Linux capability number, -1 = none
  int8_t fs_op;       // 0=none 1=read 2=write 3=open 4=fsync
  int8_t path_arg;    // arg index holding a path string, -1 = none
  int8_t sig_arg;     // arg index holding a signal number, -1 = none
};
static const SysSpec kSpecs[] = {
    {"read", "fpi", -1, 1, -1, -1},
    {"pread64", "fpii", -1, 1, -1, -1},
    {"readv", "fpi", -1, 1, -1, -1},
    {"write", "fpi", -1, 2, -1, -1},
    {"pwrite64", "fpii", -1, 2, -1, -1},
    {"writev", "fpi", -1, 2, -1, -1},
    {"open", "sxo", -1, 3, 0, -1},
    {"openat", "fsxo", -1, 3, 1, -1},
    {"creat", "so", -1, 3, 0, -1},
    {"close", "f", -1, 0, -1, -1},
    {"fsync", "f", -1, 4, -1, -1},
    {"fdatasync", "f", -1, 4, -1, -1},
    {"stat", "sp", -1, 0, 0, -1},
    {"lstat", "sp", -1, 0, 0, -1},
    {"fstat", "fp", -1, 0, -1, -1},
    {"newfstatat", "fspi", -1, 0, 1, -1},
    {"statx", "fsxxp", -1, 0, 1, -1},
    {"access", "si", -1, 0, 0, -1},
    {"faccessat", "fsi", -1, 0, 1, -1},
    {"faccessat2", "fsii", -1, 0, 1, -1},
    {"execve", "spp", -1, 0, 0, -1},
    {"execveat", "fspp", -1, 0, 1, -1},
    {"readlink", "spi", -1, 0, 0, -1},
    {"readlinkat", "fspi", -1, 0, 1, -1},
    {"unlink", "s", -1, 0, 0, -1},
    {"unlinkat", "fsi", -1, 0, 1, -1},
    {"mkdir", "so", -1, 0, 0, -1},
    {"mkdirat", "fso", -1, 0, 1, -1},
    {"rmdir", "s", -1, 0, 0, -1},
    {"rename", "ss", -1, 0, 0, -1},
    {"renameat2", "fsfsx", -1, 0, 1, -1},
    {"getdents64", "fpi", -1, 0, -1, -1},
    {"chdir", "s", -1, 0, 0, -1},
    {"mmap", "piiifi", -1, 0, -1, -1},
    {"munmap", "pi", -1, 0, -1, -1},
    {"mprotect", "pix", -1, 0, -1, -1},
    {"brk", "p", -1, 0, -1, -1},
    {"ioctl", "fxx", -1, 0, -1, -1},
    {"fcntl", "fix", -1, 0, -1, -1},
    {"dup", "f", -1, 0, -1, -1},
    {"dup2", "ff", -1, 0, -1, -1},
    {"dup3", "ffx", -1, 0, -1, -1},
    {"pipe2", "px", -1, 0, -1, -1},
    {"socket", "iii", -1, 0, -1, -1},
    {"bind", "fai", 10 /*NET_BIND_SERVICE, port-gated*/, 0, -1, -1},
    {"connect", "fai", -1, 0, -1, -1},
    {"accept", "fpp", -1, 0, -1, -1},
    {"accept4", "fppx", -1, 0, -1, -1},
    {"listen", "fi", -1, 0, -1, -1},
    {"sendto", "fpixai", -1, 2, -1, -1},
    {"recvfrom", "fpixpp", -1, 1, -1, -1},
    {"sendmsg", "fpx", -1, 2, -1, -1},
    {"recvmsg", "fpx", -1, 1, -1, -1},
    {"setsockopt", "fiipx", -1, 0, -1, -1},
    {"getsockopt", "fiipp", -1, 0, -1, -1},
    {"kill", "iS", 5 /*KILL*/, 0, -1, 1},
    {"tkill", "iS", 5, 0, -1, 1},
    {"tgkill", "iiS", 5, 0, -1, 2},
    {"rt_sigaction", "Spp", -1, 0, -1, -1},
    {"rt_sigprocmask", "ipp", -1, 0, -1, -1},
    {"rt_sigreturn", "", -1, 0, -1, -1},
    {"clone", "xppp", -1, 0, -1, -1},
    {"clone3", "pi", -1, 0, -1, -1},
    {"fork", "", -1, 0, -1, -1},
    {"vfork", "", -1, 0, -1, -1},
    {"wait4", "ipip", -1, 0, -1, -1},
    {"exit", "i", -1, 0, -1, -1},
    {"exit_group", "i", -1, 0, -1, -1},
    {"mount", "sssxp", 21 /*SYS_ADMIN*/, 0, 1, -1},
    {"umount2", "si", 21, 0, 0, -1},
    {"pivot_root", "ss", 21, 0, 0, -1},
    {"sethostname", "pi", 21, 0, -1, -1},
    {"setns", "fi", 21, 0, -1, -1},
    {"unshare", "x", 21, 0, -1, -1},
    {"init_module", "pis", 16 /*SYS_MODULE*/, 0, -1, -1},
    {"finit_module", "fsx", 16, 0, -1, -1},
    {"setuid", "i", 7 /*SETUID*/, 0, -1, -1},
    {"setgid", "i", 6 /*SETGID*/, 0, -1, -1},
    {"setreuid", "ii", 7, 0, -1, -1},
    {"setregid", "ii", 6, 0, -1, -1},
    {"setresuid", "iii", 7, 0, -1, -1},
    {"setresgid", "iii", 6, 0, -1, -1},
    {"chown", "sii", 0 /*CHOWN*/, 0, 0, -1},
    {"lchown", "sii", 0, 0, 0, -1},
    {"fchown", "fii", 0, 0, -1, -1},
    {"fchownat", "fsiii", 0, 0, 1, -1},
    {"chmod", "so", 3 /*FOWNER-ish; keep DAC*/, 0, 0, -1},
    {"fchmod", "fo", -1, 0, -1, -1},
    {"fchmodat", "fso", -1, 0, 1, -1},
    {"chroot", "s", 18 /*SYS_CHROOT*/, 0, 0, -1},
    {"mknod", "soi", 27 /*MKNOD*/, 0, 0, -1},
    {"mknodat", "fsoi", 27, 0, 1, -1},
    {"ptrace", "iipp", 19 /*SYS_PTRACE*/, 0, -1, -1},
    {"process_vm_readv", "ipipii", 19, 0, -1, -1},
    {"reboot", "xxxp", 22 /*SYS_BOOT*/, 0, -1, -1},
    {"swapon", "sx", 21, 0, 0, -1},
    {"setpriority", "iii", 23 /*SYS_NICE*/, 0, -1, -1},
    {"sched_setaffinity", "iip", 23, 0, -1, -1},
    {"prctl", "ixxxx", -1, 0, -1, -1},
    {"capset", "pp", 8 /*SETPCAP*/, 0, -1, -1},
    {"futex", "pixppi", -1, 0, -1, -1},
    {"nanosleep", "pp", -1, 0, -1, -1},
    {"clock_nanosleep", "iipp", -1, 0, -1, -1},
    {"getpid", "", -1, 0, -1, -1},
    {"gettid", "", -1, 0, -1, -1},
    {"getuid", "", -1, 0, -1, -1},
    {"geteuid", "", -1, 0, -1, -1},
    {"getcwd", "pi", -1, 0, -1, -1},
    {"uname", "p", -1, 0, -1, -1},
    {nullptr, nullptr, -1, 0, -1, -1},
};

static const char* kSigNames[] = {
    "0",       "SIGHUP",  "SIGINT",    "SIGQUIT", "SIGILL",  "SIGTRAP",
    "SIGABRT", "SIGBUS",  "SIGFPE",    "SIGKILL", "SIGUSR1", "SIGSEGV",
    "SIGUSR2", "SIGPIPE", "SIGALRM",   "SIGTERM", "SIGSTKFLT", "SIGCHLD",
    "SIGCONT", "SIGSTOP", "SIGTSTP",   "SIGTTIN", "SIGTTOU", "SIGURG",
    "SIGXCPU", "SIGXFSZ", "SIGVTALRM", "SIGPROF", "SIGWINCH", "SIGIO",
    "SIGPWR",  "SIGSYS"};

class PtraceSyscallSource : public Source {
 public:
  PtraceSyscallSource(size_t ring_pow2, const std::string& cfg)
      : Source(ring_pow2) {
    std::string cmd = cfg_get(cfg, "cmd");
    for (auto& a : split_str(cmd, '\x1e')) argv_.push_back(a);
    attach_pid_ = atoi(cfg_get(cfg, "pid", "0").c_str());
    min_lat_us_ = strtoull(cfg_get(cfg, "min_lat_us", "0").c_str(), nullptr, 10);
    for (const SyscallName* n = kSyscallNames; n->name; n++)
      names_[n->nr] = n->name;
    for (const SysSpec* s = kSpecs; s->name; s++) spec_by_name_[s->name] = s;
    // Decoded call lines are near-unique per call (pointers, rets); bound
    // the side table so long traces cannot grow memory without limit.
    vocab_.set_capacity(1u << 18);
  }
  ~PtraceSyscallSource() override { stop(); }

  // Exit status of the spawned command (cmd mode), -1 while running.
  int exit_status() const { return exit_status_.load(); }

 protected:
  struct TaskState {
    bool in_syscall = false;
    uint64_t entry_ts = 0;
    long nr = 0;
    uint64_t args[6] = {0};
    bool attached = false;   // first stop handled
    std::string call_prefix; // "name(decoded args" — built at ENTRY, while
                             // the argument memory is still live (execve
                             // wipes it before the exit stop)
    std::string fs_path;     // path arg decoded at entry (fsslower)
    uint16_t sock_port = 0;  // sockaddr port decoded at entry (bind)
    const SysSpec* spec = nullptr;
    const char* name = nullptr;
    char namebuf[24];
  };

#if defined(__x86_64__)
  using Regs = struct user_regs_struct;
  static long regs_nr(const Regs& r) { return (long)r.orig_rax; }
  static uint64_t regs_ret(const Regs& r) { return r.rax; }
  static void regs_args(const Regs& r, uint64_t* a) {
    a[0] = r.rdi; a[1] = r.rsi; a[2] = r.rdx;
    a[3] = r.r10; a[4] = r.r8; a[5] = r.r9;
  }
#elif defined(__aarch64__)
  using Regs = struct user_regs_struct;
  static long regs_nr(const Regs& r) { return (long)r.regs[8]; }
  static uint64_t regs_ret(const Regs& r) { return r.regs[0]; }
  static void regs_args(const Regs& r, uint64_t* a) {
    for (int i = 0; i < 6; i++) a[i] = r.regs[i];
  }
#else
#error "unsupported arch for ptrace source"
#endif

  bool get_regs(pid_t tid, Regs* r) {
    struct iovec iov{r, sizeof(*r)};
    return ptrace(PTRACE_GETREGSET, tid, (void*)NT_PRSTATUS, &iov) == 0;
  }

  void run() override {
    const long opts = PTRACE_O_TRACESYSGOOD | PTRACE_O_TRACECLONE |
                      PTRACE_O_TRACEFORK | PTRACE_O_TRACEVFORK |
                      PTRACE_O_TRACEEXEC;
    pid_t root = 0;
    if (!argv_.empty()) {
      std::vector<char*> cargv;
      for (auto& a : argv_) cargv.push_back(const_cast<char*>(a.c_str()));
      cargv.push_back(nullptr);
      root = fork();
      if (root == 0) {
        ptrace(PTRACE_TRACEME, 0, 0, 0);
        raise(SIGSTOP);
        execvp(cargv[0], cargv.data());
        _exit(127);
      }
      if (root < 0) return;
      child_ = root;
    } else if (attach_pid_ > 0) {
      root = attach_pid_;
      if (ptrace(PTRACE_ATTACH, root, 0, 0) < 0) return;
    } else {
      return;
    }
    tasks_[root] = TaskState{};
    // First stop: set inheritable options, then enter the syscall loop.
    int st;
    if (waitpid(root, &st, __WALL) < 0) return;
    ptrace(PTRACE_SETOPTIONS, root, 0, (void*)opts);
    ptrace(PTRACE_SYSCALL, root, 0, 0);

    while (running_.load(std::memory_order_relaxed)) {
      bool saw_any = false;
      // Only wait on known tracees — waitpid(-1) would steal exit statuses
      // of unrelated children of this (Python host) process. New tracees
      // are learned from PTRACE_EVENT_{CLONE,FORK,VFORK} before they run.
      std::vector<pid_t> tids;
      tids.reserve(tasks_.size());
      for (auto& [tid, _] : tasks_) tids.push_back(tid);
      for (pid_t tid : tids) {
        pid_t p = waitpid(tid, &st, __WALL | WNOHANG);
        if (p <= 0) continue;
        saw_any = true;
        handle_stop(p, st);
      }
      if (tasks_.empty()) {
        // traced tree fully exited; idle until stop()
        std::this_thread::sleep_for(std::chrono::milliseconds(20));
        continue;
      }
      if (!saw_any)
        std::this_thread::sleep_for(std::chrono::microseconds(200));
    }
    // Teardown: kill the spawned tree / detach from attached tracees.
    if (child_ > 0) {
      kill(child_, SIGKILL);
      for (auto& [tid, _] : tasks_) kill(tid, SIGKILL);
      int st2;
      waitpid(child_, &st2, __WALL | WNOHANG);
    } else {
      for (auto& [tid, _] : tasks_) {
        kill(tid, SIGSTOP);
        int st2;
        waitpid(tid, &st2, __WALL | WNOHANG);
        ptrace(PTRACE_DETACH, tid, 0, SIGCONT);
      }
    }
  }

 private:
  void handle_stop(pid_t tid, int st) {
    auto it = tasks_.find(tid);
    if (it == tasks_.end()) return;
    TaskState& t = it->second;
    if (WIFEXITED(st) || WIFSIGNALED(st)) {
      tasks_.erase(it);
      if (tid == child_)
        exit_status_.store(WIFEXITED(st) ? WEXITSTATUS(st) : 128 + WTERMSIG(st));
      return;
    }
    if (!WIFSTOPPED(st)) return;
    int sig = WSTOPSIG(st);
    int event = st >> 16;
    long cont_sig = 0;
    if (sig == (SIGTRAP | 0x80)) {
      on_syscall_stop(tid, t);
    } else if (sig == SIGTRAP && event != 0) {
      if (event == PTRACE_EVENT_CLONE || event == PTRACE_EVENT_FORK ||
          event == PTRACE_EVENT_VFORK) {
        unsigned long newtid = 0;
        if (ptrace(PTRACE_GETEVENTMSG, tid, 0, &newtid) == 0 && newtid)
          tasks_[(pid_t)newtid] = TaskState{};
      }
      // EXEC event fires BETWEEN execve's entry and exit stops — the
      // in-flight syscall state (recorded at entry, pre-wipe) must be
      // preserved so the following syscall stop is treated as the exit.
    } else if (sig == SIGSTOP && !t.attached) {
      // initial stop of an auto-attached child
    } else {
      // Genuine signal-delivery-stop → sigsnoop semantics (receiver side).
      Event ev{};
      ev.ts_ns = now_ns();
      ev.kind = EV_SIGNAL;
      ev.pid = (uint32_t)tid;
      ev.ppid = (uint32_t)tid;  // receiver
      ev.aux1 = 0;              // delivery observed
      ev.aux2 = (uint64_t)sig;
      fill_identity(ev, tid);
      emit(ev);
      cont_sig = sig;  // re-inject: observe, never swallow
    }
    t.attached = true;
    if (tasks_.count(tid))
      ptrace(PTRACE_SYSCALL, tid, 0, (void*)cont_sig);
  }

  void on_syscall_stop(pid_t tid, TaskState& t) {
    Regs regs;
    if (!get_regs(tid, &regs)) return;
    if (!t.in_syscall) {
      // ---- entry stop: record + decode everything argument-dependent ------
      t.in_syscall = true;
      t.entry_ts = now_ns();
      t.nr = regs_nr(regs);
      regs_args(regs, t.args);
      auto nit = names_.find(t.nr);
      t.name = nit != names_.end() ? nit->second : nullptr;
      if (!t.name) {
        snprintf(t.namebuf, sizeof(t.namebuf), "sys_%ld", t.nr);
        t.name = t.namebuf;
      }
      t.spec = nullptr;
      auto sit = spec_by_name_.find(t.name);
      if (sit != spec_by_name_.end()) t.spec = sit->second;
      t.call_prefix = format_args(tid, t.name, t.spec, t.args);
      t.fs_path.clear();
      t.sock_port = 0;
      if (t.spec) {
        if (t.spec->path_arg >= 0)
          t.fs_path = read_str(tid, t.args[t.spec->path_arg]);
        const char* types = t.spec->args;
        for (size_t i = 0; types[i]; i++)
          if (types[i] == 'a') t.sock_port = sockaddr_port(tid, t.args[i]);
      }
      return;
    }
    // ---- exit stop: emit --------------------------------------------------
    t.in_syscall = false;
    uint64_t ts = now_ns();
    uint64_t lat_ns = ts - t.entry_ts;
    int64_t ret = (int64_t)regs_ret(regs);
    long nr = t.nr;
    const char* name = t.name;
    const SysSpec* spec = t.spec;

    Event ev{};
    ev.ts_ns = ts;
    ev.kind = EV_SYSCALL;
    ev.pid = (uint32_t)tid;
    ev.aux1 = lat_ns;
    ev.aux2 = ((uint64_t)(uint32_t)nr << 32) | (uint32_t)(int32_t)ret;
    char retbuf[32];
    snprintf(retbuf, sizeof(retbuf), ") = %lld", (long long)ret);
    std::string line = t.call_prefix + retbuf;
    ev.key_hash = fnv1a64(line.data(), line.size());
    vocab_.put(ev.key_hash, line.data(), line.size());
    size_t cn = strlen(name);
    memcpy(ev.comm, name, cn < sizeof(ev.comm) - 1 ? cn : sizeof(ev.comm) - 1);
    ev.mntns = mntns_of(tid);
    emit(ev);

    if (!spec) return;

    // ---- derived: sender-side signals --------------------------------------
    if (spec->sig_arg >= 0) {
      Event sv{};
      sv.ts_ns = ts;
      sv.kind = EV_SIGNAL;
      sv.pid = (uint32_t)tid;                       // sender
      sv.ppid = (uint32_t)t.args[0];                // target pid
      sv.aux1 = 2;                                  // sent
      sv.aux2 = t.args[spec->sig_arg] & 0x7f;
      sv.mntns = ev.mntns;
      fill_identity(sv, tid);
      emit(sv);
    }

    // ---- derived: capability checks ----------------------------------------
    if (spec->cap >= 0) {
      bool applies = true;
      if (strcmp(spec->name, "bind") == 0)
        applies = t.sock_port != 0 && t.sock_port < 1024;
      if (applies) {
        Event cv{};
        cv.ts_ns = ts;
        cv.kind = EV_CAPABILITY;
        cv.pid = (uint32_t)tid;
        cv.aux2 = (uint64_t)spec->cap;
        cv.aux1 = (ret == -EPERM || ret == -EACCES) ? 0 : 1;  // deny : allow
        cv.mntns = ev.mntns;
        fill_identity(cv, tid);
        emit(cv);
      }
    }

    // ---- derived: slow fs ops ----------------------------------------------
    if (spec->fs_op != 0 && lat_ns / 1000 >= min_lat_us_) {
      Event fv{};
      fv.ts_ns = ts;
      fv.kind = EV_FSSLOWER;
      fv.pid = (uint32_t)tid;
      fv.aux1 = lat_ns / 1000;  // latency us
      uint64_t bytes = (spec->fs_op == 1 || spec->fs_op == 2) && ret > 0
                           ? (uint64_t)ret
                           : 0;
      fv.aux2 = ((uint64_t)spec->fs_op << 32) | (bytes & 0xffffffff);
      fv.mntns = ev.mntns;
      // file identity: path arg decoded at entry, or the fd resolved now
      // (the fd table is intact while the tracee sits in the exit stop)
      std::string path = t.fs_path;
      if (path.empty() && spec->args[0] == 'f')
        path = fd_path(tid, (int)t.args[0]);
      if (!path.empty()) {
        fv.key_hash = fnv1a64(path.data(), path.size());
        vocab_.put(fv.key_hash, path.data(), path.size());
        memcpy(fv.comm, path.data(),
               path.size() < sizeof(fv.comm) - 1 ? path.size()
                                                 : sizeof(fv.comm) - 1);
      }
      emit(fv);
    }
  }

  std::string format_args(pid_t tid, const char* name, const SysSpec* spec,
                          const uint64_t* args) {
    char buf[512];
    size_t off = (size_t)snprintf(buf, sizeof(buf), "%s(", name);
    const char* types = spec ? spec->args : "xxx";
    for (size_t i = 0; types[i] && off < sizeof(buf) - 96; i++) {
      if (i) off += (size_t)snprintf(buf + off, sizeof(buf) - off, ", ");
      uint64_t a = args[i];
      switch (types[i]) {
        case 'i':
          off += (size_t)snprintf(buf + off, sizeof(buf) - off, "%lld",
                                  (long long)(int64_t)a);
          break;
        case 'f':
          off += (size_t)snprintf(buf + off, sizeof(buf) - off, "%d", (int)a);
          break;
        case 'o':
          off += (size_t)snprintf(buf + off, sizeof(buf) - off, "0%llo",
                                  (unsigned long long)a);
          break;
        case 'S': {
          unsigned s = (unsigned)a & 0x7f;
          if (s < sizeof(kSigNames) / sizeof(kSigNames[0]))
            off += (size_t)snprintf(buf + off, sizeof(buf) - off, "%s",
                                    kSigNames[s]);
          else
            off += (size_t)snprintf(buf + off, sizeof(buf) - off, "%u", s);
          break;
        }
        case 's': {
          std::string sv = read_str(tid, a);
          off += (size_t)snprintf(buf + off, sizeof(buf) - off, "\"%s\"",
                                  sv.c_str());
          break;
        }
        case 'a': {
          uint16_t port = sockaddr_port(tid, a);
          off += (size_t)snprintf(buf + off, sizeof(buf) - off, "{port=%u}",
                                  port);
          break;
        }
        case 'p':
        case 'x':
        default:
          off += (size_t)snprintf(buf + off, sizeof(buf) - off, "0x%llx",
                                  (unsigned long long)a);
          break;
      }
    }
    return std::string(buf, off);
  }

  std::string read_str(pid_t tid, uint64_t addr) {
    if (!addr) return "NULL";
    // process_vm_readv fails the whole iovec if any byte is unmapped, and
    // argv/env strings commonly end right at a page boundary — read in
    // page-clamped chunks so a short valid string near unmapped memory
    // still decodes.
    char buf[96];
    size_t total = 0;
    while (total < sizeof(buf)) {
      uint64_t a = addr + total;
      size_t page_left = 4096 - (a & 4095);
      size_t want = sizeof(buf) - total;
      if (want > page_left) want = page_left;
      struct iovec local{buf + total, want};
      struct iovec remote{(void*)a, want};
      ssize_t n = process_vm_readv(tid, &local, 1, &remote, 1, 0);
      if (n <= 0) break;
      total += (size_t)n;
      if (memchr(buf + total - n, 0, (size_t)n)) break;  // NUL found
      if ((size_t)n < want) break;
    }
    if (total == 0) return "?";
    size_t len = strnlen(buf, total);
    std::string out;
    out.reserve(len);
    for (size_t i = 0; i < len; i++)
      out.push_back((buf[i] >= 0x20 && buf[i] < 0x7f) ? buf[i] : '.');
    if (len == total && total == sizeof(buf)) out += "...";
    return out;
  }

  uint16_t sockaddr_port(pid_t tid, uint64_t addr) {
    // sockaddr_in/in6 both keep the port in bytes 2-3, network order
    unsigned char sa[4];
    struct iovec local{sa, sizeof(sa)};
    struct iovec remote{(void*)addr, sizeof(sa)};
    if (process_vm_readv(tid, &local, 1, &remote, 1, 0) != sizeof(sa)) return 0;
    uint16_t fam = (uint16_t)(sa[0] | sa[1] << 8);
    if (fam != AF_INET && fam != AF_INET6) return 0;
    return (uint16_t)(sa[2] << 8 | sa[3]);
  }

  std::string fd_path(pid_t tid, int fd) {
    char link[64], target[256];
    snprintf(link, sizeof(link), "/proc/%d/fd/%d", tid, fd);
    ssize_t n = readlink(link, target, sizeof(target) - 1);
    if (n <= 0) return "";
    return std::string(target, (size_t)n);
  }

  uint64_t mntns_of(pid_t tid) {
    auto it = mntns_cache_.find(tid);
    if (it != mntns_cache_.end()) return it->second;
    char path[64], link[64];
    snprintf(path, sizeof(path), "/proc/%d/ns/mnt", tid);
    uint64_t ns = 0;
    ssize_t ln = readlink(path, link, sizeof(link) - 1);
    if (ln > 0) {
      link[ln] = 0;
      const char* lb = strchr(link, '[');
      if (lb) ns = strtoull(lb + 1, nullptr, 10);
    }
    mntns_cache_[tid] = ns;
    return ns;
  }

  void fill_identity(Event& ev, pid_t tid) {
    uint64_t saved = ev.key_hash;
    fill_proc_identity(ev, vocab_, (uint32_t)tid);
    if (saved) ev.key_hash = saved;
    if (!ev.mntns) ev.mntns = mntns_of(tid);
  }

  std::vector<std::string> argv_;
  pid_t attach_pid_ = 0;
  pid_t child_ = 0;
  uint64_t min_lat_us_ = 0;
  std::atomic<int> exit_status_{-1};
  std::unordered_map<pid_t, TaskState> tasks_;
  std::unordered_map<long, const char*> names_;
  std::unordered_map<std::string, const SysSpec*> spec_by_name_;
  std::unordered_map<pid_t, uint64_t> mntns_cache_;
};

}  // namespace ig
#endif  // __linux__
