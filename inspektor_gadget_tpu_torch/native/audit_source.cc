// AuditSource — host-wide capability/seccomp observation via NETLINK_AUDIT.
//
// Reference contract: capable.bpf.c:1-250 (kprobe cap_capable, every
// capability check on the host) and audit-seccomp.bpf.c:1-65 (kprobe
// audit_seccomp, every seccomp verdict on the host). Without kprobes the
// kernel still exports both facts through the audit subsystem:
//  - seccomp kills emit AUDIT_SECCOMP (1326) records whenever auditing is
//    enabled — no rules needed;
//  - capability denials are observed from syscall outcomes: two audit exit
//    rules (exit==-EPERM, exit==-EACCES, keyed "igtpu" so only our rules
//    are removed at teardown) make every failed privileged syscall emit an
//    AUDIT_SYSCALL (1300) record, which maps to the implied capability via
//    the same syscall→capability table the per-target ptrace window uses —
//    identical verdict-from-outcome semantics, but host-wide.
//  - LSM denials (AUDIT_AVC 1400) carrying "capability=N" map directly.
//
// Records are read from the AUDIT_NLGRP_READLOG multicast group (kernel
// >= 3.16, CAP_AUDIT_READ) so a live auditd keeps working untouched. When
// auditing is disabled and no daemon owns it, the source enables it for
// the capture's lifetime and restores the prior state on teardown.

#ifdef __linux__
#include <fcntl.h>
#include <poll.h>
#include <unistd.h>

#include <linux/audit.h>
#include <linux/netlink.h>
#include <sys/socket.h>

#include <cstring>
#include <string>
#include <unordered_map>

#include "ringbuf.h"

namespace ig {

namespace {

constexpr char kRuleKey[] = "igtpu";

#if defined(__x86_64__)
constexpr const char* kNativeArch = "c000003e";  // AUDIT_ARCH_X86_64
#elif defined(__aarch64__)
constexpr const char* kNativeArch = "c00000b7";  // AUDIT_ARCH_AARCH64
#else
constexpr const char* kNativeArch = "";
#endif

// "key=value" field extraction from an audit record body. Values are either
// bare tokens or double-quoted strings (comm="x").
bool audit_field(const std::string& body, const char* key, std::string& out) {
  std::string needle = std::string(key) + "=";
  size_t pos = 0;
  while ((pos = body.find(needle, pos)) != std::string::npos) {
    // must start a field (preceded by space or start)
    if (pos != 0 && body[pos - 1] != ' ') {
      pos += needle.size();
      continue;
    }
    size_t v = pos + needle.size();
    if (v < body.size() && body[v] == '"') {
      size_t end = body.find('"', v + 1);
      if (end == std::string::npos) return false;
      out = body.substr(v + 1, end - v - 1);
    } else {
      size_t end = body.find(' ', v);
      out = body.substr(v, end == std::string::npos ? end : end - v);
    }
    return true;
  }
  return false;
}

long audit_field_long(const std::string& body, const char* key, long dflt) {
  std::string v;
  if (!audit_field(body, key, v)) return dflt;
  return strtol(v.c_str(), nullptr, 10);
}

}  // namespace

class AuditSource : public Source {
 public:
  AuditSource(size_t ring_pow2, const std::string& cfg) : Source(ring_pow2) {
    eperm_rules_ = cfg_get(cfg, "eperm_rules", "0") == "1";
  }
  ~AuditSource() override { stop(); }

  // Window exists when the audit netlink family answers a status query and
  // the READLOG multicast group is bindable (CAP_AUDIT_READ).
  static bool supported() {
    int rx = socket(AF_NETLINK, SOCK_RAW | SOCK_CLOEXEC, NETLINK_AUDIT);
    if (rx < 0) return false;
    struct sockaddr_nl sa{};
    sa.nl_family = AF_NETLINK;
    sa.nl_groups = AUDIT_NLGRP_READLOG;
    bool ok = bind(rx, (struct sockaddr*)&sa, sizeof(sa)) == 0;
    close(rx);
    if (!ok) return false;
    uint32_t enabled, pid;
    return query_status(enabled, pid);
  }

 protected:
  void run() override {
    // control plane state: remember what we changed, restore on exit
    uint32_t enabled = 0, daemon_pid = 0;
    if (!query_status(enabled, daemon_pid)) return;
    bool we_enabled = false;
    if (!enabled && daemon_pid == 0) {
      we_enabled = set_enabled(1);
    }
    int rx = socket(AF_NETLINK, SOCK_RAW | SOCK_CLOEXEC, NETLINK_AUDIT);
    if (rx < 0) {
      if (we_enabled) set_enabled(0);
      return;
    }
    struct sockaddr_nl sa{};
    sa.nl_family = AF_NETLINK;
    sa.nl_groups = AUDIT_NLGRP_READLOG;
    if (bind(rx, (struct sockaddr*)&sa, sizeof(sa)) != 0) {
      close(rx);
      if (we_enabled) set_enabled(0);
      return;
    }
    // grow the rx buffer: a match-all-EPERM rule can burst
    int rcvbuf = 4 << 20;
    setsockopt(rx, SOL_SOCKET, SO_RCVBUF, &rcvbuf, sizeof(rcvbuf));
    bool rules_added = false;
    if (eperm_rules_) {
      rules_added = rule_op(AUDIT_ADD_RULE, -1 /*EPERM*/);
      rules_added = rule_op(AUDIT_ADD_RULE, -13 /*EACCES*/) || rules_added;
    }
    struct pollfd pfd{rx, POLLIN, 0};
    char buf[65536];
    while (running_.load(std::memory_order_relaxed)) {
      if (poll(&pfd, 1, 100) <= 0) continue;
      ssize_t len = recv(rx, buf, sizeof(buf), 0);
      if (len <= 0) continue;
      // kauditd sends ONE record per datagram with nlmsg_len == datagram
      // size, NOT 4-byte aligned — NLMSG_NEXT's aligned subtraction goes
      // negative, so the remainder must stay signed (a size_t cast would
      // wrap and "validate" garbage past the record)
      int rem = (int)len;
      for (struct nlmsghdr* h = (struct nlmsghdr*)buf; NLMSG_OK(h, rem);
           h = NLMSG_NEXT(h, rem)) {
        size_t blen = h->nlmsg_len - NLMSG_HDRLEN;
        std::string body((char*)NLMSG_DATA(h), blen);
        parse_record(h->nlmsg_type, body);
      }
    }
    if (rules_added) {
      rule_op(AUDIT_DEL_RULE, -1);
      rule_op(AUDIT_DEL_RULE, -13);
    }
    if (we_enabled) set_enabled(0);
    close(rx);
  }

 private:
  // ---- record parsing -----------------------------------------------------

  void parse_record(uint16_t type, const std::string& body) {
    if (type == AUDIT_SECCOMP) {
      parse_seccomp(body);
    } else if (type == AUDIT_SYSCALL) {
      parse_syscall(body);
    } else if (type == AUDIT_AVC) {
      parse_avc(body);
    }
  }

  void parse_seccomp(const std::string& body) {
    if (kNativeArch[0]) {
      std::string arch;
      if (audit_field(body, "arch", arch) && arch != kNativeArch) return;
    }
    Event ev{};
    ev.ts_ns = now_ns();
    ev.kind = EV_AUDIT;
    ev.pid = (uint32_t)audit_field_long(body, "pid", 0);
    ev.uid = (uint32_t)audit_field_long(body, "uid", 0);
    ev.aux1 = (uint64_t)audit_field_long(body, "syscall", -1);
    uint64_t sig = (uint64_t)audit_field_long(body, "sig", 0);
    std::string code;
    uint64_t code_v = 0;
    if (audit_field(body, "code", code))
      code_v = strtoull(code.c_str(), nullptr, 16);
    ev.aux2 = (sig << 32) | (code_v & 0xFFFFFFFF);
    fill_from_record(ev, body);
    emit(ev);
  }

  void parse_syscall(const std::string& body) {
    // only the records our rules generated: a host auditd's own rules may
    // stream successes and unrelated syscalls here too
    std::string key, success;
    if (!audit_field(body, "key", key) || key != kRuleKey) return;
    if (audit_field(body, "success", success) && success == "yes") return;
    if (kNativeArch[0]) {
      std::string arch;
      if (audit_field(body, "arch", arch) && arch != kNativeArch) return;
    }
    long nr = audit_field_long(body, "syscall", -1);
    int cap = cap_for_syscall_nr(nr);
    if (cap < 0) return;  // not a capability-implying syscall
    Event ev{};
    ev.ts_ns = now_ns();
    ev.kind = EV_CAPABILITY;
    ev.pid = (uint32_t)audit_field_long(body, "pid", 0);
    ev.uid = (uint32_t)audit_field_long(body, "uid", 0);
    ev.aux1 = 0;  // denial observed from the failed outcome
    ev.aux2 = (uint64_t)cap;
    fill_from_record(ev, body);
    emit(ev);
  }

  void parse_avc(const std::string& body) {
    // LSM denial with an explicit capability number (SELinux/AppArmor)
    std::string capv;
    if (!audit_field(body, "capability", capv)) return;
    Event ev{};
    ev.ts_ns = now_ns();
    ev.kind = EV_CAPABILITY;
    ev.pid = (uint32_t)audit_field_long(body, "pid", 0);
    ev.aux1 = 0;
    ev.aux2 = strtoull(capv.c_str(), nullptr, 10);
    fill_from_record(ev, body);
    emit(ev);
  }

  void fill_from_record(Event& ev, const std::string& body) {
    // the record's own comm beats a /proc lookup: the task is often
    // already dead (seccomp kill) by the time we parse
    std::string comm;
    if (audit_field(body, "comm", comm) && !comm.empty()) {
      size_t c = comm.size() < sizeof(ev.comm) - 1 ? comm.size()
                                                   : sizeof(ev.comm) - 1;
      memcpy(ev.comm, comm.data(), c);
      ev.key_hash = fnv1a64(comm.data(), comm.size());
      vocab_.put(ev.key_hash, comm.data(), comm.size());
    }
    // mntns for the container filter; the victim may already be gone
    char path[64], link[64];
    snprintf(path, sizeof(path), "/proc/%u/ns/mnt", ev.pid);
    ssize_t ln = readlink(path, link, sizeof(link) - 1);
    if (ln > 0) {
      link[ln] = 0;
      const char* lb = strchr(link, '[');
      if (lb) ev.mntns = strtoull(lb + 1, nullptr, 10);
    }
  }

  // syscall nr → implied capability, from the ptrace window's tables
  // (kSyscallNames for nr→name, kSpecs for name→cap) so both flavours
  // report identical capability semantics.
  static int cap_for_syscall_nr(long nr) {
    static const std::unordered_map<long, int>* idx = [] {
      auto* m = new std::unordered_map<long, int>();
      for (const SyscallName* s = kSyscallNames; s->name; s++) {
        for (const SysSpec* sp = kSpecs; sp->name; sp++) {
          if (strcmp(sp->name, s->name) == 0) {
            if (sp->cap >= 0) (*m)[s->nr] = sp->cap;
            break;
          }
        }
      }
      return m;
    }();
    auto it = idx->find(nr);
    return it == idx->end() ? -1 : it->second;
  }

  // ---- audit control plane (unicast request/ack) --------------------------

  static int ctl_socket() {
    int sd = socket(AF_NETLINK, SOCK_RAW | SOCK_CLOEXEC, NETLINK_AUDIT);
    if (sd < 0) return -1;
    struct sockaddr_nl sa{};
    sa.nl_family = AF_NETLINK;
    if (bind(sd, (struct sockaddr*)&sa, sizeof(sa)) != 0) {
      close(sd);
      return -1;
    }
    return sd;
  }

  static bool ctl_request(uint16_t type, const void* payload, size_t plen,
                          char* reply, size_t rcap, uint16_t* rtype) {
    int sd = ctl_socket();
    if (sd < 0) return false;
    // audit_rule_data alone is 1040 bytes (4 × 64-slot u32 arrays) before
    // the filter-key string, so the frame must hold well over 1 KiB
    char msg[NLMSG_HDRLEN + 2048];
    if (plen > 2048) {
      close(sd);
      return false;
    }
    auto* nlh = (struct nlmsghdr*)msg;
    memset(msg, 0, sizeof(msg));
    nlh->nlmsg_len = NLMSG_LENGTH(plen);
    nlh->nlmsg_type = type;
    nlh->nlmsg_flags = NLM_F_REQUEST | (reply ? 0 : NLM_F_ACK);
    nlh->nlmsg_seq = 1;
    if (plen) memcpy(NLMSG_DATA(nlh), payload, plen);
    bool ok = send(sd, msg, nlh->nlmsg_len, 0) == (ssize_t)nlh->nlmsg_len;
    if (ok) {
      struct pollfd pfd{sd, POLLIN, 0};
      if (poll(&pfd, 1, 500) > 0) {
        char rbuf[8192];
        ssize_t len = recv(sd, rbuf, sizeof(rbuf), 0);
        if (len > 0) {
          auto* rh = (struct nlmsghdr*)rbuf;
          if (rtype) *rtype = rh->nlmsg_type;
          if (rh->nlmsg_type == NLMSG_ERROR) {
            int err = *(int*)NLMSG_DATA(rh);
            ok = err == 0;
          }
          if (reply && NLMSG_OK(rh, (size_t)len)) {
            size_t blen = rh->nlmsg_len - NLMSG_HDRLEN;
            if (blen > rcap) blen = rcap;
            memcpy(reply, NLMSG_DATA(rh), blen);
          }
        } else {
          ok = false;
        }
      } else {
        ok = false;
      }
    }
    close(sd);
    return ok;
  }

  static bool query_status(uint32_t& enabled, uint32_t& pid) {
    char reply[sizeof(struct audit_status)] = {};
    uint16_t rtype = 0;
    if (!ctl_request(AUDIT_GET, nullptr, 0, reply, sizeof(reply), &rtype))
      return false;
    if (rtype != AUDIT_GET) return false;
    auto* st = (struct audit_status*)reply;
    enabled = st->enabled;
    pid = st->pid;
    return true;
  }

  static bool set_enabled(uint32_t v) {
    struct audit_status st{};
    st.mask = AUDIT_STATUS_ENABLED;
    st.enabled = v;
    return ctl_request(AUDIT_SET, &st, sizeof(st), nullptr, 0, nullptr);
  }

  // Add/remove one "exit filter, always, all syscalls, exit==<errno>" rule
  // tagged with our filter key so teardown removes exactly what we added.
  static bool rule_op(uint16_t op, int exit_value) {
    size_t keylen = strlen(kRuleKey);
    size_t plen = sizeof(struct audit_rule_data) + keylen;
    std::string storage(plen, '\0');
    auto* r = (struct audit_rule_data*)storage.data();
    r->flags = AUDIT_FILTER_EXIT;
    r->action = AUDIT_ALWAYS;
    for (int i = 0; i < AUDIT_BITMASK_SIZE; i++) r->mask[i] = 0xFFFFFFFF;
    r->field_count = 2;
    r->fields[0] = AUDIT_EXIT;
    r->values[0] = (uint32_t)exit_value;
    r->fieldflags[0] = AUDIT_EQUAL;
    r->fields[1] = AUDIT_FILTERKEY;
    r->values[1] = (uint32_t)keylen;
    r->fieldflags[1] = AUDIT_EQUAL;
    r->buflen = (uint32_t)keylen;
    memcpy(r->buf, kRuleKey, keylen);
    return ctl_request(op, r, plen, nullptr, 0, nullptr);
  }

  bool eperm_rules_ = false;
};

}  // namespace ig
#endif  // __linux__
