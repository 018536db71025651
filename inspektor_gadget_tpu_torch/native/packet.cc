// PacketSniffSource — AF_PACKET capture with protocol parsing in C++.
//
// Role parity with the reference's network gadget family:
//  - networktracer engine: one refcounted BPF socket-filter attachment per
//    netns (pkg/gadgets/internal/networktracer/tracer.go:54-220). Here: one
//    AF_PACKET sniffer per netns, entered via setns (the rawsock/netnsenter
//    analogue, pkg/rawsock/rawsock.go:40-76, pkg/netnsenter).
//  - dns.c (qname walker in BPF, pkg/gadgets/trace/dns/tracer/bpf/dns.c):
//    the DNS header/qname parse runs here in C++.
//  - snisnoop.c TLS ClientHello SNI walk.
//  - graph.c connection-edge dedup (trace/network).
//  - socketenricher (sockets-map.bpf.c): a periodic /proc/net + /proc/*/fd
//    scan maps local ports → pid/comm so packet events self-enrich.

#ifdef __linux__
#include <arpa/inet.h>
#include <dirent.h>
#include <fcntl.h>
#include <linux/if_ether.h>
#include <linux/if_packet.h>
#include <net/if.h>
#include <sched.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cstring>
#include <map>
#include <set>
#include <string>
#include <unordered_map>

#include "ringbuf.h"

namespace ig {

enum PacketKindFilter : uint32_t {
  PKT_DNS = 1,
  PKT_SNI = 2,
  PKT_FLOW = 3,
};

// ---------------------------------------------------------------------------
// SocketEnricher: local port -> (pid, comm), refreshed periodically.
// ---------------------------------------------------------------------------

class SocketEnricher {
 public:
  void refresh() {
    // inode -> port from the CALLING THREAD's netns view: /proc/net is a
    // symlink to /proc/self/net (the main process's netns), which would
    // read the HOST socket table from a capture thread that setns()'d
    // into a container — /proc/thread-self/net follows the thread
    std::unordered_map<uint64_t, uint16_t> inode_port;
    for (const char* path : {"/proc/thread-self/net/tcp",
                             "/proc/thread-self/net/udp",
                             "/proc/thread-self/net/tcp6",
                             "/proc/thread-self/net/udp6"}) {
      FILE* f = fopen(path, "r");
      if (!f) continue;
      char line[512];
      if (!fgets(line, sizeof(line), f)) { fclose(f); continue; }
      while (fgets(line, sizeof(line), f)) {
        char local[128];
        unsigned long long inode = 0;
        if (sscanf(line, " %*u: %127s %*s %*x %*s %*s %*s %*u %*u %llu",
                   local, &inode) < 2 || !inode)
          continue;
        char* colon = strrchr(local, ':');
        if (!colon) continue;
        inode_port[inode] = (uint16_t)strtoul(colon + 1, nullptr, 16);
      }
      fclose(f);
    }
    // pid -> inodes from /proc/*/fd
    std::unordered_map<uint16_t, std::pair<uint32_t, std::string>> fresh;
    DIR* proc = opendir("/proc");
    if (!proc) return;
    struct dirent* de;
    while ((de = readdir(proc))) {
      char* end;
      unsigned long pid = strtoul(de->d_name, &end, 10);
      if (*end || !pid) continue;
      char fdpath[64];
      snprintf(fdpath, sizeof(fdpath), "/proc/%lu/fd", pid);
      DIR* fds = opendir(fdpath);
      if (!fds) continue;
      std::string comm;
      struct dirent* fd;
      while ((fd = readdir(fds))) {
        char link[384], target[64];
        snprintf(link, sizeof(link), "%s/%s", fdpath, fd->d_name);
        ssize_t n = readlink(link, target, sizeof(target) - 1);
        if (n <= 9 || strncmp(target, "socket:[", 8) != 0) continue;
        target[n] = 0;
        uint64_t inode = strtoull(target + 8, nullptr, 10);
        auto it = inode_port.find(inode);
        if (it == inode_port.end()) continue;
        if (comm.empty()) {
          char cpath[64], cbuf[64];
          snprintf(cpath, sizeof(cpath), "/proc/%lu/comm", pid);
          int cfd = open(cpath, O_RDONLY);
          if (cfd >= 0) {
            ssize_t cn = read(cfd, cbuf, sizeof(cbuf) - 1);
            close(cfd);
            if (cn > 0 && cbuf[cn - 1] == '\n') cn--;
            if (cn > 0) comm.assign(cbuf, (size_t)cn);
          }
        }
        fresh[it->second] = {(uint32_t)pid, comm};
      }
      closedir(fds);
    }
    closedir(proc);
    std::lock_guard<std::mutex> g(mu_);
    by_port_.swap(fresh);
  }

  bool lookup(uint16_t port, uint32_t* pid, char* comm, size_t cap) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = by_port_.find(port);
    if (it == by_port_.end()) return false;
    *pid = it->second.first;
    size_t n = it->second.second.size() < cap - 1 ? it->second.second.size()
                                                  : cap - 1;
    memcpy(comm, it->second.second.data(), n);
    comm[n] = 0;
    return true;
  }

 private:
  std::mutex mu_;
  std::unordered_map<uint16_t, std::pair<uint32_t, std::string>> by_port_;
};

// ---------------------------------------------------------------------------
// PacketSniffSource
// ---------------------------------------------------------------------------

class PacketSniffSource : public Source {
 public:
  PacketSniffSource(size_t ring_pow2, uint32_t filter, int netns_fd)
      : Source(ring_pow2), filter_(filter), netns_fd_(netns_fd) {}
  ~PacketSniffSource() override {
    stop();
    if (netns_fd_ >= 0) close(netns_fd_);
  }

 protected:
  void run() override {
    // rawsock analogue: enter the target netns before opening the socket.
    // ETH_P_ALL (not ETH_P_IP) so the IPv6 plane is visible too; the
    // version-nibble dispatch drops non-IP frames (beats the reference:
    // dns.c:18 is v4-only)
    if (netns_fd_ >= 0) setns(netns_fd_, CLONE_NEWNET);
    int sock = socket(AF_PACKET, SOCK_DGRAM | SOCK_NONBLOCK,
                      htons(ETH_P_ALL));
    if (sock < 0) return;
    // loopback delivers every local packet twice under ETH_P_ALL (the
    // OUTGOING copy + the rx); dropping the OUTGOING copy on lo alone
    // keeps single delivery there while still seeing container-originated
    // traffic leaving on real interfaces
    const unsigned int lo_ifindex = if_nametoindex("lo");
    uint64_t last_refresh = 0;
    unsigned char buf[2048];
    while (running_.load(std::memory_order_relaxed)) {
      uint64_t now = now_ns();
      if (now - last_refresh > 1000000000ull) {
        enricher_.refresh();
        last_refresh = now;
      }
      struct sockaddr_ll sll{};
      socklen_t slen = sizeof(sll);
      ssize_t len = recvfrom(sock, buf, sizeof(buf), 0,
                             (struct sockaddr*)&sll, &slen);
      if (len <= 0) {
        std::this_thread::sleep_for(std::chrono::milliseconds(2));
        continue;
      }
      if (sll.sll_pkttype == PACKET_OUTGOING &&
          (unsigned int)sll.sll_ifindex == lo_ifindex)
        continue;
      parse_ip(buf, (size_t)len);
    }
    close(sock);
  }

 private:
  void emit(uint64_t key_hash, const char* name, size_t name_len,
            uint32_t saddr, uint32_t daddr, uint16_t sport, uint16_t dport,
            uint32_t kind, uint32_t flags) {
    Event ev{};
    ev.ts_ns = now_ns();
    ev.kind = kind;
    ev.key_hash = key_hash;
    if (name && name_len) vocab_.put(key_hash, name, name_len);
    if (name) {
      size_t c = name_len < sizeof(ev.comm) - 1 ? name_len : sizeof(ev.comm) - 1;
      memcpy(ev.comm, name, c);
    }
    ev.aux1 = ((uint64_t)saddr << 32) | daddr;
    ev.aux2 = ((uint64_t)flags << 32) | ((uint32_t)sport << 16) | dport;
    char comm[32];
    uint32_t pid = 0;
    // socketenricher: prefer the local (source) port, then dest
    if (enricher_.lookup(sport, &pid, comm, sizeof(comm)) ||
        enricher_.lookup(dport, &pid, comm, sizeof(comm))) {
      ev.pid = pid;
    }
    ring_.push(ev);
  }

  void parse_ip(const unsigned char* p, size_t len) {
    uint8_t ver = len ? (p[0] >> 4) : 0;
    if (ver == 6) {
      parse_ip6(p, len);
      return;
    }
    if (len < 20 || ver != 4) return;
    size_t ihl = (size_t)(p[0] & 0xF) * 4;
    if (ihl < 20 || len < ihl + 8) return;  // corrupt IHL nibble
    uint8_t proto = p[9];
    uint32_t saddr = ntohl(*(const uint32_t*)(p + 12));
    uint32_t daddr = ntohl(*(const uint32_t*)(p + 16));
    dispatch_l4(proto, p + ihl, len - ihl, saddr, daddr, p + 12, p + 16, 4);
  }

  // IPv6: fixed 40-byte header + a bounded extension-header walk; the
  // 128-bit addresses are xor-folded into the 32-bit aux fields (display
  // names carry the full address via the vocab).
  void parse_ip6(const unsigned char* p, size_t len) {
    if (len < 40) return;
    uint8_t next = p[6];
    size_t off = 40;
    for (int hops = 0; hops < 4; hops++) {
      if (next == 0 || next == 43 || next == 60) {  // hbh/routing/dstopts
        if (off + 8 > len) return;
        uint8_t nn = p[off];
        off += ((size_t)p[off + 1] + 1) * 8;
        next = nn;
      } else if (next == 44) {  // fragment (fixed 8 bytes)
        if (off + 8 > len) return;
        if (p[off + 2] || (p[off + 3] & 0xF8)) return;  // non-first frag
        next = p[off];
        off += 8;
      } else {
        break;
      }
    }
    // a chain longer than the walk bound leaves an unconsumed extension
    // header — its bytes must not be parsed as L4 ports
    if (next == 0 || next == 43 || next == 44 || next == 60) return;
    if (off + 8 > len) return;
    auto fold = [](const unsigned char* a) {
      uint32_t w = 0;
      for (int i = 0; i < 4; i++) w ^= ntohl(*(const uint32_t*)(a + 4 * i));
      return w;
    };
    dispatch_l4(next, p + off, len - off, fold(p + 8), fold(p + 24), p + 8,
                p + 24, 16);
  }

  // Family-independent L4 dispatch: addr16/alen key the flow dedup (full
  // 128-bit tuples for v6); display names are formatted lazily, only for
  // NEW flows (never on the per-packet hot path).
  void dispatch_l4(uint8_t proto, const unsigned char* l4, size_t l4len,
                   uint32_t saddr, uint32_t daddr,
                   const unsigned char* saddr_raw,
                   const unsigned char* daddr_raw, size_t alen) {
    if (l4len < 8) return;
    uint16_t sport = ((uint16_t)l4[0] << 8) | l4[1];
    uint16_t dport = ((uint16_t)l4[2] << 8) | l4[3];
    if (filter_ == PKT_FLOW) {
      unsigned char tuple[16 * 2 + 5];
      memcpy(tuple, saddr_raw, alen);
      memcpy(tuple + alen, daddr_raw, alen);
      tuple[2 * alen] = (unsigned char)(sport >> 8);
      tuple[2 * alen + 1] = (unsigned char)sport;
      tuple[2 * alen + 2] = (unsigned char)(dport >> 8);
      tuple[2 * alen + 3] = (unsigned char)dport;
      tuple[2 * alen + 4] = proto;
      uint64_t h = fnv1a64((const char*)tuple, 2 * alen + 5);
      if (seen_flows_.insert(h).second) {
        char name[96];
        int n;
        if (alen == 16) {
          char dst[INET6_ADDRSTRLEN] = {0};
          inet_ntop(AF_INET6, daddr_raw, dst, sizeof(dst));
          n = snprintf(name, sizeof(name), "[%s]:%u", dst, dport);
        } else {
          n = snprintf(name, sizeof(name), "%u.%u.%u.%u:%u", daddr >> 24,
                       (daddr >> 16) & 0xFF, (daddr >> 8) & 0xFF,
                       daddr & 0xFF, dport);
        }
        emit(h, name, (size_t)n, saddr, daddr, sport, dport, EV_NET_GRAPH,
             proto);
      }
      return;
    }
    if (filter_ == PKT_DNS && proto == 17 && l4len > 8 + 12 &&
        (dport == 53 || sport == 53)) {
      parse_dns(l4 + 8, l4len - 8, saddr, daddr, sport, dport);
    } else if (filter_ == PKT_SNI && proto == 6 && l4len >= 20) {
      size_t doff = (size_t)(l4[12] >> 4) * 4;
      if (l4len > doff) parse_sni(l4 + doff, l4len - doff, saddr, daddr,
                                  sport, dport);
    }
  }

  // DNS qname walker (ref contract: dns.c:1-242 walks labels in BPF)
  void parse_dns(const unsigned char* d, size_t len, uint32_t saddr,
                 uint32_t daddr, uint16_t sport, uint16_t dport) {
    if (len < 12) return;
    uint16_t flags = ((uint16_t)d[2] << 8) | d[3];
    uint16_t qdcount = ((uint16_t)d[4] << 8) | d[5];
    if (qdcount == 0) return;
    char name[256];
    size_t ni = 0, i = 12;
    while (i < len && d[i] != 0 && ni < sizeof(name) - 2) {
      size_t lab = d[i++];
      if (lab > 63 || i + lab > len) return;  // compression/verifier guard
      if (ni) name[ni++] = '.';
      for (size_t j = 0; j < lab && ni < sizeof(name) - 1; j++)
        name[ni++] = (char)d[i + j];
      i += lab;
    }
    if (ni == 0) return;
    uint16_t qtype = (i + 4 < len) ? (((uint16_t)d[i + 1] << 8) | d[i + 2]) : 1;
    uint64_t h = fnv1a64(name, ni);
    // flags word (32-bit): full 16-bit qtype<<16 | QR bit (0x80) | rcode
    // nibble (decoded by network_family.py's native branch)
    emit(h, name, ni, saddr, daddr, sport, dport, EV_DNS,
         ((uint32_t)qtype << 16) | (uint32_t)(flags >> 8 & 0x80) |
             (uint32_t)(flags & 0x0F));
  }

  // TLS ClientHello SNI walk (ref contract: snisnoop.c)
  void parse_sni(const unsigned char* d, size_t len, uint32_t saddr,
                 uint32_t daddr, uint16_t sport, uint16_t dport) {
    // TLS record: type 22 (handshake), version, len; handshake type 1
    if (len < 9 + 34 || d[0] != 22 || d[5] != 1) return;
    size_t i = 9 + 34;  // record hdr(5) + hs hdr(4) + version(2) + random(32)
    if (i >= len) return;
    size_t sid = d[i]; i += 1 + sid;                       // session id
    if (i + 2 > len) return;
    size_t cs = ((size_t)d[i] << 8) | d[i + 1]; i += 2 + cs;  // ciphers
    if (i + 1 > len) return;
    size_t comp = d[i]; i += 1 + comp;                     // compression
    if (i + 2 > len) return;
    size_t extlen = ((size_t)d[i] << 8) | d[i + 1]; i += 2;
    size_t end = i + extlen < len ? i + extlen : len;
    while (i + 4 <= end) {
      uint16_t etype = ((uint16_t)d[i] << 8) | d[i + 1];
      size_t elen = ((size_t)d[i + 2] << 8) | d[i + 3];
      i += 4;
      if (etype == 0 && i + 5 <= end) {  // server_name
        size_t nlen = ((size_t)d[i + 3] << 8) | d[i + 4];
        if (i + 5 + nlen <= end && nlen > 0 && nlen < 256) {
          uint64_t h = fnv1a64((const char*)(d + i + 5), nlen);
          emit(h, (const char*)(d + i + 5), nlen, saddr, daddr, sport,
               dport, EV_SNI, 0);
          return;
        }
      }
      i += elen;
    }
  }

  uint32_t filter_;
  int netns_fd_;
  SocketEnricher enricher_;
  std::set<uint64_t> seen_flows_;
};

}  // namespace ig
#endif  // __linux__
