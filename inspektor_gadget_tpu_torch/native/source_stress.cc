// TSAN stress for the capture sources: concurrent create/start/pop/
// set_filter/stats/stop/destroy across threads — the cross-thread
// surfaces the Python bridge exercises (run loop pops, tracer-collection
// filter updates, top/self stats enumeration, teardown). Built and run by
// inspektor_gadget_tpu_torch/native.py StressHarness("source_stress",
// tsan=True) (root: the real kernel windows open live sockets/marks).
// Complements ring_stress.cc, which hammers the SPSC ring contract itself.
#include "api.cc"
#include <atomic>
#include <chrono>
#include <thread>
#include <vector>
#include <cstdio>

int main() {
  // ig_source_start cannot report window failures (they happen inside
  // the capture thread), so gate on the one precondition every kernel
  // window shares — a green run without root would exercise nothing
  if (geteuid() != 0) {
    fprintf(stderr, "needs root: the kernel windows won't open and the "
                    "emit/pop races would never run\n");
    return 1;
  }
  const uint32_t kinds[] = {IG_SRC_TCP_BYTES,  IG_SRC_AUDIT,
                            IG_SRC_CAP_TRACE,  IG_SRC_FS_TRACE,
                            IG_SRC_SOCK_STATE, IG_SRC_SIG_TRACE,
                            IG_SRC_BLK_TRACE,  IG_SRC_FANOTIFY_OPEN};
  for (int round = 0; round < 3; round++) {
    std::vector<uint64_t> hs;
    int started = 0;
    for (uint32_t k : kinds) {
      uint64_t h = ig_source_create_cfg(k, "interval_ms=100\x1fmin_lat_us=1000", 14);
      if (!h) {
        fprintf(stderr, "kind %u: create failed\n", k);
        continue;
      }
      ig_source_start(h);
      started++;
      hs.push_back(h);
    }
    if (started < (int)(sizeof(kinds) / sizeof(kinds[0]))) {
      fprintf(stderr, "only %d/%zu sources created — races not fully "
                      "exercised\n",
              started, sizeof(kinds) / sizeof(kinds[0]));
      return 1;
    }
    std::atomic<bool> stop{false};
    // poller thread per source
    std::vector<std::thread> ts;
    for (uint64_t h : hs)
      ts.emplace_back([h, &stop] {
        uint64_t ts_[256], kh[256], a1[256], a2[256], mn[256];
        uint32_t pid[256], ppid[256], uid[256], kind[256];
        char comm[2048];
        while (!stop.load())
          ig_source_pop_batch(h, 256, ts_, kh, a1, a2, mn, pid, ppid, uid,
                              kind, comm);
      });
    // filter-churn thread (tracer-collection updates)
    ts.emplace_back([&hs, &stop] {
      uint64_t ids[4] = {1, 2, 3, 4};
      while (!stop.load())
        for (uint64_t h : hs) {
          ig_source_set_filter(h, ids, 4);
          ig_source_set_filter(h, nullptr, 0);
        }
    });
    // stats thread (top/self enumeration)
    ts.emplace_back([&stop] {
      uint64_t ids[64], prod[64], cons[64], drops[64], filt[64], rl[64],
          rc[64], cpu[64];
      uint32_t kk[64];
      while (!stop.load())
        ig_sources_stats(ids, kk, prod, cons, drops, filt, rl, rc, cpu, 64);
    });
    std::this_thread::sleep_for(std::chrono::milliseconds(1200));
    stop.store(true);
    for (auto& t : ts) t.join();
    for (uint64_t h : hs) { ig_source_stop(h); ig_source_destroy(h); }
    printf("round %d ok (%d sources live)\n", round, started);
  }
  printf("source stress OK\n");
  return 0;
}
