// Native host metrics sampler for the node agent.
//
// Reference parity: SURVEY.md §2.4 — "a thin C++ host agent ... replaces
// the psutil-based node agent where performance matters"
// (core/_private/service/cloudtik_node_agent.py samples with psutil; at
// 1 Hz on busy training hosts the Python sampler costs a surprising
// amount of the host CPU the input pipeline wants).  This binary reads
// /proc directly and emits one JSON object per line on stdout:
//
//   tik-host-agent --interval-ms 1000      # stream forever
//   tik-host-agent --once                  # one sample, then exit
//
// Field names match control/node_agent.py collect_node_metrics() so the
// Python and native samplers are drop-in interchangeable.

#include <signal.h>
#include <sys/prctl.h>
#include <sys/statvfs.h>
#include <unistd.h>

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <thread>

struct CpuTimes {
  uint64_t idle = 0;
  uint64_t total = 0;
};

static CpuTimes read_cpu_times() {
  std::ifstream f("/proc/stat");
  std::string cpu;
  uint64_t user = 0, nice = 0, system = 0, idle = 0, iowait = 0, irq = 0,
           softirq = 0, steal = 0;
  f >> cpu >> user >> nice >> system >> idle >> iowait >> irq >> softirq >>
      steal;
  CpuTimes t;
  t.idle = idle + iowait;
  t.total = user + nice + system + idle + iowait + irq + softirq + steal;
  return t;
}

static uint64_t meminfo_kb(const char* key) {
  std::ifstream f("/proc/meminfo");
  std::string line;
  size_t keylen = strlen(key);
  while (std::getline(f, line)) {
    if (line.compare(0, keylen, key) == 0) {
      std::istringstream ss(line.substr(keylen));
      uint64_t kb = 0;
      ss >> kb;
      return kb;
    }
  }
  return 0;
}

static void read_loadavg(double out[3]) {
  std::ifstream f("/proc/loadavg");
  f >> out[0] >> out[1] >> out[2];
}

static double now_unix() {
  return std::chrono::duration<double>(
             std::chrono::system_clock::now().time_since_epoch())
      .count();
}

static void emit_sample(const CpuTimes& prev, const CpuTimes& cur) {
  double cpu_percent = 0.0;
  uint64_t dt = cur.total - prev.total;
  if (dt > 0) {
    // iowait (folded into idle) is documented non-monotonic (proc(5));
    // clamp so the unsigned busy delta can't wrap
    uint64_t idle_d = cur.idle >= prev.idle ? cur.idle - prev.idle : 0;
    uint64_t busy = idle_d < dt ? dt - idle_d : 0;
    cpu_percent = 100.0 * static_cast<double>(busy) / dt;
  }
  uint64_t mem_total = meminfo_kb("MemTotal:") * 1024;
  uint64_t mem_avail = meminfo_kb("MemAvailable:") * 1024;
  double mem_percent =
      mem_total ? 100.0 * (1.0 - static_cast<double>(mem_avail) /
                                     static_cast<double>(mem_total))
                : 0.0;
  double load[3] = {0, 0, 0};
  read_loadavg(load);
  struct statvfs vfs;
  uint64_t disk_total = 0, disk_free = 0;
  double disk_percent = 0.0;
  if (statvfs("/", &vfs) == 0) {
    disk_total = static_cast<uint64_t>(vfs.f_blocks) * vfs.f_frsize;
    disk_free = static_cast<uint64_t>(vfs.f_bavail) * vfs.f_frsize;
    uint64_t used = disk_total - static_cast<uint64_t>(vfs.f_bfree) *
                                     vfs.f_frsize;
    uint64_t usable = used + disk_free;
    disk_percent =
        usable ? 100.0 * static_cast<double>(used) / usable : 0.0;
  }
  printf(
      "{\"time\": %.3f, \"cpu_percent\": %.1f, \"cpu_count\": %ld, "
      "\"load_avg\": [%.2f, %.2f, %.2f], \"memory_percent\": %.1f, "
      "\"memory_total\": %llu, \"memory_available\": %llu, "
      "\"disk_percent\": %.1f, \"disk_total\": %llu, \"disk_free\": "
      "%llu, \"native\": true}\n",
      now_unix(), cpu_percent, sysconf(_SC_NPROCESSORS_ONLN), load[0],
      load[1], load[2], mem_percent,
      static_cast<unsigned long long>(mem_total),
      static_cast<unsigned long long>(mem_avail), disk_percent,
      static_cast<unsigned long long>(disk_total),
      static_cast<unsigned long long>(disk_free));
  fflush(stdout);
}

int main(int argc, char** argv) {
  long interval_ms = 1000;
  long fate_parent = 0;
  bool once = false;
  for (int i = 1; i < argc; i++) {
    if (!strcmp(argv[i], "--interval-ms") && i + 1 < argc) {
      interval_ms = atol(argv[++i]);
    } else if (!strcmp(argv[i], "--fate-parent") && i + 1 < argc) {
      fate_parent = atol(argv[++i]);
    } else if (!strcmp(argv[i], "--once")) {
      once = true;
    } else {
      fprintf(stderr,
              "usage: %s [--interval-ms N] [--once] [--fate-parent PID]\n",
              argv[0]);
      return 2;
    }
  }
  if (fate_parent > 0) {
    // in-binary fate-sharing (see state_server.cpp): lets the launcher
    // avoid preexec_fn, so posix_spawn works under multithreaded JAX
    prctl(PR_SET_PDEATHSIG, SIGTERM);
    if (getppid() != fate_parent) return 0;
  }
  CpuTimes prev = read_cpu_times();
  if (once) {
    std::this_thread::sleep_for(std::chrono::milliseconds(100));
    emit_sample(prev, read_cpu_times());
    return 0;
  }
  while (true) {
    std::this_thread::sleep_for(std::chrono::milliseconds(interval_ms));
    CpuTimes cur = read_cpu_times();
    emit_sample(prev, cur);
    prev = cur;
  }
}
