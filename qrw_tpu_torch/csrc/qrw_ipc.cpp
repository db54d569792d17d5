// qrw_ipc: shared-memory seqlock mailboxes + real-time pacing.
//
// Native runtime layer replacing the reference's Python multiprocessing
// IPC (scripts/MPC_Wrapper.py:52-57,150-225 — Value flags + flat Array
// mailboxes with polling and no memory ordering; scripts/
// gamepadClient.py:18-49; the busy-wait pacing of scripts/
// PyBulletSimulator.py:702-706). Differences by design:
//
//   * a versioned seqlock per mailbox instead of the reference's racy
//     newData/newResult boolean pair: writers never block, readers
//     retry on a torn read, and a monotonically increasing sequence
//     lets consumers detect both "new data" and missed updates;
//   * POSIX shared memory (shm_open) so mailboxes survive process
//     respawn — no orphaned-worker pkill dance (reference README.md:61);
//   * absolute-deadline pacing (clock_nanosleep TIMER_ABSTIME) with a
//     short adaptive spin tail instead of a pure busy-wait, giving the
//     2 ms / 500 Hz loop (src/config_solo12.yaml:6) low jitter without
//     burning a full core.
//
// Exposed as a plain C ABI consumed from Python via ctypes
// (qrw_tpu/runtime/ipc.py).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct MailboxHeader {
  std::atomic<uint64_t> seq;   // even: stable; odd: write in progress
  uint64_t payload_bytes;
};

struct Mailbox {
  MailboxHeader* hdr;
  uint8_t* payload;
  size_t map_bytes;
  int owner;  // created (vs opened) — owner unlinks on destroy
  char name[256];
};

inline uint8_t* payload_of(MailboxHeader* h) {
  return reinterpret_cast<uint8_t*>(h) + sizeof(MailboxHeader);
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------
// Mailboxes
// ---------------------------------------------------------------------

void* qrw_mailbox_create(const char* name, uint64_t payload_bytes,
                         int create) {
  size_t total = sizeof(MailboxHeader) + payload_bytes;
  int flags = create ? (O_RDWR | O_CREAT) : O_RDWR;
  int fd = shm_open(name, flags, 0600);
  if (fd < 0) return nullptr;
  if (create && ftruncate(fd, static_cast<off_t>(total)) != 0) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED,
                   fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;

  auto* mb = new Mailbox;
  mb->hdr = static_cast<MailboxHeader*>(mem);
  mb->payload = payload_of(mb->hdr);
  mb->map_bytes = total;
  mb->owner = create;
  std::strncpy(mb->name, name, sizeof(mb->name) - 1);
  mb->name[sizeof(mb->name) - 1] = '\0';
  if (create) {
    mb->hdr->seq.store(0, std::memory_order_relaxed);
    mb->hdr->payload_bytes = payload_bytes;
  }
  return mb;
}

void qrw_mailbox_destroy(void* handle) {
  auto* mb = static_cast<Mailbox*>(handle);
  if (!mb) return;
  munmap(mb->hdr, mb->map_bytes);
  if (mb->owner) shm_unlink(mb->name);
  delete mb;
}

// Publish a new payload; returns the new sequence number (even).
uint64_t qrw_mailbox_write(void* handle, const void* data,
                           uint64_t nbytes) {
  auto* mb = static_cast<Mailbox*>(handle);
  uint64_t s = mb->hdr->seq.load(std::memory_order_relaxed);
  mb->hdr->seq.store(s + 1, std::memory_order_release);  // mark dirty
  std::atomic_thread_fence(std::memory_order_release);
  std::memcpy(mb->payload, data, nbytes);
  std::atomic_thread_fence(std::memory_order_release);
  mb->hdr->seq.store(s + 2, std::memory_order_release);
  return s + 2;
}

// Read the latest payload. Returns the sequence of the copy (even), or
// `last_seen` when no newer stable data is available. Retries torn reads.
uint64_t qrw_mailbox_read(void* handle, void* out, uint64_t nbytes,
                          uint64_t last_seen) {
  auto* mb = static_cast<Mailbox*>(handle);
  for (int attempt = 0; attempt < 1000; ++attempt) {
    uint64_t s1 = mb->hdr->seq.load(std::memory_order_acquire);
    if (s1 == last_seen || (s1 & 1)) {
      if (s1 == last_seen) return last_seen;  // nothing new
      continue;                               // writer active, retry
    }
    std::atomic_thread_fence(std::memory_order_acquire);
    std::memcpy(out, mb->payload, nbytes);
    std::atomic_thread_fence(std::memory_order_acquire);
    uint64_t s2 = mb->hdr->seq.load(std::memory_order_acquire);
    if (s1 == s2) return s2;  // consistent snapshot
  }
  return last_seen;  // writer livelock guard (should not happen)
}

uint64_t qrw_mailbox_seq(void* handle) {
  return static_cast<Mailbox*>(handle)->hdr->seq.load(
      std::memory_order_acquire);
}

// ---------------------------------------------------------------------
// Real-time pacing
// ---------------------------------------------------------------------

struct Pacer {
  struct timespec next;
  long period_ns;
  long spin_ns;      // sleep until deadline - spin_ns, then spin
  uint64_t ticks;
  uint64_t overruns;
  long last_jitter_ns;
};

static inline void ts_add(struct timespec* t, long ns) {
  t->tv_nsec += ns;
  while (t->tv_nsec >= 1000000000L) {
    t->tv_nsec -= 1000000000L;
    t->tv_sec += 1;
  }
}

static inline long ts_diff_ns(const struct timespec* a,
                              const struct timespec* b) {
  return (a->tv_sec - b->tv_sec) * 1000000000L +
         (a->tv_nsec - b->tv_nsec);
}

void* qrw_pacer_create(long period_ns, long spin_ns) {
  auto* p = new Pacer;
  clock_gettime(CLOCK_MONOTONIC, &p->next);
  p->period_ns = period_ns;
  p->spin_ns = spin_ns;
  p->ticks = 0;
  p->overruns = 0;
  p->last_jitter_ns = 0;
  return p;
}

void qrw_pacer_destroy(void* handle) { delete static_cast<Pacer*>(handle); }

// Block until the next period boundary (absolute deadline). Returns the
// signed lateness in ns (negative = woke early within spin window).
long qrw_pacer_wait(void* handle) {
  auto* p = static_cast<Pacer*>(handle);
  ts_add(&p->next, p->period_ns);

  struct timespec coarse = p->next;
  long spin = p->spin_ns;
  coarse.tv_nsec -= spin;
  while (coarse.tv_nsec < 0) {
    coarse.tv_nsec += 1000000000L;
    coarse.tv_sec -= 1;
  }
  clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &coarse, nullptr);

  struct timespec now;
  clock_gettime(CLOCK_MONOTONIC, &now);
  while (ts_diff_ns(&now, &p->next) < 0) {
    clock_gettime(CLOCK_MONOTONIC, &now);  // short spin tail
  }
  long late = ts_diff_ns(&now, &p->next);
  p->last_jitter_ns = late;
  p->ticks += 1;
  if (late > p->period_ns) {
    p->overruns += 1;
    p->next = now;  // resync after a gross overrun
  }
  return late;
}

uint64_t qrw_pacer_overruns(void* handle) {
  return static_cast<Pacer*>(handle)->overruns;
}

}  // extern "C"
