// Native runtime for the 1 kHz control host (C++17, no deps).
//
// The reference runs its centroidal MPC in a second process and hands the
// latest completed force plan to the 1 kHz whole-body loop through shared
// memory with a "new result" flag — one-solve-stale semantics (SURVEY.md §2.2
// "MPC async wrapper", §3.2).  This library is the native rebuild of that
// runtime layer: the hard-real-time pieces that must NOT live in Python (the
// compute itself lives on the accelerator; see mpctsid_tpu/cascade for the fused
// device-side cascade used for batched simulation).
//
//   * PlanBuffer   — wait-free single-producer/single-consumer double buffer
//                    with a seqlock per slot: the producer (MPC/device thread)
//                    publishes plans, the 1 kHz consumer always reads the
//                    latest COMPLETED plan without locks or tearing.
//   * RtExecutor   — monotonic-clock periodic executor: drives a callback at a
//                    fixed period (absolute-deadline scheduling, no drift) and
//                    records jitter / overrun statistics.
//   * TelemetryRing — wait-free SPSC ring of fixed-size float records: the
//                    1 kHz loop pushes one record per tick with no allocation,
//                    locks, or syscalls; a logger thread drains batches.  The
//                    producer NEVER blocks: a full ring drops the record and
//                    counts it (hard-RT choice — losing a telemetry sample
//                    beats missing a control deadline).  Replaces the
//                    reference's preallocated-numpy-array logger (SURVEY.md
//                    §5.5) for the host deployment path.
//
// Exposed through a C ABI for ctypes (mpctsid_tpu/native/runtime.py) — the
// environment has no pybind11; ctypes needs no build-time Python deps.

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <thread>

namespace {

using Clock = std::chrono::steady_clock;

struct PlanBuffer {
  explicit PlanBuffer(int n) : n_(n) {
    for (int s = 0; s < 2; ++s) data_[s] = new float[n]();
    seq_[0].store(0);
    seq_[1].store(0);
    latest_.store(-1);
  }
  ~PlanBuffer() {
    delete[] data_[0];
    delete[] data_[1];
  }

  // producer: write into the slot NOT currently marked latest, then flip.
  void publish(const float* src, int64_t plan_id) {
    int slot = 1 - (latest_.load(std::memory_order_relaxed) & 1);
    seq_[slot].fetch_add(1, std::memory_order_acq_rel);  // odd: writing
    std::memcpy(data_[slot], src, sizeof(float) * n_);
    id_[slot] = plan_id;
    seq_[slot].fetch_add(1, std::memory_order_acq_rel);  // even: done
    latest_.store(slot, std::memory_order_release);
  }

  // consumer: read the latest completed plan; retries on torn reads.
  // Returns the plan id, or -1 if nothing has been published yet.
  int64_t read_latest(float* dst) const {
    int slot = latest_.load(std::memory_order_acquire);
    if (slot < 0) return -1;
    for (;;) {
      uint32_t s0 = seq_[slot].load(std::memory_order_acquire);
      if (s0 & 1u) {  // writer mid-flight on this slot: fall back to other
        slot = 1 - slot;
        continue;
      }
      std::memcpy(dst, data_[slot], sizeof(float) * n_);
      int64_t id = id_[slot];
      uint32_t s1 = seq_[slot].load(std::memory_order_acquire);
      if (s0 == s1) return id;
    }
  }

  int n_;
  float* data_[2];
  int64_t id_[2] = {-1, -1};
  mutable std::atomic<uint32_t> seq_[2];
  std::atomic<int> latest_;
};

struct RtStats {
  int64_t ticks = 0;
  int64_t overruns = 0;
  double max_jitter_ns = 0.0;
  double sum_jitter_ns = 0.0;
};

struct RtExecutor {
  explicit RtExecutor(int64_t period_ns) : period_ns_(period_ns) {}

  // Run `ticks` iterations of cb(user, tick_index) at the fixed period.
  // Absolute deadlines: deadline_k = t0 + k * period (no cumulative drift).
  void run(int64_t ticks, void (*cb)(void*, int64_t), void* user) {
    auto t0 = Clock::now();
    for (int64_t k = 0; k < ticks; ++k) {
      auto deadline = t0 + std::chrono::nanoseconds(period_ns_ * k);
      std::this_thread::sleep_until(deadline);
      auto now = Clock::now();
      double jitter =
          std::chrono::duration<double, std::nano>(now - deadline).count();
      if (jitter < 0) jitter = 0;
      stats_.max_jitter_ns = jitter > stats_.max_jitter_ns
                                 ? jitter
                                 : stats_.max_jitter_ns;
      stats_.sum_jitter_ns += jitter;
      cb(user, k);
      auto end = Clock::now();
      if (end > deadline + std::chrono::nanoseconds(period_ns_))
        ++stats_.overruns;
      ++stats_.ticks;
    }
  }

  int64_t period_ns_;
  RtStats stats_;
};

struct TelemetryRing {
  // capacity is rounded up to a power of two so index masking is branch-free.
  TelemetryRing(int record_len, int capacity) : len_(record_len) {
    cap_ = 1;
    while (cap_ < capacity) cap_ <<= 1;
    data_ = new float[static_cast<size_t>(cap_) * len_];
    head_.store(0);
    tail_.store(0);
    dropped_.store(0);
  }
  ~TelemetryRing() { delete[] data_; }

  // producer (1 kHz loop): wait-free, never blocks; false = dropped (full).
  bool push(const float* rec) {
    uint64_t h = head_.load(std::memory_order_relaxed);
    uint64_t t = tail_.load(std::memory_order_acquire);
    if (h - t >= static_cast<uint64_t>(cap_)) {
      dropped_.fetch_add(1, std::memory_order_relaxed);
      return false;
    }
    std::memcpy(data_ + (h & (cap_ - 1)) * len_, rec,
                sizeof(float) * len_);
    head_.store(h + 1, std::memory_order_release);
    return true;
  }

  // consumer (logger thread): drain up to max_records; returns count.
  int pop(float* dst, int max_records) {
    uint64_t t = tail_.load(std::memory_order_relaxed);
    uint64_t h = head_.load(std::memory_order_acquire);
    int n = static_cast<int>(h - t);
    if (n > max_records) n = max_records;
    for (int i = 0; i < n; ++i) {
      std::memcpy(dst + static_cast<size_t>(i) * len_,
                  data_ + ((t + i) & (cap_ - 1)) * len_,
                  sizeof(float) * len_);
    }
    tail_.store(t + n, std::memory_order_release);
    return n;
  }

  int len_;
  int cap_;
  float* data_;
  std::atomic<uint64_t> head_, tail_, dropped_;
};

}  // namespace

extern "C" {

void* telemetry_ring_create(int record_len, int capacity) {
  return new TelemetryRing(record_len, capacity);
}
void telemetry_ring_destroy(void* tr) {
  delete static_cast<TelemetryRing*>(tr);
}
int telemetry_ring_push(void* tr, const float* rec) {
  return static_cast<TelemetryRing*>(tr)->push(rec) ? 1 : 0;
}
int telemetry_ring_pop(void* tr, float* dst, int max_records) {
  return static_cast<TelemetryRing*>(tr)->pop(dst, max_records);
}
int64_t telemetry_ring_dropped(void* tr) {
  return static_cast<int64_t>(
      static_cast<TelemetryRing*>(tr)->dropped_.load());
}

void* plan_buffer_create(int n) { return new PlanBuffer(n); }
void plan_buffer_destroy(void* pb) { delete static_cast<PlanBuffer*>(pb); }
void plan_buffer_publish(void* pb, const float* src, int64_t id) {
  static_cast<PlanBuffer*>(pb)->publish(src, id);
}
int64_t plan_buffer_read(void* pb, float* dst) {
  return static_cast<PlanBuffer*>(pb)->read_latest(dst);
}

void* rt_executor_create(int64_t period_ns) {
  return new RtExecutor(period_ns);
}
void rt_executor_destroy(void* ex) { delete static_cast<RtExecutor*>(ex); }
void rt_executor_run(void* ex, int64_t ticks, void (*cb)(void*, int64_t),
                     void* user) {
  static_cast<RtExecutor*>(ex)->run(ticks, cb, user);
}
int64_t rt_executor_ticks(void* ex) {
  return static_cast<RtExecutor*>(ex)->stats_.ticks;
}
int64_t rt_executor_overruns(void* ex) {
  return static_cast<RtExecutor*>(ex)->stats_.overruns;
}
double rt_executor_max_jitter_us(void* ex) {
  return static_cast<RtExecutor*>(ex)->stats_.max_jitter_ns / 1e3;
}
double rt_executor_mean_jitter_us(void* ex) {
  auto* e = static_cast<RtExecutor*>(ex);
  return e->stats_.ticks
             ? e->stats_.sum_jitter_ns / e->stats_.ticks / 1e3
             : 0.0;
}

}  // extern "C"
