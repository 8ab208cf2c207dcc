// Multithreaded window-sampling prefetch engine over welded demo arrays.
//
// The port's copy of the JAX package's native/window_prefetch.cpp, byte for
// byte below this comment, so the same seed samples the same indices.
// Welded datasets normally sit on the device and a batch is one indexed
// gather (data/windows.py). Datasets larger than device memory need the
// host in the loop: worker threads assemble window batches (the clamped
// gather of DeviceDataset.gather) from host-resident, possibly
// memory-mapped, arrays into a ring of slot buffers, so the training loop
// overlaps host gathering with device compute.
//
// The Python side (data/host_prefetch.py) passes raw row pointers; rows are
// copied as bytes, so any dtype works. Each wp_next() drains one ready slot
// into caller-owned buffers and recycles it. The chosen sample indices are
// returned as well.
//
// Build: g++ -O3 -shared -fPIC -pthread -std=c++17
// (ops/kernels/_build.host_library).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <vector>

namespace {

struct KeySpec {
  const uint8_t* data;   // (n_steps, row_bytes) C-contiguous
  int64_t row_bytes;
  bool is_obs;           // obs keys get the full frame-stacked window
};

struct Slot {
  std::vector<std::vector<uint8_t>> buffers;  // per key
  std::vector<int64_t> indices;               // (batch,) sampled indices
};

struct Engine {
  std::vector<KeySpec> keys;
  const int32_t* demo_start = nullptr;  // (n_steps,)
  const int32_t* demo_end = nullptr;    // (n_steps,) exclusive
  int64_t n_steps = 0;
  int frame_stack = 1;
  int seq_length = 1;
  int batch = 1;

  std::vector<Slot> slots;
  std::queue<int> free_q, ready_q;
  std::mutex mu;
  std::condition_variable cv_free, cv_ready;
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;
  uint64_t seed = 0;

  int window() const { return frame_stack - 1 + seq_length; }

  void fill(Slot& slot, std::mt19937_64& rng) {
    std::uniform_int_distribution<int64_t> dist(0, n_steps - 1);
    const int W = window();
    for (int b = 0; b < batch; ++b) {
      const int64_t idx = dist(rng);
      slot.indices[b] = idx;
      const int64_t lo = demo_start[idx];
      const int64_t hi = demo_end[idx] - 1;
      for (size_t k = 0; k < keys.size(); ++k) {
        const KeySpec& ks = keys[k];
        const int w0 = ks.is_obs ? 0 : frame_stack - 1;
        uint8_t* dst = slot.buffers[k].data() +
                       int64_t(b) * (W - w0) * ks.row_bytes;
        for (int w = w0; w < W; ++w) {
          int64_t pos = idx + (w - (frame_stack - 1));
          if (pos < lo) pos = lo;
          if (pos > hi) pos = hi;
          std::memcpy(dst, ks.data + pos * ks.row_bytes, ks.row_bytes);
          dst += ks.row_bytes;
        }
      }
    }
  }

  void worker(int wid) {
    std::mt19937_64 rng(seed * 0x9E3779B97F4A7C15ULL + wid + 1);
    for (;;) {
      int slot_id;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] { return stop.load() || !free_q.empty(); });
        if (stop.load()) return;
        slot_id = free_q.front();
        free_q.pop();
      }
      fill(slots[slot_id], rng);
      {
        std::lock_guard<std::mutex> lk(mu);
        ready_q.push(slot_id);
      }
      cv_ready.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* wp_create(int n_keys, const void** key_ptrs,
                const int64_t* key_row_bytes, const uint8_t* key_is_obs,
                int64_t n_steps, const int32_t* demo_start,
                const int32_t* demo_end, int frame_stack, int seq_length,
                int batch, int n_slots, int n_threads, uint64_t seed) {
  auto* e = new Engine();
  e->demo_start = demo_start;
  e->demo_end = demo_end;
  e->n_steps = n_steps;
  e->frame_stack = frame_stack;
  e->seq_length = seq_length;
  e->batch = batch;
  e->seed = seed;
  for (int k = 0; k < n_keys; ++k) {
    e->keys.push_back(KeySpec{static_cast<const uint8_t*>(key_ptrs[k]),
                              key_row_bytes[k], key_is_obs[k] != 0});
  }
  const int W = e->window();
  e->slots.resize(n_slots);
  for (int s = 0; s < n_slots; ++s) {
    e->slots[s].indices.resize(batch);
    for (int k = 0; k < n_keys; ++k) {
      const int rows = e->keys[k].is_obs ? W : e->seq_length;
      e->slots[s].buffers.emplace_back(
          size_t(batch) * rows * e->keys[k].row_bytes);
    }
    e->free_q.push(s);
  }
  for (int t = 0; t < n_threads; ++t) {
    e->workers.emplace_back([e, t] { e->worker(t); });
  }
  return e;
}

// Copy one ready batch into caller buffers (per-key) + sampled indices.
void wp_next(void* handle, void** out_ptrs, int64_t* out_indices) {
  auto* e = static_cast<Engine*>(handle);
  int slot_id;
  {
    std::unique_lock<std::mutex> lk(e->mu);
    e->cv_ready.wait(lk, [&] { return !e->ready_q.empty(); });
    slot_id = e->ready_q.front();
    e->ready_q.pop();
  }
  Slot& slot = e->slots[slot_id];
  for (size_t k = 0; k < e->keys.size(); ++k) {
    std::memcpy(out_ptrs[k], slot.buffers[k].data(), slot.buffers[k].size());
  }
  std::memcpy(out_indices, slot.indices.data(),
              slot.indices.size() * sizeof(int64_t));
  {
    std::lock_guard<std::mutex> lk(e->mu);
    e->free_q.push(slot_id);
  }
  e->cv_free.notify_one();
}

void wp_destroy(void* handle) {
  auto* e = static_cast<Engine*>(handle);
  e->stop.store(true);
  e->cv_free.notify_all();
  for (auto& t : e->workers) t.join();
  delete e;
}

}  // extern "C"
