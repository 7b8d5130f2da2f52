// Threaded pair loader over a memory-mapped volume store.
//
// The port's own copy of pulpo_tpu/native/dataloader.cc, unchanged below
// this comment; built by pulpo_tpu_torch/native/__init__.py with g++ into
// pulpo_tpu_torch/_build/ and called through ctypes.
//
// The reference feeds its model through torch DataLoader workers that
// open the HDF5 file per item (src/data/OASIS/oasis.py:68). This engine
// serves registration pairs from a memory-mapped binary volume store
// with a pool of producer threads and a bounded ring of slots:
//
//   store layout:  header (magic, n, shape[3], seg_flag)
//                  then n volumes f32 [D*H*W]
//                  then (if seg_flag) n label volumes int16 [D*H*W]
//
// The producers assemble complete items (moving, fixed, one-hot segs)
// in preallocated slots; the consumer (Python, through ctypes) blocks in
// dl_next() and gets a slot index that it later returns with
// dl_release(). Every copy and one-hot expansion runs in C++ threads,
// outside the GIL. A label outside [0, classes) gives an all-zero
// one-hot row.
//
// C API (extern "C"): dl_open, dl_start_epoch, dl_next, dl_release,
// dl_close, dl_shape, dl_len.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr uint64_t kMagic = 0x50554C504F424C4FULL;  // "PULPOBLO"

struct Header {
  uint64_t magic;
  uint64_t n;
  uint64_t shape[3];
  uint64_t seg_flag;     // 0 or number of segmentation classes
  uint64_t reserved[2];  // total 64 bytes, matching the Python writer
};

struct Slot {
  std::vector<float> x, y, seg_x, seg_y;
  long index1 = -1, index2 = -1;
  size_t item_no = 0;
};

struct Loader {
  int fd = -1;
  const uint8_t* map = nullptr;
  size_t map_size = 0;
  Header hdr{};
  size_t voxels = 0;
  const float* volumes = nullptr;
  const int16_t* segs = nullptr;

  // epoch state
  std::vector<uint32_t> order;
  std::atomic<size_t> next_item{0};
  std::atomic<size_t> consumed{0};
  size_t next_admit = 0;  // guarded by mu: slot grants in item order
  size_t epoch_items = 0;
  bool with_segs = false;
  uint64_t seed = 0;

  // ring buffer; ready is a min-heap on item_no so batches are
  // delivered in epoch order regardless of worker completion order
  std::vector<Slot> slots;
  std::queue<int> free_slots;
  std::priority_queue<std::pair<size_t, int>,
                      std::vector<std::pair<size_t, int>>,
                      std::greater<>> ready_slots;
  std::mutex mu;
  std::condition_variable cv_free, cv_ready;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  ~Loader() { shutdown(); }

  void shutdown() {
    stop.store(true);
    cv_free.notify_all();
    cv_ready.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
    workers.clear();
    if (map) munmap(const_cast<uint8_t*>(map), map_size);
    map = nullptr;
    if (fd >= 0) close(fd);
    fd = -1;
  }

  void fill_slot(Slot& s, uint32_t idx, uint64_t epoch_seed, size_t item_no) {
    // random partner != idx (reference pair sampling, oasis.py:62-67)
    std::mt19937_64 rng(epoch_seed * 0x9E3779B97F4A7C15ULL + item_no);
    uint32_t j = idx;
    while (j == idx && hdr.n > 1) {
      j = static_cast<uint32_t>(rng() % hdr.n);
    }
    s.index1 = idx;
    s.index2 = j;
    std::memcpy(s.x.data(), volumes + size_t(idx) * voxels, voxels * 4);
    std::memcpy(s.y.data(), volumes + size_t(j) * voxels, voxels * 4);
    if (with_segs && segs) {
      const uint64_t classes = hdr.seg_flag;
      auto onehot = [&](uint32_t vol, std::vector<float>& out) {
        const int16_t* lab = segs + size_t(vol) * voxels;
        std::memset(out.data(), 0, out.size() * 4);
        for (size_t v = 0; v < voxels; ++v) {
          uint64_t c = static_cast<uint64_t>(lab[v]);
          if (c < classes) out[v * classes + c] = 1.0f;
        }
      };
      onehot(idx, s.seg_x);
      onehot(j, s.seg_y);
    }
  }

  void worker_loop() {
    while (!stop.load()) {
      size_t item = next_item.fetch_add(1);
      if (item >= epoch_items) return;
      int slot_id;
      {
        // acquire slots in item order: otherwise later items can occupy
        // every slot while the consumer blocks on the earliest one
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] {
          return stop.load() ||
                 (!free_slots.empty() && next_admit == item);
        });
        if (stop.load()) return;
        slot_id = free_slots.front();
        free_slots.pop();
        ++next_admit;
        cv_free.notify_all();
      }
      fill_slot(slots[slot_id], order[item], seed, item);
      slots[slot_id].item_no = item;
      {
        std::lock_guard<std::mutex> lk(mu);
        ready_slots.emplace(item, slot_id);
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* dl_open(const char* path, int with_segs, int n_slots) {
  auto* L = new Loader();
  L->fd = open(path, O_RDONLY);
  if (L->fd < 0) {
    delete L;
    return nullptr;
  }
  struct stat st;
  fstat(L->fd, &st);
  L->map_size = st.st_size;
  L->map = static_cast<const uint8_t*>(
      mmap(nullptr, L->map_size, PROT_READ, MAP_PRIVATE, L->fd, 0));
  if (L->map == MAP_FAILED) {
    delete L;
    return nullptr;
  }
  std::memcpy(&L->hdr, L->map, sizeof(Header));
  if (L->hdr.magic != kMagic) {
    delete L;
    return nullptr;
  }
  L->voxels = L->hdr.shape[0] * L->hdr.shape[1] * L->hdr.shape[2];
  L->volumes = reinterpret_cast<const float*>(L->map + sizeof(Header));
  if (L->hdr.seg_flag) {
    L->segs = reinterpret_cast<const int16_t*>(
        L->map + sizeof(Header) + sizeof(float) * L->voxels * L->hdr.n);
  }
  L->with_segs = with_segs && L->hdr.seg_flag;
  if (n_slots < 2) n_slots = 2;
  L->slots.resize(n_slots);
  const uint64_t classes = L->hdr.seg_flag;
  for (auto& s : L->slots) {
    s.x.resize(L->voxels);
    s.y.resize(L->voxels);
    if (L->with_segs) {
      s.seg_x.resize(L->voxels * classes);
      s.seg_y.resize(L->voxels * classes);
    }
  }
  return L;
}

void dl_shape(void* h, uint64_t* out_shape, uint64_t* out_classes) {
  auto* L = static_cast<Loader*>(h);
  for (int i = 0; i < 3; ++i) out_shape[i] = L->hdr.shape[i];
  *out_classes = L->hdr.seg_flag;
}

uint64_t dl_len(void* h) { return static_cast<Loader*>(h)->hdr.n; }

// Begin serving one epoch. order==nullptr -> sequential.
int dl_start_epoch(void* h, const uint32_t* order, uint64_t n_items,
                   uint64_t seed, int n_threads) {
  auto* L = static_cast<Loader*>(h);
  // join previous epoch's workers
  L->stop.store(true);
  L->cv_free.notify_all();
  for (auto& t : L->workers)
    if (t.joinable()) t.join();
  L->workers.clear();
  L->stop.store(false);

  L->order.resize(n_items);
  if (order) {
    std::memcpy(L->order.data(), order, n_items * 4);
  } else {
    for (uint64_t i = 0; i < n_items; ++i) L->order[i] = i % L->hdr.n;
  }
  L->epoch_items = n_items;
  L->next_item.store(0);
  L->consumed.store(0);
  L->next_admit = 0;
  L->seed = seed;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    while (!L->free_slots.empty()) L->free_slots.pop();
    while (!L->ready_slots.empty()) L->ready_slots.pop();
    for (size_t i = 0; i < L->slots.size(); ++i)
      L->free_slots.push(static_cast<int>(i));
  }
  if (n_threads < 1) n_threads = 1;
  for (int t = 0; t < n_threads; ++t)
    L->workers.emplace_back([L] { L->worker_loop(); });
  return 0;
}

// Blocks until the next batch item is ready; returns slot id or -1 when
// the epoch is exhausted. Pointers into the slot buffers are written to
// the out params (valid until dl_release(slot)).
int dl_next(void* h, float** x, float** y, float** seg_x, float** seg_y,
            long* idx1, long* idx2) {
  auto* L = static_cast<Loader*>(h);
  size_t want = L->consumed.load();
  if (want >= L->epoch_items) return -1;
  std::unique_lock<std::mutex> lk(L->mu);
  for (;;) {
    if (!L->ready_slots.empty() && L->ready_slots.top().first == want) break;
    L->cv_ready.wait_for(lk, std::chrono::milliseconds(50));
    if (L->stop.load()) return -1;
  }
  int id = L->ready_slots.top().second;
  L->ready_slots.pop();
  L->consumed.fetch_add(1);
  Slot& s = L->slots[id];
  *x = s.x.data();
  *y = s.y.data();
  *seg_x = s.seg_x.empty() ? nullptr : s.seg_x.data();
  *seg_y = s.seg_y.empty() ? nullptr : s.seg_y.data();
  *idx1 = s.index1;
  *idx2 = s.index2;
  return id;
}

void dl_release(void* h, int slot) {
  auto* L = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->free_slots.push(slot);
  }
  L->cv_free.notify_one();
}

void dl_close(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
