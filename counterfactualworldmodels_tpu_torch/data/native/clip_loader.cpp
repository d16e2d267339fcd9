// Native training-data loader: multithreaded prefetch of video clips from a
// packed binary shard into host batches ready for device transfer.
//
// The PyTorch port's copy of the JAX package's loader
// (counterfactualworldmodels_tpu/data/native/clip_loader.cpp), with two
// additions: batches are handed out in batch-index order whatever the
// number of workers (so a run is the same with 1 or N threads), and
// clip_loader_create_v3 starts the stream at a given batch index (a
// resumed trainer continues the data stream where it stopped). With one
// worker and start 0 it yields what the JAX package's loader yields.
//
// Worker threads read uint8 [T,H,W,C] clips from a memory-mapped shard,
// optionally random-crop and horizontally flip them, and publish complete
// batches into a bounded ring buffer the Python side drains via ctypes
// (zero Python work per pixel). Batch index i is a function of (seed, i)
// alone: its crops and flips come from its own generator, its clips from
// the epoch-seeded permutation.
//
// Two output modes:
//   f32 CHW  (mode 0) - float32 [B,T,C,h,w] in [0,1]; the HWC->CHW
//            deinterleave reads each source row once and writes C
//            contiguous plane rows (vectorizable).
//   u8 THWC  (mode 1) - uint8 [B,T,h,w,C] crop/flip only; rows are plain
//            memcpy. Normalization and the layout transpose happen on the
//            device (data/shards.py u8_to_chw_01), and the host moves 4x
//            fewer bytes.
//
// Batch buffers come from a reusable pool (no per-batch allocation).
//
// Shard format (written by data/shards.py):
//   magic 'CWMSHARD' | u32 version | u32 num_clips
//   | u32 T | u32 H | u32 W | u32 C            (fixed clip shape)
//   | num_clips * (T*H*W*C) bytes of uint8 payload
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread clip_loader.cpp -o ...

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <map>
#include <memory>
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

struct ShardHeader {
  char magic[8];
  uint32_t version;
  uint32_t num_clips;
  uint32_t t, h, w, c;
};

struct Batch {
  std::unique_ptr<uint8_t[]> data;  // batch_bytes() raw payload
  std::vector<uint32_t> clip_ids;   // source clip index per batch row
  uint64_t index = 0;
};

class ClipLoader {
 public:
  ClipLoader(const char* path, int batch_size, int crop_h, int crop_w,
             int num_threads, int prefetch, uint64_t seed, bool hflip,
             bool shuffle, bool u8_mode, uint64_t start_batch)
      : batch_size_(batch_size),
        crop_h_(crop_h),
        crop_w_(crop_w),
        prefetch_(prefetch),
        hflip_(hflip),
        shuffle_(shuffle),
        u8_mode_(u8_mode),
        seed_(seed),
        next_index_(start_batch),
        next_out_(start_batch) {
    fd_ = open(path, O_RDONLY);
    if (fd_ < 0) { ok_ = false; return; }
    struct stat st;
    fstat(fd_, &st);
    size_ = static_cast<size_t>(st.st_size);
    base_ = static_cast<const uint8_t*>(
        mmap(nullptr, size_, PROT_READ, MAP_PRIVATE, fd_, 0));
    if (base_ == MAP_FAILED) { ok_ = false; return; }
    std::memcpy(&hdr_, base_, sizeof(ShardHeader));
    if (std::memcmp(hdr_.magic, "CWMSHARD", 8) != 0) { ok_ = false; return; }
    payload_ = base_ + sizeof(ShardHeader);
    clip_bytes_ = static_cast<size_t>(hdr_.t) * hdr_.h * hdr_.w * hdr_.c;
    if (crop_h_ <= 0) crop_h_ = hdr_.h;
    if (crop_w_ <= 0) crop_w_ = hdr_.w;
    ok_ = (sizeof(ShardHeader) + clip_bytes_ * hdr_.num_clips <= size_) &&
          hdr_.num_clips > 0 &&  // N=0 would divide by zero in the workers
          crop_h_ <= static_cast<int>(hdr_.h) &&
          crop_w_ <= static_cast<int>(hdr_.w);
    if (!ok_) return;
    // buffer pool: one per in-flight batch (ring capacity + one per worker
    // being filled); allocated up front, reused for the loader's lifetime
    pool_cap_ = static_cast<size_t>(prefetch_) + num_threads;
    for (size_t i = 0; i < pool_cap_; ++i) {
      pool_.push(std::unique_ptr<uint8_t[]>(new uint8_t[batch_bytes()]));
    }
    stop_.store(false);
    for (int i = 0; i < num_threads; ++i) {
      workers_.emplace_back([this, i] { worker_loop(i); });
    }
  }

  ~ClipLoader() {
    stop_.store(true);
    cv_space_.notify_all();
    cv_data_.notify_all();
    for (auto& t : workers_) t.join();
    if (base_ && base_ != MAP_FAILED) munmap(const_cast<uint8_t*>(base_), size_);
    if (fd_ >= 0) close(fd_);
  }

  bool ok() const { return ok_; }
  uint32_t num_clips() const { return hdr_.num_clips; }
  uint32_t t() const { return hdr_.t; }
  uint32_t c() const { return hdr_.c; }
  int crop_h() const { return crop_h_; }
  int crop_w() const { return crop_w_; }
  int batch_size() const { return batch_size_; }
  bool u8_mode() const { return u8_mode_; }
  size_t batch_elems() const {
    return static_cast<size_t>(batch_size_) * hdr_.t * hdr_.c * crop_h_ *
           crop_w_;
  }
  size_t batch_bytes() const {
    return batch_elems() * (u8_mode_ ? 1 : sizeof(float));
  }

  // Blocking: copy the next ready batch into out (f32 [B,T,C,h,w] or uint8
  // [B,T,h,w,C] per mode); if ids != nullptr also write the B source clip
  // indices (aligns sidecar streams, e.g. the IMU sidecar, with shuffled
  // rows). Returns the global batch index, or -1 on shutdown.
  int64_t next_batch(void* out, uint32_t* ids) {
    Batch b;
    {
      std::unique_lock<std::mutex> lk(mu_);
      if (!take_next(lk, b)) return -1;
    }
    std::memcpy(out, b.data.get(), batch_bytes());
    if (ids != nullptr) {
      std::memcpy(ids, b.clip_ids.data(),
                  b.clip_ids.size() * sizeof(uint32_t));
    }
    {
      std::lock_guard<std::mutex> lk(mu_);
      pool_.push(std::move(b.data));  // return the buffer to the pool
    }
    cv_space_.notify_one();
    return static_cast<int64_t>(b.index);
  }

  // Zero-copy variant: hand out a pointer INTO the ring buffer instead of
  // copying the batch out. The buffer stays owned by the loader until
  // release(ptr) returns it to the pool; callers must release before the
  // pool drains (the Python side releases on the next next_batch()).
  int64_t acquire(void** out_data, uint32_t* ids) {
    std::unique_lock<std::mutex> lk(mu_);
    Batch b;
    if (!take_next(lk, b)) return -1;
    if (ids != nullptr) {
      std::memcpy(ids, b.clip_ids.data(),
                  b.clip_ids.size() * sizeof(uint32_t));
    }
    *out_data = b.data.get();
    inflight_.push_back(std::move(b.data));
    return static_cast<int64_t>(b.index);
  }

  void release(void* data) {
    std::lock_guard<std::mutex> lk(mu_);
    for (auto it = inflight_.begin(); it != inflight_.end(); ++it) {
      if (it->get() == data) {
        pool_.push(std::move(*it));
        inflight_.erase(it);
        cv_space_.notify_one();
        return;
      }
    }
  }

 private:
  // Under mu_: wait for the batch of the next index in order (its worker
  // already holds a pool buffer, so it arrives whatever the others do) and
  // move it out. False on shutdown.
  bool take_next(std::unique_lock<std::mutex>& lk, Batch& b) {
    cv_data_.wait(lk, [this] {
      return ready_.count(next_out_) > 0 || stop_.load();
    });
    auto it = ready_.find(next_out_);
    if (it == ready_.end()) return false;
    b = std::move(it->second);
    ready_.erase(it);
    ++next_out_;
    return true;
  }

  // Materialize the epoch-seeded Fisher-Yates permutation: every epoch
  // visits each clip exactly once in an independent uniform order (the
  // identical permutation is derived by any worker from the epoch alone,
  // so interleaved workers agree without sharing state).
  void epoch_perm(uint64_t epoch, std::vector<uint32_t>& out) const {
    out.resize(hdr_.num_clips);
    for (uint32_t i = 0; i < hdr_.num_clips; ++i) out[i] = i;
    std::mt19937_64 rng(seed_ + epoch * 0x9e3779b97f4a7c15ULL);
    for (uint32_t i = hdr_.num_clips; i > 1; --i) {
      std::swap(out[i - 1], out[rng() % i]);
    }
  }

  // f32 CHW decode: each source row is read once and split into C contiguous
  // plane rows (sequential loads, unit-stride stores -> vectorizable),
  // instead of the per-output-pixel strided gather the first version used.
  void decode_clip_f32(uint32_t clip_idx, float* dst, int oy, int ox,
                       bool flip) {
    const uint8_t* src = payload_ + clip_bytes_ * clip_idx;
    const int T = hdr_.t, H = hdr_.h, W = hdr_.w, C = hdr_.c;
    const size_t plane = static_cast<size_t>(crop_h_) * crop_w_;
    const float inv = 1.0f / 255.0f;
    for (int t = 0; t < T; ++t) {
      const uint8_t* frame = src + static_cast<size_t>(t) * H * W * C;
      float* tbase = dst + static_cast<size_t>(t) * C * plane;
      for (int y = 0; y < crop_h_; ++y) {
        const uint8_t* row =
            frame + (static_cast<size_t>(y + oy) * W + ox) * C;
        if (C == 3) {
          float* r0 = tbase + static_cast<size_t>(y) * crop_w_;
          float* r1 = r0 + plane;
          float* r2 = r1 + plane;
          if (!flip) {
            for (int x = 0; x < crop_w_; ++x) {
              r0[x] = row[3 * x + 0] * inv;
              r1[x] = row[3 * x + 1] * inv;
              r2[x] = row[3 * x + 2] * inv;
            }
          } else {
            const int last = crop_w_ - 1;
            for (int x = 0; x < crop_w_; ++x) {
              r0[x] = row[3 * (last - x) + 0] * inv;
              r1[x] = row[3 * (last - x) + 1] * inv;
              r2[x] = row[3 * (last - x) + 2] * inv;
            }
          }
        } else {
          for (int ch = 0; ch < C; ++ch) {
            float* o = tbase + ch * plane + static_cast<size_t>(y) * crop_w_;
            if (!flip) {
              for (int x = 0; x < crop_w_; ++x) o[x] = row[x * C + ch] * inv;
            } else {
              const int last = crop_w_ - 1;
              for (int x = 0; x < crop_w_; ++x)
                o[x] = row[(last - x) * C + ch] * inv;
            }
          }
        }
      }
    }
  }

  // u8 THWC decode: crop rows are straight memcpy; flips reverse whole
  // pixels (C-byte groups). 4x less data than f32 and no conversion —
  // normalization runs on device.
  void decode_clip_u8(uint32_t clip_idx, uint8_t* dst, int oy, int ox,
                      bool flip) {
    const uint8_t* src = payload_ + clip_bytes_ * clip_idx;
    const int T = hdr_.t, H = hdr_.h, W = hdr_.w, C = hdr_.c;
    const size_t row_bytes = static_cast<size_t>(crop_w_) * C;
    for (int t = 0; t < T; ++t) {
      const uint8_t* frame = src + static_cast<size_t>(t) * H * W * C;
      for (int y = 0; y < crop_h_; ++y) {
        const uint8_t* row =
            frame + (static_cast<size_t>(y + oy) * W + ox) * C;
        uint8_t* out_row =
            dst + (static_cast<size_t>(t) * crop_h_ + y) * row_bytes;
        if (!flip) {
          std::memcpy(out_row, row, row_bytes);
        } else if (C == 3) {
          const int last = crop_w_ - 1;
          for (int x = 0; x < crop_w_; ++x) {
            const uint8_t* p = row + 3 * (last - x);
            out_row[3 * x + 0] = p[0];
            out_row[3 * x + 1] = p[1];
            out_row[3 * x + 2] = p[2];
          }
        } else {
          const int last = crop_w_ - 1;
          for (int x = 0; x < crop_w_; ++x) {
            for (int ch = 0; ch < C; ++ch)
              out_row[x * C + ch] = row[(last - x) * C + ch];
          }
        }
      }
    }
  }

  void worker_loop(int /*tid*/) {
    const size_t clip_elems =
        static_cast<size_t>(hdr_.t) * hdr_.c * crop_h_ * crop_w_;
    uint64_t cached_ep = ~0ULL;    // this worker's cached epoch_perm
    std::vector<uint32_t> perm;
    while (!stop_.load()) {
      // take a pool buffer first (bounds in-flight batches to the pool)
      std::unique_ptr<uint8_t[]> buf;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_space_.wait(lk, [this] { return !pool_.empty() || stop_.load(); });
        if (stop_.load()) return;
        buf = std::move(pool_.front());
        pool_.pop();
      }
      uint64_t my_index = next_index_.fetch_add(1);
      Batch b;
      b.index = my_index;
      b.data = std::move(buf);
      b.clip_ids.resize(batch_size_);
      std::mt19937_64 rng(seed_ ^ (my_index * 0xda942042e4dd58b5ULL));
      for (int i = 0; i < batch_size_; ++i) {
        uint64_t flat = my_index * batch_size_ + i;
        uint64_t ep = flat / hdr_.num_clips;
        uint32_t pos = static_cast<uint32_t>(flat % hdr_.num_clips);
        uint32_t clip;
        if (shuffle_) {
          // real per-epoch Fisher-Yates order; rebuilt only when this
          // worker crosses an epoch boundary
          if (ep != cached_ep) {
            epoch_perm(ep, perm);
            cached_ep = ep;
          }
          clip = perm[pos];
        } else {
          clip = pos;
        }
        int oy = (crop_h_ < static_cast<int>(hdr_.h))
                     ? static_cast<int>(rng() % (hdr_.h - crop_h_ + 1))
                     : 0;
        int ox = (crop_w_ < static_cast<int>(hdr_.w))
                     ? static_cast<int>(rng() % (hdr_.w - crop_w_ + 1))
                     : 0;
        bool flip = hflip_ && (rng() & 1);
        b.clip_ids[i] = clip;
        if (u8_mode_) {
          decode_clip_u8(clip, b.data.get() + clip_elems * i, oy, ox, flip);
        } else {
          decode_clip_f32(clip,
                          reinterpret_cast<float*>(b.data.get()) +
                              clip_elems * i,
                          oy, ox, flip);
        }
      }
      {
        std::lock_guard<std::mutex> lk(mu_);
        ready_.emplace(b.index, std::move(b));
      }
      cv_data_.notify_all();
    }
  }

  int fd_ = -1;
  size_t size_ = 0;
  const uint8_t* base_ = nullptr;
  const uint8_t* payload_ = nullptr;
  ShardHeader hdr_{};
  size_t clip_bytes_ = 0;
  bool ok_ = true;

  int batch_size_, crop_h_, crop_w_, prefetch_;
  bool hflip_, shuffle_, u8_mode_;
  uint64_t seed_;
  size_t pool_cap_ = 0;

  std::vector<std::thread> workers_;
  std::mutex mu_;
  std::condition_variable cv_data_, cv_space_;
  std::map<uint64_t, Batch> ready_;   // finished batches by index
  std::queue<std::unique_ptr<uint8_t[]>> pool_;
  std::vector<std::unique_ptr<uint8_t[]>> inflight_;
  std::atomic<bool> stop_{true};
  std::atomic<uint64_t> next_index_;  // next index a worker claims
  uint64_t next_out_;                  // next index handed out (under mu_)
};

}  // namespace

extern "C" {

// As clip_loader_create_v2, with the stream starting at batch index
// start_batch (the batches 0 .. start_batch-1 are never made).
void* clip_loader_create_v3(const char* path, int batch_size, int crop_h,
                            int crop_w, int num_threads, int prefetch,
                            uint64_t seed, int hflip, int shuffle,
                            int u8_mode, uint64_t start_batch) {
  auto* l = new ClipLoader(path, batch_size, crop_h, crop_w, num_threads,
                           prefetch, seed, hflip != 0, shuffle != 0,
                           u8_mode != 0, start_batch);
  if (!l->ok()) {
    delete l;
    return nullptr;
  }
  return l;
}

void* clip_loader_create_v2(const char* path, int batch_size, int crop_h,
                            int crop_w, int num_threads, int prefetch,
                            uint64_t seed, int hflip, int shuffle,
                            int u8_mode) {
  return clip_loader_create_v3(path, batch_size, crop_h, crop_w, num_threads,
                               prefetch, seed, hflip, shuffle, u8_mode, 0);
}

void* clip_loader_create(const char* path, int batch_size, int crop_h,
                         int crop_w, int num_threads, int prefetch,
                         uint64_t seed, int hflip, int shuffle) {
  return clip_loader_create_v2(path, batch_size, crop_h, crop_w, num_threads,
                               prefetch, seed, hflip, shuffle, 0);
}

void clip_loader_destroy(void* handle) {
  delete static_cast<ClipLoader*>(handle);
}

int64_t clip_loader_next(void* handle, float* out) {
  return static_cast<ClipLoader*>(handle)->next_batch(out, nullptr);
}

// As clip_loader_next, plus the B source clip indices of the batch rows.
int64_t clip_loader_next_ids(void* handle, float* out, uint32_t* ids) {
  return static_cast<ClipLoader*>(handle)->next_batch(out, ids);
}

// Mode-agnostic: out must hold clip_loader_batch_bytes(handle) bytes.
int64_t clip_loader_next_raw(void* handle, void* out, uint32_t* ids) {
  return static_cast<ClipLoader*>(handle)->next_batch(out, ids);
}

// Zero-copy: *out_data points into the loader's ring; valid until
// clip_loader_release(handle, *out_data).
int64_t clip_loader_acquire(void* handle, void** out_data, uint32_t* ids) {
  return static_cast<ClipLoader*>(handle)->acquire(out_data, ids);
}

void clip_loader_release(void* handle, void* data) {
  static_cast<ClipLoader*>(handle)->release(data);
}

void clip_loader_shape(void* handle, int* out5) {
  auto* l = static_cast<ClipLoader*>(handle);
  out5[0] = l->batch_size();
  out5[1] = static_cast<int>(l->t());
  out5[2] = static_cast<int>(l->c());
  out5[3] = l->crop_h();
  out5[4] = l->crop_w();
}

uint64_t clip_loader_batch_bytes(void* handle) {
  return static_cast<ClipLoader*>(handle)->batch_bytes();
}

int clip_loader_u8_mode(void* handle) {
  return static_cast<ClipLoader*>(handle)->u8_mode() ? 1 : 0;
}

uint32_t clip_loader_num_clips(void* handle) {
  return static_cast<ClipLoader*>(handle)->num_clips();
}

}  // extern "C"
