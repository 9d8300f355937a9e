// Threaded prefetching .npy batch loader: the native host-side runtime that
// feeds GAN training, so the card never waits on file IO. The port's own
// copy of ganecdotes_tpu/runtime/src/loader.cpp (same batches, in the same
// order, from the same files and seed), built by
// ganecdotes_torch/runtime/__init__.py.
//
// The reference trains its BagGAN on the PIDRay dataset through torch
// DataLoader workers (external bagganhq repo; README.md:133-138). Here a
// pool of worker threads claims whole batches from a shuffled epoch stream,
// reads each .npy image file, decodes uint8/float32 payloads, optionally
// normalizes uint8 to [-1, 1], and pushes finished batches into a bounded
// queue consumed from Python via ctypes (copied into a caller-provided
// buffer).
//
// Scope: C-order little-endian '<f4' or '|u1' arrays of shape (H, W, C) or
// (H, W). Anything else is counted in gx_errors() and trains as zeros.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

struct NpyInfo {
  bool ok = false;
  bool is_u8 = false;
  long header_bytes = 0;
  long h = 0, w = 0, c = 1;
};

// Minimal .npy v1/v2 header parse: magic, version, HEADER_LEN, python dict.
NpyInfo parse_npy_header(FILE* f) {
  NpyInfo info;
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return info;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return info;
  int major = magic[6];
  unsigned int hlen = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return info;
    hlen = b[0] | (b[1] << 8);
    info.header_bytes = 10 + hlen;
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return info;
    hlen = b[0] | (b[1] << 8) | (b[2] << 16) | ((unsigned)b[3] << 24);
    info.header_bytes = 12 + hlen;
  }
  std::string header(hlen, '\0');
  if (fread(&header[0], 1, hlen, f) != hlen) return info;

  if (header.find("'fortran_order': True") != std::string::npos) return info;
  if (header.find("'<f4'") != std::string::npos) {
    info.is_u8 = false;
  } else if (header.find("'|u1'") != std::string::npos ||
             header.find("'u1'") != std::string::npos) {
    info.is_u8 = true;
  } else {
    return info;
  }

  size_t sp = header.find("'shape':");
  if (sp == std::string::npos) return info;
  size_t lp = header.find('(', sp);
  size_t rp = header.find(')', sp);
  if (lp == std::string::npos || rp == std::string::npos) return info;
  std::string dims = header.substr(lp + 1, rp - lp - 1);
  long vals[4] = {0, 0, 0, 0};
  int nd = 0;
  const char* p = dims.c_str();
  while (*p && nd < 4) {
    while (*p == ' ' || *p == ',') p++;
    if (!*p) break;
    vals[nd++] = strtol(p, const_cast<char**>(&p), 10);
  }
  if (nd == 2) {
    info.h = vals[0]; info.w = vals[1]; info.c = 1;
  } else if (nd == 3) {
    info.h = vals[0]; info.w = vals[1]; info.c = vals[2];
  } else {
    return info;
  }
  info.ok = true;
  return info;
}

struct Loader {
  std::vector<std::string> paths;
  int batch, h, w, c;
  size_t queue_depth;
  bool shuffle, normalize;
  unsigned seed;

  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::atomic<long> batches_produced{0};
  std::atomic<long> decode_errors{0};
  // nanoseconds the last gx_next blocked on an empty queue
  std::atomic<long long> last_starved_ns{0};

  std::mutex idx_mu;
  std::vector<int> order;
  size_t cursor = 0;
  long epoch = 0;
  std::mt19937 rng;

  std::mutex q_mu;
  std::condition_variable q_push_cv, q_pop_cv;
  std::deque<std::vector<float>> ready;

  size_t sample_floats() const { return (size_t)h * w * c; }

  // Claim `batch` sample indices from the (re)shuffled epoch stream.
  void claim(std::vector<int>* out) {
    std::lock_guard<std::mutex> lk(idx_mu);
    out->clear();
    for (int i = 0; i < batch; i++) {
      if (cursor >= order.size()) {
        cursor = 0;
        epoch++;
        if (shuffle) {
          std::shuffle(order.begin(), order.end(), rng);
        }
      }
      out->push_back(order[cursor++]);
    }
  }

  bool decode_into(const std::string& path, float* dst) {
    FILE* f = fopen(path.c_str(), "rb");
    if (!f) return false;
    NpyInfo info = parse_npy_header(f);
    if (!info.ok || info.h != h || info.w != w || info.c != c) {
      fclose(f);
      return false;
    }
    size_t n = sample_floats();
    bool ok = true;
    if (info.is_u8) {
      std::vector<unsigned char> buf(n);
      ok = fread(buf.data(), 1, n, f) == n;
      if (ok) {
        if (normalize) {
          for (size_t i = 0; i < n; i++) dst[i] = buf[i] / 127.5f - 1.0f;
        } else {
          for (size_t i = 0; i < n; i++) dst[i] = (float)buf[i];
        }
      }
    } else {
      ok = fread(dst, sizeof(float), n, f) == n;
      if (ok && normalize) {
        // float inputs are assumed pre-scaled; normalize only maps u8
      }
    }
    fclose(f);
    return ok;
  }

  void worker_loop() {
    std::vector<int> ids;
    size_t bfloats = (size_t)batch * sample_floats();
    while (!stop.load()) {
      claim(&ids);
      std::vector<float> out(bfloats);
      for (int i = 0; i < batch; i++) {
        float* dst = out.data() + (size_t)i * sample_floats();
        if (!decode_into(paths[ids[i]], dst)) {
          memset(dst, 0, sample_floats() * sizeof(float));
          decode_errors.fetch_add(1);
        }
      }
      std::unique_lock<std::mutex> lk(q_mu);
      q_push_cv.wait(lk, [&] { return stop.load() || ready.size() < queue_depth; });
      if (stop.load()) return;
      ready.push_back(std::move(out));
      batches_produced.fetch_add(1);
      q_pop_cv.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* gx_open(const char** paths, int n_paths, int batch, int h, int w, int c,
              int queue_depth, int n_threads, unsigned seed, int shuffle,
              int normalize) {
  if (n_paths <= 0 || batch <= 0) return nullptr;
  Loader* L = new Loader();
  L->paths.reserve(n_paths);
  for (int i = 0; i < n_paths; i++) L->paths.emplace_back(paths[i]);
  L->batch = batch; L->h = h; L->w = w; L->c = c;
  L->queue_depth = queue_depth > 0 ? queue_depth : 4;
  L->shuffle = shuffle != 0;
  L->normalize = normalize != 0;
  L->seed = seed;
  L->rng.seed(seed);
  L->order.resize(n_paths);
  for (int i = 0; i < n_paths; i++) L->order[i] = i;
  if (L->shuffle) std::shuffle(L->order.begin(), L->order.end(), L->rng);
  int nt = n_threads > 0 ? n_threads : 2;
  for (int t = 0; t < nt; t++) {
    L->workers.emplace_back([L] { L->worker_loop(); });
  }
  return L;
}

// Blocking pop of one (batch, h, w, c) float32 batch into `out`. The time it
// waits on an empty queue (the workers behind) is gx_last_starved_ns's.
int gx_next(void* handle, float* out) {
  Loader* L = static_cast<Loader*>(handle);
  std::vector<float> b;
  {
    std::unique_lock<std::mutex> lk(L->q_mu);
    long long starved = 0;
    if (!L->stop.load() && L->ready.empty()) {
      auto t0 = std::chrono::steady_clock::now();
      L->q_pop_cv.wait(lk, [&] { return L->stop.load() || !L->ready.empty(); });
      starved = std::chrono::duration_cast<std::chrono::nanoseconds>(
                    std::chrono::steady_clock::now() - t0).count();
    }
    L->last_starved_ns.store(starved);
    if (L->ready.empty()) return -1;
    b = std::move(L->ready.front());
    L->ready.pop_front();
    L->q_push_cv.notify_one();
  }
  memcpy(out, b.data(), b.size() * sizeof(float));
  return 0;
}

long long gx_last_starved_ns(void* handle) {
  return static_cast<Loader*>(handle)->last_starved_ns.load();
}

long gx_batches(void* handle) {
  return static_cast<Loader*>(handle)->batches_produced.load();
}

long gx_errors(void* handle) {
  return static_cast<Loader*>(handle)->decode_errors.load();
}

long gx_epoch(void* handle) {
  Loader* L = static_cast<Loader*>(handle);
  std::lock_guard<std::mutex> lk(L->idx_mu);
  return L->epoch;
}

void gx_close(void* handle) {
  Loader* L = static_cast<Loader*>(handle);
  L->stop.store(true);
  L->q_push_cv.notify_all();
  L->q_pop_cv.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
