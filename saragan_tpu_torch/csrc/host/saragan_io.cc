// saragan_io: the port's native data-loading library (its own copy of the JAX
// package's runtime/saragan_io.cc, so the port's loader can change without touching
// the reference's tree).  Bound with ctypes by saragan_tpu_torch/data/native.py:
//
//   * saragan_npy_probe   - parse a .npy header (v1/v2), return shape+dtype
//   * saragan_npy_read    - decode one file into a caller buffer (mmap'd)
//   * saragan_npy_read_batch - decode N same-shape files into a contiguous
//                           float32 batch with a thread pool, converting
//                           dtype on the fly (int16 CT volumes -> float32)
//   * saragan_pf_*        - prefetch executor: a worker pool + FIFO ring of
//                           in-flight batch jobs (decode + affine
//                           normalization + f16/bf16 rounding off the GIL),
//                           consumed in submit order.  Python keeps the
//                           deterministic shuffle/shard path selection.
//
// Built with g++ at first use by saragan_tpu_torch/ops/_build.py (build_host),
// together with saragan_jpeg.cc, into saragan_tpu_torch/build/.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

enum DtypeCode {
  DT_UNKNOWN = 0,
  DT_F32 = 1,
  DT_F64 = 2,
  DT_I16 = 3,
  DT_I32 = 4,
  DT_I64 = 5,
  DT_U8 = 6,
  DT_F16 = 7,
};

struct NpyInfo {
  int64_t shape[8];
  int ndim = 0;
  DtypeCode dtype = DT_UNKNOWN;
  size_t data_offset = 0;
  size_t data_bytes = 0;
};

size_t dtype_size(DtypeCode d) {
  switch (d) {
    case DT_F32: case DT_I32: return 4;
    case DT_F64: case DT_I64: return 8;
    case DT_I16: case DT_F16: return 2;
    case DT_U8: return 1;
    default: return 0;
  }
}

DtypeCode parse_descr(const std::string& descr) {
  // descr like "<f4", "|u1", "<i2" ... big-endian unsupported.
  if (descr.size() < 3) return DT_UNKNOWN;
  if (descr[0] == '>') return DT_UNKNOWN;
  const char kind = descr[1];
  const char size = descr[2];
  if (kind == 'f' && size == '4') return DT_F32;
  if (kind == 'f' && size == '8') return DT_F64;
  if (kind == 'f' && size == '2') return DT_F16;
  if (kind == 'i' && size == '2') return DT_I16;
  if (kind == 'i' && size == '4') return DT_I32;
  if (kind == 'i' && size == '8') return DT_I64;
  if (kind == 'u' && size == '1') return DT_U8;
  return DT_UNKNOWN;
}

// Minimal .npy header parser (format spec v1.0/v2.0). Returns false on any
// malformed/unsupported input (fortran order, big endian, >8 dims).
bool parse_npy_header(const uint8_t* buf, size_t len, NpyInfo* info) {
  static const uint8_t magic[] = {0x93, 'N', 'U', 'M', 'P', 'Y'};
  if (len < 10 || memcmp(buf, magic, 6) != 0) return false;
  const int major = buf[6];
  size_t header_len, header_start;
  if (major == 1) {
    header_len = buf[8] | (buf[9] << 8);
    header_start = 10;
  } else {
    if (len < 12) return false;
    header_len = buf[8] | (buf[9] << 8) | (buf[10] << 16) |
                 (static_cast<size_t>(buf[11]) << 24);
    header_start = 12;
  }
  if (header_start + header_len > len) return false;
  std::string header(reinterpret_cast<const char*>(buf + header_start), header_len);

  // descr
  size_t p = header.find("'descr'");
  if (p == std::string::npos) return false;
  p = header.find('\'', p + 7);
  if (p == std::string::npos) return false;
  size_t q = header.find('\'', p + 1);
  if (q == std::string::npos) return false;
  info->dtype = parse_descr(header.substr(p + 1, q - p - 1));
  if (info->dtype == DT_UNKNOWN) return false;

  // fortran_order must be False
  p = header.find("'fortran_order'");
  if (p == std::string::npos) return false;
  if (header.find("False", p) == std::string::npos) return false;

  // shape tuple
  p = header.find("'shape'");
  if (p == std::string::npos) return false;
  p = header.find('(', p);
  q = header.find(')', p);
  if (p == std::string::npos || q == std::string::npos) return false;
  std::string shape_str = header.substr(p + 1, q - p - 1);
  info->ndim = 0;
  int64_t total = 1;
  const char* s = shape_str.c_str();
  while (*s) {
    while (*s == ' ' || *s == ',') s++;
    if (!*s) break;
    char* end = nullptr;
    long long v = strtoll(s, &end, 10);
    if (end == s) break;
    if (v < 0) return false;  // corrupt header: negative dim would wrap
                              // data_bytes and crash np.empty in the binding
    if (info->ndim >= 8) return false;
    info->shape[info->ndim++] = v;
    total *= v;
    s = end;
  }
  if (info->ndim == 0) {  // 0-d scalar
    info->shape[0] = 1;
  }
  info->data_offset = header_start + header_len;
  info->data_bytes = static_cast<size_t>(total) * dtype_size(info->dtype);
  return true;
}

struct MappedFile {
  const uint8_t* data = nullptr;
  size_t size = 0;
  int fd = -1;

  bool open_file(const char* path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0) { ::close(fd); fd = -1; return false; }
    size = st.st_size;
    data = static_cast<const uint8_t*>(mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0));
    if (data == MAP_FAILED) { data = nullptr; ::close(fd); fd = -1; return false; }
    // the reader walks the file front-to-back exactly once
    madvise(const_cast<uint8_t*>(data), size, MADV_SEQUENTIAL);
    return true;
  }

  ~MappedFile() {
    if (data) munmap(const_cast<uint8_t*>(data), size);
    if (fd >= 0) ::close(fd);
  }
};

template <typename T>
void convert_to_f32(const uint8_t* src, float* dst, size_t count) {
  const T* in = reinterpret_cast<const T*>(src);
  for (size_t i = 0; i < count; ++i) dst[i] = static_cast<float>(in[i]);
}

// fp16 -> fp32 (scalar; good enough for the loader path)
void convert_f16_to_f32(const uint8_t* src, float* dst, size_t count) {
  const uint16_t* in = reinterpret_cast<const uint16_t*>(src);
  for (size_t i = 0; i < count; ++i) {
    uint16_t h = in[i];
    uint32_t sign = (h & 0x8000u) << 16;
    uint32_t exp = (h >> 10) & 0x1f;
    uint32_t mant = h & 0x3ffu;
    uint32_t out;
    if (exp == 0) {
      if (mant == 0) {
        out = sign;
      } else {
        exp = 127 - 15 + 1;
        while (!(mant & 0x400u)) { mant <<= 1; exp--; }
        mant &= 0x3ffu;
        out = sign | (exp << 23) | (mant << 13);
      }
    } else if (exp == 31) {
      out = sign | 0x7f800000u | (mant << 13);
    } else {
      out = sign | ((exp - 15 + 127) << 23) | (mant << 13);
    }
    memcpy(&dst[i], &out, 4);
  }
}

// fp32 -> fp16 (scalar, round-to-nearest-even) — the --transfer_dtype
// float16 path: normalized batches are stored and shipped to Python at half
// width so the host->device transfer (and the relay's per-transfer host
// accumulation, see BASELINE.md) halves without an extra Python-side cast.
void convert_f32_to_f16(const float* src, uint16_t* dst, size_t count) {
  for (size_t i = 0; i < count; ++i) {
    uint32_t x;
    memcpy(&x, &src[i], 4);
    const uint32_t sign = (x >> 16) & 0x8000u;
    uint32_t exp = (x >> 23) & 0xffu;
    uint32_t mant = x & 0x7fffffu;
    uint16_t out;
    if (exp == 255) {  // inf / nan
      out = static_cast<uint16_t>(sign | 0x7c00u | (mant ? 0x200u : 0));
    } else if (exp >= 143) {  // >= 2^16 after rounding -> inf (143 = 127+16)
      out = static_cast<uint16_t>(sign | 0x7c00u);
    } else if (exp < 101) {  // < 2^-26: rounds to +-0 (smallest sub-ulp/2)
      out = static_cast<uint16_t>(sign);
    } else if (exp < 113) {  // subnormal half: h = round(mant_full >> shift)
      mant |= 0x800000u;                       // 24-bit significand
      const uint32_t shift = 126 - exp;        // 14..25 (exp 101..112)
      const uint32_t h = mant >> shift;
      const uint32_t rem = mant & ((1u << shift) - 1);
      const uint32_t half_ulp = 1u << (shift - 1);
      uint32_t r = h;
      if (rem > half_ulp || (rem == half_ulp && (h & 1u))) r += 1;  // RNE
      out = static_cast<uint16_t>(sign | r);
    } else {  // normal (may round up into inf, handled by carry into exp)
      uint32_t h = ((exp - 112) << 10) | (mant >> 13);
      const uint32_t rest = mant & 0x1fffu;
      if ((rest > 0x1000u) || (rest == 0x1000u && (h & 1u))) h += 1;  // RNE
      out = static_cast<uint16_t>(sign | h);
    }
    dst[i] = out;
  }
}

// fp32 -> bf16 (scalar, round-to-nearest-even) — the --transfer_dtype
// bfloat16 path: under bfloat16 compute this is BIT-EXACT vs shipping f32
// (the train step's first op performs the same RNE cast on device), at half
// the host->device bytes. Matches ml_dtypes' carry-based RNE exactly.
void convert_f32_to_bf16(const float* src, uint16_t* dst, size_t count) {
  for (size_t i = 0; i < count; ++i) {
    uint32_t x;
    memcpy(&x, &src[i], 4);
    if ((x & 0x7f800000u) == 0x7f800000u && (x & 0x7fffffu)) {
      // NaN: quiet it, keep sign — adding the rounding bias would corrupt
      // the exponent
      dst[i] = static_cast<uint16_t>((x >> 16) | 0x0040u);
      continue;
    }
    const uint32_t rounding = 0x7fffu + ((x >> 16) & 1u);  // RNE tie-to-even
    dst[i] = static_cast<uint16_t>((x + rounding) >> 16);
  }
}

bool decode_to_f32(const NpyInfo& info, const uint8_t* payload, float* dst) {
  const size_t count = info.data_bytes / dtype_size(info.dtype);
  switch (info.dtype) {
    case DT_F32: memcpy(dst, payload, info.data_bytes); return true;
    case DT_F64: convert_to_f32<double>(payload, dst, count); return true;
    case DT_I16: convert_to_f32<int16_t>(payload, dst, count); return true;
    case DT_I32: convert_to_f32<int32_t>(payload, dst, count); return true;
    case DT_I64: convert_to_f32<int64_t>(payload, dst, count); return true;
    case DT_U8: convert_to_f32<uint8_t>(payload, dst, count); return true;
    case DT_F16: convert_f16_to_f32(payload, dst, count); return true;
    default: return false;
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// Prefetch executor
// ---------------------------------------------------------------------------

namespace {

int decode_one_to_f32(const char* path, float* out, int64_t bytes_per_item) {
  MappedFile f;
  if (!f.open_file(path)) return 1;
  NpyInfo info;
  if (!parse_npy_header(f.data, f.size, &info)) return 2;
  const size_t count = info.data_bytes / dtype_size(info.dtype);
  if (static_cast<int64_t>(count * 4) != bytes_per_item) return 3;
  if (info.data_offset + info.data_bytes > f.size) return 4;
  if (!decode_to_f32(info, f.data + info.data_offset, out)) return 5;
  return 0;
}

struct PrefetchJob {
  std::vector<std::string> paths;
  std::vector<float> buf;          // n_items * items floats (f32 output)
  std::vector<uint16_t> buf16;     // f16/bf16 output when out_code != 0
  float mean = 0.0f, stddev = 1.0f;
  int normalize = 0;
  int out_code = 0;                // output dtype: 0=f32, 1=f16, 2=bf16
  std::atomic<int> next_item{0};   // work-stealing index across workers
  std::atomic<int> items_done{0};
  std::atomic<int> status{0};      // first nonzero decode status wins
  int n_items = 0;
};

struct Prefetcher {
  int64_t bytes_per_item = 0;
  std::deque<std::shared_ptr<PrefetchJob>> fifo;  // submit order (front = next)
  std::deque<std::shared_ptr<PrefetchJob>> work;  // jobs with items remaining
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_work;   // workers wait for items
  std::condition_variable cv_done;   // consumer waits for head completion
  bool stopping = false;

  void worker_loop() {
    for (;;) {
      std::shared_ptr<PrefetchJob> job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] { return stopping || !work.empty(); });
        if (stopping) return;
        job = work.front();
        // claim an item; retire the job from the work deque when exhausted
        if (job->next_item.load() >= job->n_items) {
          work.pop_front();
          continue;
        }
      }
      for (;;) {
        const int i = job->next_item.fetch_add(1);
        if (i >= job->n_items) break;
        const int64_t items = bytes_per_item / 4;
        // half-width jobs decode+normalize in a per-thread f32 scratch, then
        // convert into the half-width output slot — the cast runs on the
        // worker pool, off the consumer's critical path
        thread_local std::vector<float> scratch;
        float* out;
        if (job->out_code) {
          scratch.resize(items);
          out = scratch.data();
        } else {
          out = job->buf.data() + static_cast<int64_t>(i) * items;
        }
        int rc = decode_one_to_f32(job->paths[i].c_str(), out, bytes_per_item);
        if (rc == 0 && job->normalize) {
          const float m = job->mean, s = job->stddev;
          for (int64_t k = 0; k < items; ++k) out[k] = (out[k] - m) / s;
        }
        if (rc == 0 && job->out_code) {
          uint16_t* slot = job->buf16.data() + static_cast<int64_t>(i) * items;
          if (job->out_code == 2) {
            convert_f32_to_bf16(out, slot, static_cast<size_t>(items));
          } else {
            convert_f32_to_f16(out, slot, static_cast<size_t>(items));
          }
        }
        if (rc != 0) {
          int expected = 0;
          job->status.compare_exchange_strong(expected, rc);
        }
        if (job->items_done.fetch_add(1) + 1 == job->n_items) {
          std::lock_guard<std::mutex> lk(mu);
          cv_done.notify_all();
        }
      }
    }
  }
};

}  // namespace

extern "C" {

void* saragan_pf_create(int64_t bytes_per_item, int num_workers) {
  if (bytes_per_item <= 0 || bytes_per_item % 4 != 0) return nullptr;
  auto* pf = new Prefetcher();
  pf->bytes_per_item = bytes_per_item;
  if (num_workers < 1) num_workers = 1;
  for (int i = 0; i < num_workers; ++i)
    pf->workers.emplace_back([pf] { pf->worker_loop(); });
  return pf;
}

// out_code: 0 = float32, 1 = float16 (RNE), 2 = bfloat16 (RNE, bit-exact
// under bfloat16 compute — see convert_f32_to_bf16)
int saragan_pf_submit_d(void* handle, const char** paths, int n,
                        float mean, float stddev, int normalize, int out_code) {
  auto* pf = static_cast<Prefetcher*>(handle);
  if (!pf || n <= 0) return 1;
  if (normalize && stddev == 0.0f) return 2;
  if (out_code < 0 || out_code > 2) return 4;
  auto job = std::make_shared<PrefetchJob>();
  job->n_items = n;
  job->paths.reserve(n);
  for (int i = 0; i < n; ++i) job->paths.emplace_back(paths[i]);
  const size_t items = static_cast<size_t>(n) * (pf->bytes_per_item / 4);
  job->out_code = out_code;
  if (job->out_code) {
    job->buf16.resize(items);
  } else {
    job->buf.resize(items);
  }
  job->mean = mean;
  job->stddev = stddev;
  job->normalize = normalize;
  {
    std::lock_guard<std::mutex> lk(pf->mu);
    pf->fifo.push_back(job);
    pf->work.push_back(job);
  }
  pf->cv_work.notify_all();
  return 0;
}

int saragan_pf_submit_t(void* handle, const char** paths, int n,
                        float mean, float stddev, int normalize, int out_f16) {
  return saragan_pf_submit_d(handle, paths, n, mean, stddev, normalize,
                             out_f16 ? 1 : 0);
}

int saragan_pf_submit(void* handle, const char** paths, int n,
                      float mean, float stddev, int normalize) {
  return saragan_pf_submit_d(handle, paths, n, mean, stddev, normalize, 0);
}

// Blocks until the OLDEST submitted job completes, copies it into dst
// (dst_bytes must equal n_items * bytes_per_item) and retires it.
int saragan_pf_next(void* handle, void* dst, int64_t dst_bytes) {
  auto* pf = static_cast<Prefetcher*>(handle);
  if (!pf) return 1;
  std::shared_ptr<PrefetchJob> job;
  {
    std::unique_lock<std::mutex> lk(pf->mu);
    if (pf->fifo.empty()) return 2;
    job = pf->fifo.front();
    pf->cv_done.wait(lk, [&] { return job->items_done.load() >= job->n_items; });
    pf->fifo.pop_front();
  }
  if (job->status.load() != 0) return 16 + job->status.load();
  const int64_t total = static_cast<int64_t>(job->n_items) * pf->bytes_per_item
                        / (job->out_code ? 2 : 1);
  if (total != dst_bytes) return 3;
  memcpy(dst, job->out_code ? static_cast<const void*>(job->buf16.data())
                           : static_cast<const void*>(job->buf.data()),
         total);
  return 0;
}

void saragan_pf_destroy(void* handle) {
  auto* pf = static_cast<Prefetcher*>(handle);
  if (!pf) return;
  {
    std::lock_guard<std::mutex> lk(pf->mu);
    pf->stopping = true;
  }
  pf->cv_work.notify_all();
  for (auto& t : pf->workers) t.join();
  delete pf;
}

int saragan_npy_probe(const char* path, int64_t* shape_out, int* ndim_out, int* dtype_out) {
  MappedFile f;
  if (!f.open_file(path)) return 1;
  NpyInfo info;
  if (!parse_npy_header(f.data, f.size, &info)) return 2;
  for (int i = 0; i < info.ndim; ++i) shape_out[i] = info.shape[i];
  *ndim_out = info.ndim;
  *dtype_out = static_cast<int>(info.dtype);
  return 0;
}

// Read raw (same-dtype) payload into dst (dst_bytes must match exactly).
int saragan_npy_read(const char* path, void* dst, int64_t dst_bytes) {
  MappedFile f;
  if (!f.open_file(path)) return 1;
  NpyInfo info;
  if (!parse_npy_header(f.data, f.size, &info)) return 2;
  if (static_cast<int64_t>(info.data_bytes) != dst_bytes) return 3;
  if (info.data_offset + info.data_bytes > f.size) return 4;
  memcpy(dst, f.data + info.data_offset, info.data_bytes);
  return 0;
}

// Decode n same-shape files into a contiguous float32 batch, converting
// dtype on the fly, with a thread pool.
int saragan_npy_read_batch(const char** paths, int n, void* dst,
                           int64_t bytes_per_item, int num_threads) {
  if (n <= 0) return 0;
  if (num_threads < 1) num_threads = 1;
  std::vector<int> results(n, 0);

  auto work = [&](int start, int stride) {
    for (int i = start; i < n; i += stride) {
      MappedFile f;
      if (!f.open_file(paths[i])) { results[i] = 1; continue; }
      NpyInfo info;
      if (!parse_npy_header(f.data, f.size, &info)) { results[i] = 2; continue; }
      const size_t count = info.data_bytes / dtype_size(info.dtype);
      if (static_cast<int64_t>(count * 4) != bytes_per_item) { results[i] = 3; continue; }
      if (info.data_offset + info.data_bytes > f.size) { results[i] = 4; continue; }
      float* out = reinterpret_cast<float*>(static_cast<uint8_t*>(dst) +
                                            static_cast<size_t>(i) * bytes_per_item);
      if (!decode_to_f32(info, f.data + info.data_offset, out)) results[i] = 5;
    }
  };

  if (num_threads == 1 || n == 1) {
    work(0, 1);
  } else {
    std::vector<std::thread> threads;
    int t = std::min(num_threads, n);
    threads.reserve(t);
    for (int i = 0; i < t; ++i) threads.emplace_back(work, i, t);
    for (auto& th : threads) th.join();
  }
  for (int r : results)
    if (r != 0) return r;
  return 0;
}

}  // extern "C"
