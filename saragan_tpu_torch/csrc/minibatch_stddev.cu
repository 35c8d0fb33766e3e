// Minibatch standard-deviation statistic for Hopper (sm_90a).
//
// Replaces saragan_tpu/ops/pallas_kernels.py::minibatch_stddev_stat (entry :159, Pallas
// body _mbstd_kernel :148-156).  x is (N, F) after flattening each sample, in f32, bf16
// or f16; G samples form a group and group m holds samples m, m + groups, m + 2 groups,
// ... (the reference's reshape(G, groups, F)).  Per group, in f32:
//
//   mu_f = sum_i x[i, f] / G,  var_f = sum_i (x[i, f] - mu_f)^2 / G,  s_f = sqrt(var_f + eps)
//   out[m] = sum_f s_f / F                                  (the sum in f64, out in f32)
//
// (the divisions by G as a multiply by 1 / G: exact where G is a power of two, within an
// ulp otherwise)
//
// ops/minibatch_stddev.py holds the plain PyTorch version and the plan (mbstd_plan).
//
// What bounds it on the H100: x is read once and each element costs a few operations,
// so device memory (3.35 TB/s); at the small inputs the launch.  The design:
//   * an item is a chunk of features of one group: each of the block's WARPS warps takes
//     cv vectors of 32 lanes of it (cv = 8 where the items give every block of the grid
//     one, else fewer, so that a small input spreads over more warps).  A lane reads the
//     group's G rows with one 16-byte load per row (4 f32 or 8 bf16/f16 values; element
//     loads where a row does not start on 16 bytes) and keeps the G values of each
//     feature in registers, so mu and the centred variance (the reference's two-pass
//     formula) come from one read of x.  G is a template parameter for 1, 2, 4 and 8; any
//     other G up to 8 runs the same code over 8 guarded rows, and a larger G (a kernel of
//     its own) a loop that reads the rows twice, the second time from L1;
//   * blocks walk the items b, b + grid, ... (the plan balances the rounds); a lane adds
//     its features' s in a fixed order (f32 within a vector, f64 across vectors), the warp
//     adds its lanes in a fixed shuffle tree, thread 0 the warps in order, and the item's
//     f64 sum goes to the workspace, one entry per (group, chunk): the entries do not
//     depend on the grid;
//   * the last block to finish (a ticket: atomicAdd on a per-device counter after a
//     __threadfence; that block resets it) adds each group's entries in a fixed order
//     (thread t takes chunks t, t + THREADS, ..., then a fixed warp tree, groups in
//     batches of WARPS so that their loads overlap) and writes sum / F in f32.  No sum
//     uses atomics, so a rerun repeats bit for bit, and one call is one launch.
// The entry returns cudaGetLastError() after its launch, or cudaErrorInvalidValue for a
// plan it cannot run.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_REG_G = 8;  // the largest group a thread holds in registers

enum Dtype { F32 = 0, BF16 = 1, F16 = 2 };

struct Geo {
  long long F;        // features per sample
  int groups, g;      // groups, samples per group
  int cv;             // vectors per lane and item: an item is WARPS * 32 * cv * VEC features
  int chunks, items;  // items per group, items in all (group-major)
  float eps;
};

template <int DT>
__device__ __forceinline__ float from_bits16(unsigned int b) {
  if constexpr (DT == BF16) {
    return __uint_as_float(b << 16);
  } else {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(b)));
  }
}

// VEC consecutive values of one row, widened to f32: one 16-byte load (VEC > 1, the
// address on 16 bytes) or one element; a streaming load where x is read once, else one
// that L1 keeps for the second read
template <int DT, int VEC, bool STREAM>
__device__ __forceinline__ void load(const void* row, long long f, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    if constexpr (DT == F32) {
      const float* p = static_cast<const float*>(row) + f;
      v[0] = STREAM ? __ldcs(p) : __ldg(p);
    } else {
      const unsigned short* p = static_cast<const unsigned short*>(row) + f;
      v[0] = from_bits16<DT>(STREAM ? __ldcs(p) : __ldg(p));
    }
  } else {
    constexpr int ESIZE = DT == F32 ? 4 : 2;
    static_assert(VEC * ESIZE == 16, "one 16-byte word per load");
    const uint4* p = reinterpret_cast<const uint4*>(static_cast<const char*>(row) + f * ESIZE);
    const uint4 w = STREAM ? __ldcs(p) : __ldg(p);
    const unsigned int a[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if constexpr (DT == F32) {
        v[j] = __uint_as_float(a[j]);
      } else {
        v[j] = from_bits16<DT>((a[j >> 1] >> ((j & 1) * 16)) & 0xffffu);
      }
    }
  }
}

__device__ __forceinline__ const void* row_ptr(const void* x, int sample, long long F,
                                               int esize) {
  return static_cast<const char*>(x) + static_cast<long long>(sample) * F * esize;
}

// sum over the VEC features from f of sqrt(var + eps), in f32 in feature order, from the
// group's first n <= K rows held in registers: one streaming read
template <int DT, int K, int VEC>
__device__ __forceinline__ float stat_in_registers(const void* x, int m, long long f,
                                                   const Geo& g, int n) {
  constexpr int ESIZE = DT == F32 ? 4 : 2;
  float v[K][VEC];
#pragma unroll
  for (int i = 0; i < K; ++i)
    if (i < n) load<DT, VEC, true>(row_ptr(x, i * g.groups + m, g.F, ESIZE), f, v[i]);
  // a multiply by 1 / n, not two IEEE divisions a feature: exact for the template sizes
  // (powers of two), within an ulp otherwise
  const float inv = 1.f / static_cast<float>(n);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i)
      if (i < n) s1 += v[i][j];
    const float mu = s1 * inv;
#pragma unroll
    for (int i = 0; i < K; ++i)
      if (i < n) {
        const float d = v[i][j] - mu;
        s2 += d * d;
      }
    s += sqrtf(s2 * inv + g.eps);
  }
  return s;
}

// the same for a group of any size: the rows are read twice, the second time from L1,
// four rows' loads in flight at a time
template <int DT, int VEC>
__device__ __forceinline__ float stat_two_reads(const void* x, int m, long long f,
                                                const Geo& g) {
  constexpr int ESIZE = DT == F32 ? 4 : 2;
  float mu[VEC], s2[VEC], v[4][VEC];
  auto four_rows = [&](int i0) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i0 + k < g.g)
        load<DT, VEC, false>(row_ptr(x, (i0 + k) * g.groups + m, g.F, ESIZE), f, v[k]);
  };
#pragma unroll
  for (int j = 0; j < VEC; ++j) mu[j] = 0.f, s2[j] = 0.f;
  for (int i0 = 0; i0 < g.g; i0 += 4) {
    four_rows(i0);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i0 + k < g.g) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) mu[j] += v[k][j];
      }
  }
  const float inv = 1.f / static_cast<float>(g.g);
#pragma unroll
  for (int j = 0; j < VEC; ++j) mu[j] = mu[j] * inv;
  for (int i0 = 0; i0 < g.g; i0 += 4) {
    four_rows(i0);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i0 + k < g.g) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float d = v[k][j] - mu[j];
          s2[j] += d * d;
        }
      }
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < VEC; ++j) s += sqrtf(s2[j] * inv + g.eps);
  return s;
}

// G > 0: a template size; G == 0: any G up to MAX_REG_G, in registers; G == -1: any G,
// read twice (separate instantiations: one kernel holding both paths spills)
template <int DT, int G, int VEC>
__device__ __forceinline__ float vector_stat(const void* x, int m, long long f, const Geo& g) {
  if constexpr (G > 0) {
    return stat_in_registers<DT, G, VEC>(x, m, f, g, G);
  } else if constexpr (G == 0) {
    return stat_in_registers<DT, MAX_REG_G, VEC>(x, m, f, g, g.g);
  } else {
    return stat_two_reads<DT, VEC>(x, m, f, g);
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;  // lane 0 holds the sum
}

// blocks an SM holds: 4 (at most 64 registers a thread), 2 where a thread keeps more than
// 32 values of its group in registers (G * VEC > 32, G counted as MAX_REG_G where it is
// not a template size); ops/minibatch_stddev.py::mbstd_blocks_per_sm sizes the grid by
// the same rule
template <int DT, int G, int VEC>
__global__ void __launch_bounds__(THREADS, ((G > 0 ? G : MAX_REG_G) * VEC > 32 ? 2 : 4))
    mbstd_kernel(const void* __restrict__ x, double* __restrict__ ws, int* __restrict__ counter,
                 float* __restrict__ out, Geo g) {
  __shared__ double red[2][WARPS];        // the warps' sums of an item, by item parity
  __shared__ double part[WARPS][THREADS];  // the final sum's per-thread partials
  __shared__ int last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long span = 32LL * g.cv * VEC;  // features of one warp's share of an item

  for (int item = blockIdx.x, k = 0; item < g.items; item += gridDim.x, k ^= 1) {
    const int m = item / g.chunks;
    const long long first = static_cast<long long>(item - m * g.chunks) * WARPS * span +
                            warp * span;
    double acc = 0.0;
#pragma unroll 1
    for (int u = 0; u < g.cv; ++u) {
      const long long f = first + static_cast<long long>(u * 32 + lane) * VEC;
      // VEC divides F (the plan takes VEC > 1 only then), so a vector is whole or absent
      if (f < g.F) acc += static_cast<double>(vector_stat<DT, G, VEC>(x, m, f, g));
    }
    acc = warp_sum(acc);
    if (lane == 0) red[k][warp] = acc;
    __syncthreads();  // red[k] is read below; red[k ^ 1] is the next item's
    if (threadIdx.x == 0) {
      double t = 0.0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) t += red[k][w];
      ws[item] = t;
    }
  }

  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // every entry is written.  Groups in batches of WARPS: thread t adds entries t,
  // t + THREADS, ... of each group of the batch, then warp q adds group q's partials
  // (lane l: l, l + 32, ...) and its lanes; every order fixed by the shapes alone
  for (int m0 = 0; m0 < g.groups; m0 += WARPS) {
    const int nb = g.groups - m0 < WARPS ? g.groups - m0 : WARPS;
    for (int q = 0; q < nb; ++q) {
      const double* row = ws + static_cast<long long>(m0 + q) * g.chunks;
      double a = 0.0;
#pragma unroll 4
      for (int c = threadIdx.x; c < g.chunks; c += THREADS) a += __ldcg(row + c);
      part[q][threadIdx.x] = a;
    }
    __syncthreads();
    if (warp < nb) {
      double a = 0.0;
#pragma unroll
      for (int t = lane; t < THREADS; t += 32) a += part[warp][t];
      a = warp_sum(a);
      if (lane == 0) out[m0 + warp] = static_cast<float>(a / static_cast<double>(g.F));
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) *counter = 0;  // ready for the next launch on this stream
}

template <int DT, int VEC>
int launch_g(int gt, const void* x, double* ws, int* counter, float* out, const Geo& g,
             int blocks, cudaStream_t s) {
  switch (gt) {
    case -1: mbstd_kernel<DT, -1, VEC><<<blocks, THREADS, 0, s>>>(x, ws, counter, out, g); break;
    case 0: mbstd_kernel<DT, 0, VEC><<<blocks, THREADS, 0, s>>>(x, ws, counter, out, g); break;
    case 1: mbstd_kernel<DT, 1, VEC><<<blocks, THREADS, 0, s>>>(x, ws, counter, out, g); break;
    case 2: mbstd_kernel<DT, 2, VEC><<<blocks, THREADS, 0, s>>>(x, ws, counter, out, g); break;
    case 4: mbstd_kernel<DT, 4, VEC><<<blocks, THREADS, 0, s>>>(x, ws, counter, out, g); break;
    case 8: mbstd_kernel<DT, 8, VEC><<<blocks, THREADS, 0, s>>>(x, ws, counter, out, g); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int DT>
int launch_vec(bool vec16, int gt, const void* x, double* ws, int* counter, float* out,
               const Geo& g, int blocks, cudaStream_t s) {
  constexpr int V = DT == F32 ? 4 : 8;
  return vec16 ? launch_g<DT, V>(gt, x, ws, counter, out, g, blocks, s)
               : launch_g<DT, 1>(gt, x, ws, counter, out, g, blocks, s);
}

}  // namespace

// x (n, feat) contiguous of dtype (0 f32, 1 bf16, 2 f16); ws holds `chunks * groups`
// doubles; counter one int, 0 between launches; out (groups,) f32.  The plan (vec, gt,
// cv, blocks) comes from ops/minibatch_stddev.py::mbstd_plan and is checked here.
extern "C" int saragan_mbstd(const void* x, void* ws, void* counter, void* out, int dtype,
                             long long n, long long feat, int g, int vec, int gt, int cv,
                             int blocks, float eps, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (dtype < F32 || dtype > F16 || n <= 0 || feat <= 0 || g <= 0 || n % g != 0) return bad;
  const int esize = dtype == F32 ? 4 : 2;
  const int v16 = 16 / esize;
  if (vec != 1 && vec != v16) return bad;
  if (vec == v16 && ((feat * esize) % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0))
    return bad;
  if (gt > 0 ? gt != g : gt == 0 ? g > MAX_REG_G : gt != -1) return bad;
  if (cv < 1 || cv > 64) return bad;
  const long long chunk = static_cast<long long>(WARPS) * 32 * cv * vec;
  const long long groups = n / g;
  const long long chunks = (feat + chunk - 1) / chunk;
  if (groups * chunks > INT_MAX || n > INT_MAX)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  Geo geo{};
  geo.F = feat, geo.groups = static_cast<int>(groups), geo.g = g;
  geo.cv = cv, geo.chunks = static_cast<int>(chunks);
  geo.items = static_cast<int>(groups * chunks);
  geo.eps = eps;
  if (blocks <= 0 || blocks > geo.items) return bad;
  auto* w = static_cast<double*>(ws);
  auto* c = static_cast<int*>(counter);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32: return launch_vec<F32>(vec != 1, gt, x, w, c, o, geo, blocks, s);
    case BF16: return launch_vec<BF16>(vec != 1, gt, x, w, c, o, geo, blocks, s);
    default: return launch_vec<F16>(vec != 1, gt, x, w, c, o, geo, blocks, s);
  }
}

extern "C" const char* saragan_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
