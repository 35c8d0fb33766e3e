// Fused bias + leaky ReLU + pixel norm, forward and backward, for Hopper (sm_90a).
//
// Replaces saragan_tpu/ops/pallas_kernels.py::fused_bias_act_pixelnorm (entry :112, Pallas
// body _fused_kernel :55-98) and the VJP of its custom JVP (_fused_jvp :123-131, the
// unfused oracle _reference_forward :100-108 linearised).  x is (N, C, S) after flattening
// the spatial dimensions, b is (C,) in f32, x in f32 or bf16:
//
//   forward:   y = lrelu(x + b, alpha) * rsqrt(mean_c y^2 + eps)        per voxel
//              (f32 math, the f32 bias unrounded, one rounding to x's type at the store)
//   backward:  u = rnd(x + rnd(b)),  a = u >= 0 ? u : rnd(u * alpha)     (rnd: to x's type)
//              r = rsqrt(sum_c a^2 / C + eps),  s = sum_c g a                (f32)
//              ga = rnd(g r - a (r^3 s / C)),  gx = u >= 0 ? ga : rnd(ga * alpha)
//              gb = rnd(f32(sum_{n, voxels} gx in f64))
//   (without pixel norm: y = lrelu(x + b), ga = rnd(g)).  ops/fused_bias_act.py holds the
//   plain PyTorch versions of both.
//
// What bounds both on the H100: a few operations per byte, so device memory (3.35 TB/s).
// The forward reads x and writes y once, the backward reads x and gy and writes gx once.
// The TPU kernel takes a (C, T) block of one sample per grid step and reduces over its
// sublanes; here:
//   * blocks are persistent (blocks_per_sm per SM, the host plan
//     ops/fused_bias_act.py::fused_plan) and block b walks the items b, b + grid, ...; an
//     item is TV voxels (a power of two) of one sample, every channel;
//   * an item's rows (C rows of TV voxels; x and gy in the backward) land in shared
//     memory by 16-byte cp.async copies, zero-filled past S, in a ring of two stages: the
//     next item's copies are in flight while this one computes.  Where a row does not
//     start on 16 bytes (S * size % 16 != 0, or a misaligned view) the rows are copied
//     element by element instead, synchronously;
//   * the thread that owns a voxel sums its channel terms in registers, c = 0 .. C-1 in
//     that order, whatever the plan: no shuffle and no barrier per voxel, and a sample's
//     y and gx do not depend on N, on its slot or on the grid.  At C = 16 and 32 (the
//     flagship's largest activations) the thread keeps its voxels' values in registers
//     from the sums to the outputs (CU); otherwise it leaves its voxels' statistics in
//     shared memory and the whole block computes the outputs, (channel, voxel) pairs
//     spread over its threads, so wide channels at few voxels keep every thread busy.
//     Outputs overwrite the inputs in shared memory, and the block stores the rows to
//     device memory in 16-byte words;
//   * the backward also sums gx per channel: lane j of a channel's G lanes adds the
//     item's voxels j, j + G, ... in f64 (four interleaved sums, added in a fixed order)
//     into a partial held across items; at the end the block adds its lanes' partials in
//     lane order into one workspace row (f64).  The last block to finish (a ticket:
//     atomicAdd on a per-device counter after a __threadfence) adds the rows in row
//     order, rounds the sums, writes gb and resets the counter.  No sum uses atomics, so
//     gx and gb repeat bit for bit, and a backward call is one launch.
// The TPU kernel's custom JVP recomputes the unfused jnp oracle for the tangent; here the
// backward is a kernel of its own: that oracle's VJP in closed form.
// Each entry returns cudaGetLastError() after its launch, or cudaErrorInvalidValue for a
// plan it cannot run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 2;        // __launch_bounds__: at most 128 registers a thread
constexpr size_t MAX_SMEM = 232448;  // 227 KB usable by one block
constexpr int MAX_TV = 1024;         // voxels per item: VPT = TV / THREADS <= 4
constexpr int MAX_CPT = 4;           // channel rows a thread sums in gb's pass (C <= 1024)

struct Geo {
  long long S;       // voxels per channel row
  int C, TV, ltv;    // channels; voxels per item (a power of two) and its log2
  int RS;            // shared row stride in elements: TV + one 16-byte word
  int tiles, items;  // items per sample, items in all
  int G, lg;         // backward: lanes per channel row in gb's pass (a power of two)
  float alpha, eps;
};

__host__ __device__ constexpr int ilog2(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

__host__ __device__ constexpr bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

__host__ __device__ constexpr size_t round_up(size_t v, size_t m) { return (v + m - 1) / m * m; }

// The byte layout of dynamic shared memory: two ring stages, the bias, the per-voxel
// statistics (r; and t in the backward), the backward's partials (f64) and the
// last-block flag.  fused_plan computes the same.
struct Layout {
  size_t stage, bias, stat, part, flag, total;
};

__host__ __device__ inline Layout layout(int c, int tv, int esize, bool backward) {
  Layout l{};
  l.stage = static_cast<size_t>(c) * (tv + 16 / esize) * esize * (backward ? 2 : 1);
  l.bias = 2 * l.stage;
  l.stat = round_up(l.bias + 4 * static_cast<size_t>(c), 16);
  l.part = round_up(l.stat + 4 * static_cast<size_t>(tv) * (backward ? 2 : 1), 16);
  l.flag = l.part + (backward ? 8 * static_cast<size_t>(c > THREADS ? c : THREADS) : 0);
  l.total = l.flag + 16;
  return l;
}

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back: the rounding of an op the oracle computes in x's type
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes by cp.async; zeros when `in` is false (nothing is read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows c = 0 .. C-1 of sample `src` (C x S), voxels [v0, v0 + TV), into `dst` at row
// stride RS; zeros past S.
template <typename T, bool ASYNC>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src, long long v0,
                                           const Geo& g) {
  if constexpr (ASYNC) {
    constexpr int VE = 16 / sizeof(T);
    const int lpr = g.ltv - ilog2(VE);  // 16-byte words per row: 2^lpr
    const int total = g.C << lpr;
    for (int i = threadIdx.x; i < total; i += THREADS) {
      const int c = i >> lpr, k = i & ((1 << lpr) - 1);
      const long long v = v0 + static_cast<long long>(k) * VE;
      const bool in = v < g.S;
      cp_async16(smem_u32(dst + c * g.RS + k * VE), in ? src + c * g.S + v : src, in);
    }
  } else {
    const int total = g.C << g.ltv;
    for (int i = threadIdx.x; i < total; i += THREADS) {
      const int c = i >> g.ltv, k = i & (g.TV - 1);
      const long long v = v0 + k;
      dst[c * g.RS + k] = v < g.S ? src[c * g.S + v] : from_f<T>(0.f);
    }
  }
}

// The item's rows from shared memory to sample `dst`, voxels below S only.
template <typename T, bool ASYNC>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, const T* src, long long v0,
                                           const Geo& g) {
  if constexpr (ASYNC) {
    constexpr int VE = 16 / sizeof(T);
    const int lpr = g.ltv - ilog2(VE);
    const int total = g.C << lpr;
    for (int i = threadIdx.x; i < total; i += THREADS) {
      const int c = i >> lpr, k = i & ((1 << lpr) - 1);
      const long long v = v0 + static_cast<long long>(k) * VE;
      if (v < g.S)
        *reinterpret_cast<uint4*>(dst + c * g.S + v) =
            *reinterpret_cast<const uint4*>(src + c * g.RS + k * VE);
    }
  } else {
    const int total = g.C << g.ltv;
    for (int i = threadIdx.x; i < total; i += THREADS) {
      const int c = i >> g.ltv, k = i & (g.TV - 1);
      const long long v = v0 + k;
      if (v < g.S) dst[c * g.S + v] = src[c * g.RS + k];
    }
  }
}

// The forward's arithmetic on one staged item, in place: every voxel's y, scaled by its
// r.  Each square is rounded before it is added, as the plain version's torch.square
// rounds it: a fused multiply-add would move most sums by a rounding, and the f32 step's
// engine comparison in chip_smoke.py is sensitive to that.  CU > 0 (C == CU, pixel norm on): the thread keeps its voxels' values in registers
// from the sum to the scaling.  CU == 0: the owning thread sums and writes r to `stat`,
// then the block writes every element, (channel, voxel) pairs spread over its threads.
template <typename T, bool PN, int VPT, int CU>
__device__ __forceinline__ void forward_item(T* cur, const float* bias, float* stat,
                                             const Geo& g) {
  const int tid = threadIdx.x;
  if constexpr (CU > 0) {
    if (tid < g.TV) {
      float v[CU][VPT], r[VPT];
#pragma unroll
      for (int c = 0; c < CU; ++c) {
#pragma unroll
        for (int i = 0; i < VPT; ++i) {
          const float y = to_f<T>(cur[c * g.RS + tid + i * THREADS]) + bias[c];
          v[c][i] = y >= 0.f ? y : y * g.alpha;
        }
      }
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        r[i] = 0.f;
#pragma unroll
        for (int c = 0; c < CU; ++c) r[i] = __fadd_rn(r[i], __fmul_rn(v[c][i], v[c][i]));
        r[i] = rsqrtf(r[i] / static_cast<float>(CU) + g.eps);
      }
#pragma unroll
      for (int c = 0; c < CU; ++c) {
#pragma unroll
        for (int i = 0; i < VPT; ++i) cur[c * g.RS + tid + i * THREADS] = from_f<T>(v[c][i] * r[i]);
      }
    }
  } else {
    if constexpr (PN) {
      if (tid < g.TV) {
        float r[VPT];
#pragma unroll
        for (int i = 0; i < VPT; ++i) r[i] = 0.f;
#pragma unroll 4
        for (int c = 0; c < g.C; ++c) {
          const T* row = cur + c * g.RS + tid;
          const float bc = bias[c];
#pragma unroll
          for (int i = 0; i < VPT; ++i) {
            float y = to_f<T>(row[i * THREADS]) + bc;
            y = y >= 0.f ? y : y * g.alpha;
            r[i] = __fadd_rn(r[i], __fmul_rn(y, y));
          }
        }
#pragma unroll
        for (int i = 0; i < VPT; ++i)
          stat[tid + i * THREADS] = rsqrtf(r[i] / static_cast<float>(g.C) + g.eps);
      }
      __syncthreads();
    }
    const int total = g.C << g.ltv;
    for (int e = tid; e < total; e += THREADS) {
      const int c = e >> g.ltv, v = e & (g.TV - 1);
      T* p = cur + c * g.RS + v;
      float y = to_f<T>(*p) + bias[c];
      y = y >= 0.f ? y : y * g.alpha;
      *p = from_f<T>(PN ? y * stat[v] : y);
    }
  }
}

template <typename T, bool ASYNC, bool PN, int VPT, int CU>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    fused_fwd_kernel(const T* __restrict__ x, const float* __restrict__ b, T* __restrict__ y,
                     const Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(g.C, g.TV, sizeof(T), false);
  T* ring = reinterpret_cast<T*>(smem);
  const int stage = g.C * g.RS;
  float* bias = reinterpret_cast<float*>(smem + L.bias);
  float* stat = reinterpret_cast<float*>(smem + L.stat);
  for (int c = threadIdx.x; c < g.C; c += THREADS) bias[c] = b[c];

  auto sample = [&](int item) { return static_cast<long long>(item / g.tiles) * g.C * g.S; };
  auto first = [&](int item) { return static_cast<long long>(item % g.tiles) << g.ltv; };

  int item = blockIdx.x;
  stage_rows<T, ASYNC>(ring, x + sample(item), first(item), g);
  cp_async_commit();
  for (int k = 0; item < g.items; ++k, item += gridDim.x) {
    T* cur = ring + (k & 1) * stage;
    const int next = item + gridDim.x;
    if (next < g.items) {  // its stage was freed by the barrier that ended item - grid
      stage_rows<T, ASYNC>(ring + ((k + 1) & 1) * stage, x + sample(next), first(next), g);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    forward_item<T, PN, VPT, CU>(cur, bias, stat, g);
    __syncthreads();
    store_rows<T, ASYNC>(y + sample(item), cur, first(item), g);
    __syncthreads();
  }
}

// The backward's arithmetic on one staged item: gx over gy's rows.  Per voxel (f32):
// r = rsqrt(sum a^2 / C + eps), t = r^3 (sum g a) / C, summed by the owning thread in
// channel order; CU > 0 keeps u and g in registers between the sums and gx, CU == 0
// writes (r, t) to `stat` and spreads the (channel, voxel) pairs over the block.
template <typename T>
__device__ __forceinline__ float grad_x(float u, float gv, float r, float t, float alpha,
                                        bool pn) {
  float ga = gv;
  if (pn) {
    const float a = u >= 0.f ? u : rnd<T>(u * alpha);
    ga = __fsub_rn(__fmul_rn(gv, r), __fmul_rn(a, t));
  }
  ga = rnd<T>(ga);
  return u >= 0.f ? ga : ga * alpha;
}

template <typename T, bool PN, int VPT, int CU>
__device__ __forceinline__ void backward_item(const T* cx, T* cg, const float* bias, float* stat,
                                              const Geo& g) {
  const int tid = threadIdx.x;
  if constexpr (CU > 0) {
    if (tid < g.TV) {
      float u[CU][VPT], gv[CU][VPT], r[VPT], t[VPT];
#pragma unroll
      for (int c = 0; c < CU; ++c) {
#pragma unroll
        for (int i = 0; i < VPT; ++i) {
          u[c][i] = rnd<T>(to_f<T>(cx[c * g.RS + tid + i * THREADS]) + bias[c]);
          gv[c][i] = to_f<T>(cg[c * g.RS + tid + i * THREADS]);
        }
      }
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        float sa = 0.f, sg = 0.f;
#pragma unroll
        for (int c = 0; c < CU; ++c) {
          const float a = u[c][i] >= 0.f ? u[c][i] : rnd<T>(u[c][i] * g.alpha);
          sa = fmaf(a, a, sa);
          sg = fmaf(gv[c][i], a, sg);
        }
        r[i] = rsqrtf(sa / static_cast<float>(CU) + g.eps);
        t[i] = r[i] * r[i] * r[i] * sg / static_cast<float>(CU);
      }
#pragma unroll
      for (int c = 0; c < CU; ++c) {
#pragma unroll
        for (int i = 0; i < VPT; ++i)
          cg[c * g.RS + tid + i * THREADS] =
              from_f<T>(grad_x<T>(u[c][i], gv[c][i], r[i], t[i], g.alpha, true));
      }
    }
  } else {
    if constexpr (PN) {
      if (tid < g.TV) {
        float sa[VPT], sg[VPT];
#pragma unroll
        for (int i = 0; i < VPT; ++i) sa[i] = sg[i] = 0.f;
#pragma unroll 4
        for (int c = 0; c < g.C; ++c) {
          const T* xr = cx + c * g.RS + tid;
          const T* gr = cg + c * g.RS + tid;
          const float bc = bias[c];
#pragma unroll
          for (int i = 0; i < VPT; ++i) {
            const float u = rnd<T>(to_f<T>(xr[i * THREADS]) + bc);
            const float a = u >= 0.f ? u : rnd<T>(u * g.alpha);
            sa[i] = fmaf(a, a, sa[i]);
            sg[i] = fmaf(to_f<T>(gr[i * THREADS]), a, sg[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < VPT; ++i) {
          const float r = rsqrtf(sa[i] / static_cast<float>(g.C) + g.eps);
          stat[tid + i * THREADS] = r;
          stat[g.TV + tid + i * THREADS] = r * r * r * sg[i] / static_cast<float>(g.C);
        }
      }
      __syncthreads();
    }
    const int total = g.C << g.ltv;
    for (int e = tid; e < total; e += THREADS) {
      const int c = e >> g.ltv, v = e & (g.TV - 1);
      const float u = rnd<T>(to_f<T>(cx[c * g.RS + v]) + bias[c]);
      T* p = cg + c * g.RS + v;
      *p = from_f<T>(grad_x<T>(u, to_f<T>(*p), PN ? stat[v] : 0.f, PN ? stat[g.TV + v] : 0.f,
                               g.alpha, PN));
    }
  }
}

template <typename T, bool ASYNC, bool PN, int VPT, int CU>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    fused_bwd_kernel(const T* __restrict__ x, const float* __restrict__ b,
                     const T* __restrict__ gy, T* __restrict__ gx, float* __restrict__ gb,
                     double* __restrict__ ws, int* __restrict__ counter, const Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(g.C, g.TV, sizeof(T), true);
  T* ring = reinterpret_cast<T*>(smem);
  const int rows = g.C * g.RS;  // one tensor's rows; a stage holds x's, then gy's
  float* bias = reinterpret_cast<float*>(smem + L.bias);
  float* stat = reinterpret_cast<float*>(smem + L.stat);
  double* part_s = reinterpret_cast<double*>(smem + L.part);
  int* last_s = reinterpret_cast<int*>(smem + L.flag);
  for (int c = threadIdx.x; c < g.C; c += THREADS) bias[c] = rnd<T>(b[c]);

  auto sample = [&](int item) { return static_cast<long long>(item / g.tiles) * g.C * g.S; };
  auto first = [&](int item) { return static_cast<long long>(item % g.tiles) << g.ltv; };
  auto stage_item = [&](int item, T* dst) {
    stage_rows<T, ASYNC>(dst, x + sample(item), first(item), g);
    stage_rows<T, ASYNC>(dst + rows, gy + sample(item), first(item), g);
    cp_async_commit();
  };

  // f64 sums of gx: lane (c, j) of channel row c adds voxels j, j + G, ... of each item,
  // in four interleaved sums that it adds in a fixed order at the end of the item
  double part[MAX_CPT];
#pragma unroll
  for (int m = 0; m < MAX_CPT; ++m) part[m] = 0.0;

  int item = blockIdx.x;
  stage_item(item, ring);
  for (int k = 0; item < g.items; ++k, item += gridDim.x) {
    T* cx = ring + (k & 1) * 2 * rows;
    T* cg = cx + rows;  // gy's rows, overwritten by gx's
    const int next = item + gridDim.x;
    if (next < g.items) {
      stage_item(next, ring + ((k + 1) & 1) * 2 * rows);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    backward_item<T, PN, VPT, CU>(cx, cg, bias, stat, g);
    __syncthreads();
    store_rows<T, ASYNC>(gx + sample(item), cg, first(item), g);
    const long long valid = g.S - first(item);
    const int nv = valid < g.TV ? static_cast<int>(valid) : g.TV;
#pragma unroll
    for (int m = 0; m < MAX_CPT; ++m) {
      const int lane = threadIdx.x + m * THREADS;
      const int c = lane >> g.lg, j = lane & (g.G - 1);
      if (c < g.C) {
        const T* row = cg + c * g.RS;
        double s0 = 0.0, s1 = 0.0, s2 = 0.0, s3 = 0.0;
        int v = j;
        for (; v + 3 * g.G < nv; v += 4 * g.G) {
          s0 += static_cast<double>(to_f<T>(row[v]));
          s1 += static_cast<double>(to_f<T>(row[v + g.G]));
          s2 += static_cast<double>(to_f<T>(row[v + 2 * g.G]));
          s3 += static_cast<double>(to_f<T>(row[v + 3 * g.G]));
        }
        for (; v < nv; v += g.G) s0 += static_cast<double>(to_f<T>(row[v]));
        part[m] += (s0 + s1) + (s2 + s3);
      }
    }
    __syncthreads();
  }

  // this block's row of the workspace: each channel's lanes added in lane order
#pragma unroll
  for (int m = 0; m < MAX_CPT; ++m) {
    const int lane = threadIdx.x + m * THREADS;
    if ((lane >> g.lg) < g.C) part_s[lane] = part[m];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < g.C; c += THREADS) {
    double acc = 0.0;
    for (int j = 0; j < g.G; ++j) acc += part_s[c * g.G + j];
    ws[static_cast<long long>(blockIdx.x) * g.C + c] = acc;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *last_s = atomicAdd(counter, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (*last_s) {  // every row is written: add them in row order
    __threadfence();
    for (int c = threadIdx.x; c < g.C; c += THREADS) {
      double acc = 0.0;
      for (int row = 0; row < static_cast<int>(gridDim.x); ++row)
        acc += __ldcg(ws + static_cast<long long>(row) * g.C + c);
      gb[c] = rnd<T>(__double2float_rn(acc));
    }
    if (threadIdx.x == 0) *counter = 0;  // ready for the next launch on this stream
  }
}

template <typename Kernel>
int configure(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

template <typename T, bool A, bool P, int V, int CU>
struct Fwd {
  static constexpr int kRegisterValues = 64;  // CU * V at most: y of each channel and voxel
  static int run(const void* x, const float* b, void* y, Geo g, int blocks, size_t smem,
                 cudaStream_t s) {
    const auto kernel = fused_fwd_kernel<T, A, P, V, CU>;
    if (const int e = configure(kernel, smem)) return e;
    kernel<<<blocks, THREADS, smem, s>>>(static_cast<const T*>(x), b, static_cast<T*>(y), g);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T, bool A, bool P, int V, int CU>
struct Bwd {
  static constexpr int kRegisterValues = 32;  // CU * V at most: u and g of each
  static int run(const void* x, const float* b, const void* gy, void* gx, float* gb, double* ws,
                 int* counter, Geo g, int blocks, size_t smem, cudaStream_t s) {
    const auto kernel = fused_bwd_kernel<T, A, P, V, CU>;
    if (const int e = configure(kernel, smem)) return e;
    kernel<<<blocks, THREADS, smem, s>>>(static_cast<const T*>(x), b, static_cast<const T*>(gy),
                                         static_cast<T*>(gx), gb, ws, counter, g);
    return static_cast<int>(cudaGetLastError());
  }
};

// (dtype, async, pixel norm, VPT, channels in registers) to one instantiation of F: the
// register path (cu = C = 16 or 32) exists for 16-byte copies with pixel norm only
template <template <typename, bool, bool, int, int> class F, typename... Args>
int dispatch(int bf16, bool async16, bool pn, int vpt, int cu, Args... args) {
  auto by_vpt = [&](auto t, auto a, auto p, auto u) -> int {
    auto one = [&](auto v) -> int {
      using K = F<decltype(t), decltype(a)::value, decltype(p)::value, decltype(v)::value,
                  decltype(u)::value>;
      if constexpr (decltype(u)::value * decltype(v)::value <= K::kRegisterValues)
        return K::run(args...);
      else
        return static_cast<int>(cudaErrorInvalidValue);
    };
    switch (vpt) {
      case 1: return one(std::integral_constant<int, 1>{});
      case 2: return one(std::integral_constant<int, 2>{});
      case 4: return one(std::integral_constant<int, 4>{});
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  };
  using Zero = std::integral_constant<int, 0>;
  auto by_pn = [&](auto t, auto a) -> int {
    return pn ? by_vpt(t, a, std::true_type{}, Zero{}) : by_vpt(t, a, std::false_type{}, Zero{});
  };
  auto by_cu = [&](auto t) -> int {
    const std::true_type yes{};
    if (cu == 16) return by_vpt(t, yes, yes, std::integral_constant<int, 16>{});
    if (cu == 32) return by_vpt(t, yes, yes, std::integral_constant<int, 32>{});
    return async16 ? by_pn(t, std::true_type{}) : by_pn(t, std::false_type{});
  };
  return bf16 ? by_cu(__nv_bfloat16{}) : by_cu(float{});
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Checks a plan and fills g; returns 0 or cudaErrorInvalidValue.
int make_geo(Geo& g, long long n, int c, long long s, int esize, int tv, int async16, int blocks,
             long long smem, bool backward, int lanes, int pixelnorm, int cu, float alpha,
             float eps) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || c <= 0 || s <= 0 || blocks <= 0) return bad;
  if (!pow2(tv) || tv > MAX_TV || tv * esize < 16) return bad;
  if (async16 && (s * esize) % 16 != 0) return bad;
  g.S = s, g.C = c, g.TV = tv, g.ltv = ilog2(tv), g.RS = tv + 16 / esize;
  const long long tiles = (s + tv - 1) / tv;
  if (tiles > INT_MAX || n * tiles > INT_MAX)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  g.tiles = static_cast<int>(tiles), g.items = static_cast<int>(n * tiles);
  if (blocks > g.items) return bad;
  g.G = lanes, g.lg = ilog2(lanes);
  if (backward) {
    if (!pow2(lanes) || lanes > tv || static_cast<long long>(c) * lanes > MAX_CPT * THREADS)
      return bad;
    if (c > THREADS ? lanes != 1 : c * lanes > THREADS) return bad;
  }
  // channels in registers: C = 16 or 32, 16-byte copies, pixel norm, at most 64 (forward:
  // y) or 32 (backward: u and g) values a thread
  const int vpt = tv > THREADS ? tv / THREADS : 1;
  if (cu != 0 && !((cu == 16 || cu == 32) && cu == c && async16 && pixelnorm &&
                   cu * vpt <= (backward ? 32 : 64)))
    return bad;
  g.alpha = alpha, g.eps = eps;
  const Layout L = layout(c, tv, esize, backward);
  if (L.total != static_cast<size_t>(smem) || L.total > MAX_SMEM) return bad;
  return 0;
}

}  // namespace

extern "C" int saragan_fused_bias_act_fwd(const void* x, const void* b, void* y, int bf16,
                                          long long n, int c, long long s, float alpha, float eps,
                                          int pixelnorm, int tv, int cu, int async16,
                                          int blocks, long long smem, void* stream) {
  Geo g{};
  const int esize = bf16 ? 2 : 4;
  if (const int e = make_geo(g, n, c, s, esize, tv, async16, blocks, smem, false, 1, pixelnorm,
                             cu, alpha, eps))
    return e;
  if (async16 && !(aligned16(x) && aligned16(y))) return static_cast<int>(cudaErrorInvalidValue);
  const int vpt = tv > THREADS ? tv / THREADS : 1;
  return dispatch<Fwd>(bf16, async16 != 0, pixelnorm != 0, vpt, cu, x,
                       static_cast<const float*>(b), y, g, blocks, static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream));
}

extern "C" int saragan_fused_bias_act_bwd(const void* x, const void* b, const void* gy, void* gx,
                                          void* gb, void* ws, void* counter, int bf16,
                                          long long n, int c, long long s, float alpha, float eps,
                                          int pixelnorm, int tv, int cu, int lanes,
                                          int async16, int blocks, long long smem,
                                          void* stream) {
  Geo g{};
  const int esize = bf16 ? 2 : 4;
  if (const int e = make_geo(g, n, c, s, esize, tv, async16, blocks, smem, true, lanes,
                             pixelnorm, cu, alpha, eps))
    return e;
  if (async16 && !(aligned16(x) && aligned16(gy) && aligned16(gx)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vpt = tv > THREADS ? tv / THREADS : 1;
  return dispatch<Bwd>(bf16, async16 != 0, pixelnorm != 0, vpt, cu, x,
                       static_cast<const float*>(b), gy, gx, static_cast<float*>(gb),
                       static_cast<double*>(ws), static_cast<int*>(counter), g, blocks,
                       static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
}

extern "C" const char* saragan_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
