// SAME, stride-1 3-D convolution forward, pipelined variant, in f32 or bf16 on CUDA cores,
// for Hopper (sm_90a).
//
// Replaces saragan_tpu/ops/pallas_conv.py::conv3d_flat_v2 (kernel body _fwd_v2_kernel):
//   y[n, f, p] = sum_{kz,ky,kx} sum_c w[kz, ky, kx, c, f] * x[n, c, p + (kz, ky, kx) - k//2]
// the same function as conv3d_fwd.cu (kernel #1), with x in NCDHW, w in (kd, kh, kw, C, F),
// f32 accumulation and one rounding at the store.  Only odd kernel sizes (SAME = k//2 on
// both sides).  Unlike the TPU kernel, which falls back to v1 when C is not a multiple of
// the sublane count (a DMA alignment rule of the TPU), this kernel takes any C.
//
// What makes v2 a kernel of its own is its design, which this source carries over:
//   * the input stays in device memory and a double-buffered window copy prefetches the
//     next work item while the current one computes (pallas_conv.py:246-267).  Here each
//     block walks a sequence of position tiles; a work item is (tile, channel chunk), and
//     its halo'd input window is copied into shared memory with cp.async (16- or 4-byte
//     chunks, zero-filled outside the volume) into the stage the previous item freed, while
//     the current item computes from the other stage (commit_group / wait_group);
//   * for C <= 32 the K shifted (C, tile) slices are stacked into one (K*C, tile) im2col
//     operand and contracted in one K*C-wide pass (pallas_conv.py:270-276).  Here the
//     operand is built in shared memory from the staged window, in slabs of KS rows (a
//     table of each row's window offset makes a slab entry one lookup), and each thread
//     runs one reduction over all K*C rows; for C > 32 every tap is contracted on its own
//     over a channel chunk, straight from the window.
// Where a row's alignment does not allow cp.async (a bf16 volume of odd width, a pointer
// that is not 4-byte aligned), the window is loaded with plain loads instead; the result
// is the same.
//
// What bounds it: as kernel #1, operations.  Every product runs on CUDA cores in f32 (the
// port keeps TF32 off; bf16 does not use the tensor cores yet), so the bound in bf16 is
// the tensor cores' rate and this kernel is far from it.  No atomics: every output is
// summed by one thread in a fixed order, so reruns are bit-identical.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "elem.cuh"

namespace {

using saragan::load_f32;
using saragan::store_t;

constexpr int P = 64;          // output positions per tile (TH x TW)
constexpr int FT = 16;         // output channels per block
constexpr int FPT = 4;         // output channels per thread
constexpr int VPT = 2;         // consecutive W positions per thread
constexpr int THREADS = (P / VPT) * (FT / FPT);  // 128: a warp per 4-channel group
static_assert(THREADS % P == 0, "the im2col build gives each thread one position");
constexpr int PADW = 8;        // staged columns left and right of the tile (>= kw/2)
constexpr int KS = 32;         // im2col rows per slab
constexpr size_t MAX_SMEM = 232448;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One cp.async of VB bytes; src_bytes 0 zero-fills the destination.
template <int VB>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  if constexpr (VB == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
  } else {
    static_assert(VB == 4, "cp.async chunks of 16 or 4 bytes");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Geometry {
  int C, D, H, W, KD, KH, F;
  int TH, TW;           // tile of TH x TW output positions in one depth slice
  int tiles_h, tiles_w, tiles;
  int CC, nchunks;      // channels per work item, chunks per tile
  int HH, WW;           // staged rows per (channel, kz) and staged row length
  int stage_elems;      // elements of one window stage (a multiple of 16 bytes)
  int VB;               // cp.async chunk in bytes (16 or 4), or 0 for plain loads
};

// Copy (or zero) the halo'd window of work item (tile, chunk) into `win`.
template <typename T, int VB>
__device__ void load_window(const T* __restrict__ x, T* win, const Geometry& g, int n, int d0,
                            int h0, int w0, int c0, int pd, int ph) {
  constexpr int ESZ = sizeof(T);
  const size_t plane = static_cast<size_t>(g.H) * g.W;
  const int rows = g.CC * g.KD * g.HH;
  if constexpr (VB > 0) {
    constexpr int VE = VB / ESZ;  // elements per chunk
    const int per_row = g.WW / VE;
    for (int i = threadIdx.x; i < rows * per_row; i += THREADS) {
      const int r = i / per_row, j = i % per_row;
      const int yy = r % g.HH;
      const int t = r / g.HH;
      const int zz = t % g.KD;
      const int c = c0 + t / g.KD;
      const int gd = d0 + zz - pd, gh = h0 + yy - ph, gw = w0 - PADW + j * VE;
      // W is a multiple of VE and gw of VE as well: a chunk is wholly in or wholly out
      const bool in = c < g.C && gd >= 0 && gd < g.D && gh >= 0 && gh < g.H && gw >= 0 &&
                      gw < g.W;
      const T* src = in ? x + ((static_cast<size_t>(n) * g.C + c) * g.D + gd) * plane +
                              static_cast<size_t>(gh) * g.W + gw
                        : x;
      cp_async<VB>(win + static_cast<size_t>(r) * g.WW + j * VE, src, in ? VB : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * g.WW; i += THREADS) {
      const int r = i / g.WW, xx = i % g.WW;
      const int yy = r % g.HH;
      const int t = r / g.HH;
      const int zz = t % g.KD;
      const int c = c0 + t / g.KD;
      const int gd = d0 + zz - pd, gh = h0 + yy - ph, gw = w0 - PADW + xx;
      T v = store_t<T>(0.f);
      if (c < g.C && gd >= 0 && gd < g.D && gh >= 0 && gh < g.H && gw >= 0 && gw < g.W)
        v = x[((static_cast<size_t>(n) * g.C + c) * g.D + gd) * plane +
              static_cast<size_t>(gh) * g.W + gw];
      win[i] = v;
    }
  }
}

// Weights of channels [c0, c0 + CC) and filters [f0, f0 + FT) as ws[(tap * CC + cc) * FT + ff],
// f32, zero past the last channel or filter.
template <typename T>
__device__ void load_weights(const T* __restrict__ w, float* ws, int K, int C, int F, int c0,
                             int CC, int f0) {
  for (int i = threadIdx.x; i < K * CC * FT; i += THREADS) {
    const int ff = i % FT;
    const int t = i / FT;
    const int cc = t % CC;
    const int k = t / CC;
    const int c = c0 + cc, f = f0 + ff;
    ws[i] = (c < C && f < F) ? load_f32(w + (static_cast<size_t>(k) * C + c) * F + f) : 0.f;
  }
}

template <typename T>
__device__ void load_item_window(const T* __restrict__ x, T* win, const Geometry& g, int n,
                                 int d0, int h0, int w0, int c0, int pd, int ph) {
  switch (g.VB) {
    case 16: load_window<T, 16>(x, win, g, n, d0, h0, w0, c0, pd, ph); break;
    case 4: load_window<T, 4>(x, win, g, n, d0, h0, w0, c0, pd, ph); break;
    default: load_window<T, 0>(x, win, g, n, d0, h0, w0, c0, pd, ph); break;
  }
}

template <typename T, int KW, bool IM2COL>
__global__ void __launch_bounds__(THREADS)
conv3d_fwd_v2_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                     Geometry g) {
  extern __shared__ float4 smem4[];
  T* stage[2] = {reinterpret_cast<T*>(smem4),
                 reinterpret_cast<T*>(smem4) + g.stage_elems};
  float* ws = reinterpret_cast<float*>(reinterpret_cast<T*>(smem4) + 2 * g.stage_elems);

  const int K = g.KD * g.KH * KW;
  const int pd = g.KD / 2, ph = g.KH / 2, pw = KW / 2;
  const int f0 = blockIdx.y * FT;
  const int tid = threadIdx.x;
  const int fg = tid / (P / VPT);             // warp: which FPT-wide channel group
  const int p0 = (tid % (P / VPT)) * VPT;     // first of this thread's positions
  const int ly = p0 / g.TW, lx = p0 % g.TW;   // TW is even: both positions share a row
  float* col = ws + K * g.CC * FT;  // the im2col slab (IM2COL only)
  int* offs = reinterpret_cast<int*>(col + KS * P);  // window offset of each im2col row

  if constexpr (IM2COL) {
    load_weights(w, ws, K, g.C, g.F, 0, g.CC, f0);  // one chunk: the weights stay
    for (int kk = tid; kk < K * g.CC; kk += THREADS) {
      const int c = kk % g.CC;
      const int tap = kk / g.CC;
      const int kx = tap % KW;
      const int ky = (tap / KW) % g.KH;
      const int kz = tap / (KW * g.KH);
      offs[kk] = ((c * g.KD + kz) * g.HH + ky) * g.WW + kx;
    }
  }

  // work items of this block: tiles blockIdx.x, blockIdx.x + gridDim.x, ...; chunks inside
  const int my_tiles = (g.tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int items = my_tiles * g.nchunks;

  auto tile_origin = [&](int item, int& n, int& d0, int& h0, int& w0, int& c0) {
    int t = blockIdx.x + (item / g.nchunks) * gridDim.x;
    c0 = (item % g.nchunks) * g.CC;
    const int tw = t % g.tiles_w;
    t /= g.tiles_w;
    const int th = t % g.tiles_h;
    t /= g.tiles_h;
    d0 = t % g.D;
    n = t / g.D;
    h0 = th * g.TH;
    w0 = tw * g.TW;
  };

  float acc[VPT][FPT];
#pragma unroll
  for (int v = 0; v < VPT; ++v)
#pragma unroll
    for (int f = 0; f < FPT; ++f) acc[v][f] = 0.f;

  if (items > 0) {
    int n, d0, h0, w0, c0;
    tile_origin(0, n, d0, h0, w0, c0);
    load_item_window(x, stage[0], g, n, d0, h0, w0, c0, pd, ph);
    cp_async_commit();
  }

  for (int item = 0; item < items; ++item) {
    // prefetch the next item into the stage the previous item released
    if (item + 1 < items) {
      int n, d0, h0, w0, c0;
      tile_origin(item + 1, n, d0, h0, w0, c0);
      load_item_window(x, stage[(item + 1) & 1], g, n, d0, h0, w0, c0, pd, ph);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    int n, d0, h0, w0, c0;
    tile_origin(item, n, d0, h0, w0, c0);
    if constexpr (!IM2COL) load_weights(w, ws, K, g.C, g.F, c0, g.CC, f0);
    __syncthreads();
    const T* win = stage[item & 1];

    if constexpr (IM2COL) {
      // one K*C-wide contraction over the im2col operand, built KS rows at a time: this
      // thread fills position pb of rows r0, r0 + THREADS / P, ... from the row offsets
      const int KC = K * g.CC;
      const int pb = tid % P, r0 = tid / P;
      const int poff = (pb / g.TW) * g.WW + pb % g.TW + PADW - pw;
      for (int k0 = 0; k0 < KC; k0 += KS) {
        for (int r = r0; r < KS; r += THREADS / P) {
          const int kk = k0 + r;
          col[r * P + pb] = kk < KC ? widen(win[offs[kk] + poff]) : 0.f;
        }
        __syncthreads();
        const int kmax = min(KS, KC - k0);
        for (int kk = 0; kk < kmax; ++kk) {
          const float2 a = *reinterpret_cast<const float2*>(col + kk * P + p0);
          const float4 b = *reinterpret_cast<const float4*>(ws + (k0 + kk) * FT + fg * FPT);
          const float wv[FPT] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int f = 0; f < FPT; ++f) {
            acc[0][f] = fmaf(a.x, wv[f], acc[0][f]);
            acc[1][f] = fmaf(a.y, wv[f], acc[1][f]);
          }
        }
        __syncthreads();
      }
    } else {
      // per tap: contract the chunk's channels straight from the shifted window rows
      for (int cc = 0; cc < g.CC; ++cc) {
        for (int kz = 0; kz < g.KD; ++kz) {
          for (int ky = 0; ky < g.KH; ++ky) {
            const T* row = win + ((cc * g.KD + kz) * g.HH + ly + ky) * g.WW + PADW - pw + lx;
            float xr[VPT + KW - 1];
#pragma unroll
            for (int j = 0; j < VPT + KW - 1; ++j) xr[j] = widen(row[j]);
#pragma unroll
            for (int kx = 0; kx < KW; ++kx) {
              const int tap = (kz * g.KH + ky) * KW + kx;
              const float4 b =
                  *reinterpret_cast<const float4*>(ws + (tap * g.CC + cc) * FT + fg * FPT);
              const float wv[FPT] = {b.x, b.y, b.z, b.w};
#pragma unroll
              for (int v = 0; v < VPT; ++v)
#pragma unroll
                for (int f = 0; f < FPT; ++f) acc[v][f] = fmaf(xr[v + kx], wv[f], acc[v][f]);
            }
          }
        }
      }
    }

    if (item % g.nchunks == g.nchunks - 1) {  // the tile's last chunk: store, restart
      const int gh = h0 + ly;
      const size_t plane = static_cast<size_t>(g.H) * g.W;
#pragma unroll
      for (int f = 0; f < FPT; ++f) {
        const int gf = f0 + fg * FPT + f;
#pragma unroll
        for (int v = 0; v < VPT; ++v) {
          const int gw = w0 + lx + v;
          if (gf < g.F && gh < g.H && gw < g.W)
            y[((static_cast<size_t>(n) * g.F + gf) * g.D + d0) * plane +
              static_cast<size_t>(gh) * g.W + gw] = store_t<T>(acc[v][f]);
          acc[v][f] = 0.f;
        }
      }
    }
    __syncthreads();  // the stage just read is the one the next iteration refills
  }
}

size_t round16(size_t bytes) { return (bytes + 15) & ~static_cast<size_t>(15); }

// Shared memory of a configuration: two window stages, the weights, and for im2col the
// slab and the offset of each of its K*C rows.
size_t smem_bytes(const Geometry& g, int K, int esize, bool im2col) {
  return 2 * static_cast<size_t>(g.stage_elems) * esize +
         static_cast<size_t>(K) * g.CC * FT * sizeof(float) +
         (im2col ? static_cast<size_t>(KS) * P * sizeof(float) +
                       static_cast<size_t>(K) * g.CC * sizeof(int)
                 : 0);
}

void set_chunks(Geometry& g, int CC, int esize) {
  g.CC = CC;
  g.nchunks = (g.C + CC - 1) / CC;
  const size_t elems = static_cast<size_t>(CC) * g.KD * g.HH * g.WW;
  g.stage_elems = static_cast<int>(round16(elems * esize) / esize);
}

template <typename T, int KW, bool IM2COL>
int launch_cfg(const T* x, const T* w, T* y, const Geometry& g, size_t smem, int n_blocks,
               int f_tiles, cudaStream_t stream) {
  auto kernel = conv3d_fwd_v2_kernel<T, KW, IM2COL>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(n_blocks, f_tiles), THREADS, smem, stream>>>(x, w, y, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KW>
int launch(const T* x, const T* w, T* y, int n, int c, int d, int h, int wd, int kd, int kh,
           int f, cudaStream_t stream) {
  constexpr int ESZ = sizeof(T);
  Geometry g{};
  g.C = c, g.D = d, g.H = h, g.W = wd, g.KD = kd, g.KH = kh, g.F = f;
  g.TW = wd <= 8 ? 8 : 32;
  g.TH = P / g.TW;
  g.tiles_h = (h + g.TH - 1) / g.TH;
  g.tiles_w = (wd + g.TW - 1) / g.TW;
  const long long tiles = static_cast<long long>(n) * d * g.tiles_h * g.tiles_w;
  if (tiles <= 0 || tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  g.tiles = static_cast<int>(tiles);
  g.HH = g.TH + kh - 1;
  g.WW = g.TW + 2 * PADW;
  const int K = kd * kh * KW;

  // im2col for C <= 32 when its operand fits; otherwise per tap over channel chunks
  bool im2col = c <= 32;
  size_t smem = 0;
  if (im2col) {
    set_chunks(g, c, ESZ);
    smem = smem_bytes(g, K, ESZ, true);
    im2col = smem <= MAX_SMEM;
  }
  if (!im2col) {
    int cc = 32;
    for (;; cc /= 2) {
      set_chunks(g, cc, ESZ);
      smem = smem_bytes(g, K, ESZ, false);
      if (smem <= MAX_SMEM) break;
      if (cc == 1) return static_cast<int>(cudaErrorInvalidValue);
    }
  }

  // cp.async chunk: 16 or 4 bytes where every row start (a multiple of W elements from an
  // aligned base), the tile origin and the halo pad allow it; else plain loads
  const uintptr_t base = reinterpret_cast<uintptr_t>(x);
  g.VB = 0;
  for (int cand : {16, 4}) {
    if ((static_cast<size_t>(wd) * ESZ) % cand == 0 && base % cand == 0 &&
        (PADW * ESZ) % cand == 0 && (g.TW * ESZ) % cand == 0) {
      g.VB = cand;
      break;
    }
  }

  const int f_tiles = (f + FT - 1) / FT;
  // about 2048 blocks in all, several waves of the card; each walks its share of tiles
  const long long cap = 2048 / f_tiles + 1;
  const int n_blocks = static_cast<int>(tiles < cap ? tiles : cap);
  return im2col ? launch_cfg<T, KW, true>(x, w, y, g, smem, n_blocks, f_tiles, stream)
                : launch_cfg<T, KW, false>(x, w, y, g, smem, n_blocks, f_tiles, stream);
}

template <typename T>
int dispatch_kw(const void* x, const void* w, void* y, int n, int c, int d, int h, int wd, int kd,
                int kh, int kw, int f, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  switch (kw) {
    case 1: return launch<T, 1>(xt, wt, yt, n, c, d, h, wd, kd, kh, f, s);
    case 3: return launch<T, 3>(xt, wt, yt, n, c, d, h, wd, kd, kh, f, s);
    case 5: return launch<T, 5>(xt, wt, yt, n, c, d, h, wd, kd, kh, f, s);
    case 7: return launch<T, 7>(xt, wt, yt, n, c, d, h, wd, kd, kh, f, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: (n, c, d, h, wd), w: (kd, kh, kw, c, f), y: (n, f, d, h, wd), all of the element type
// `dtype` (0 f32, 1 bf16) and contiguous on the device of `stream`.  Returns a cudaError_t
// (0 when the launch was accepted); the caller checks it.
extern "C" int saragan_conv3d_fwd_v2(int dtype, const void* x, const void* w, void* y, int n,
                                     int c, int d, int h, int wd, int kd, int kh, int kw, int f,
                                     void* stream) {
  if (kd % 2 == 0 || kh % 2 == 0 || kw % 2 == 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == saragan::DTYPE_F32)
    return dispatch_kw<float>(x, w, y, n, c, d, h, wd, kd, kh, kw, f, s);
  if (dtype == saragan::DTYPE_BF16)
    return dispatch_kw<__nv_bfloat16>(x, w, y, n, c, d, h, wd, kd, kh, kw, f, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* saragan_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
