// SAME, stride-1 3-D convolution forward, pipelined variant, in f32 on CUDA cores, for
// Hopper (sm_90a).
//
// Replaces saragan_tpu/ops/pallas_conv.py::conv3d_flat_v2 (kernel body _fwd_v2_kernel) for
// f32:
//   y[n, f, p] = sum_{kz,ky,kx} sum_c w[kz, ky, kx, c, f] * x[n, c, p + (kz, ky, kx) - k//2]
// the same function as kernel #1 (conv3d_fwd.cu), with x in NCDHW, w in (kd, kh, kw, C, F)
// and f32 accumulation.  Odd kernel sizes only (SAME = k//2 on both sides); any C and F.
// bf16 goes to conv3d_fwd_v2_tc.cu (the tensor cores); tensor cores in f32 would mean
// TF32, which the port keeps off.
//
// What makes v2 a kernel of its own is the TPU kernel's window pipeline: the input stays in
// device memory and asynchronous copies bring each work item's halo'd window into fast
// memory, several items ahead, while the current one computes (pallas_conv.py:246-267).
// Here, as in conv3d_fwd_v2_tc.cu:
//   * blocks are persistent: the grid holds as many blocks as the SMs take at once (the
//     host plan, ops/conv3d_flat.py::conv_v2_simt_plan), and block b walks the work items
//     b, b + grid, ...; an item is one sample's 3-D box of output positions (fitted to the
//     volume) and FT outputs, walked in channel chunks of CC;
//   * each (item, chunk) stage (the halo'd x box of CC channels, 4-byte copies zero-filled
//     outside the volume, and the chunk's K x CC x FT weights, 16-byte copies where F
//     allows) lands by cp.async in a ring of STAGES = 3 shared-memory stages: stage t + 2 is
//     in flight while stage t computes.  Where each staged row lies in the box is worked
//     out once per block into a table, so staging does no division;
//   * the arithmetic is kernel #1's: each thread keeps a register tile of VPT consecutive W
//     outputs x FPT output channels (8 x 8 where a sample has outputs enough to fill the
//     card with them, narrower, 4 x 4 / 4 x 2 / 4 x 1, as they get fewer), reads one
//     staged x row per (channel, kz, ky) and reuses it across the KW taps, and reads its FPT
//     weights as float4 (float2, float) words that the threads of a warp share; x rows
//     have an odd stride, so a warp's reads spread over the banks.
// What bounds it: 27*C multiply-adds per output for about 8 bytes in and out, so the CUDA
// cores' rate (67 TFLOP/s).  The TPU kernel's im2col operand (C <= 32) is not built: on CUDA
// cores each x value read from shared memory already feeds FPT x KW products.  Each output
// is summed by one thread, channel by channel and tap by tap: the order depends on neither
// the batch size nor a sample's slot, and reruns are bit-identical.  No atomics.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr size_t MAX_SMEM = 232448;  // 227 KB usable by one block
constexpr int STAGES = 3;            // the ring of (item, chunk) stages

struct Geo {
  int C, D, H, W, F, KD, KH, taps;
  int BD, BH, BW;        // output box
  int SD, SH, SW, RS;    // staged box: SD x SH rows of SW columns at row stride RS (odd)
  int PD, PH, PW;        // padding: k // 2
  int nbd, nbh, nbw, f_tiles;  // boxes along D, H, W; output tiles
  int CC, lcc, FT, lft, vw;    // channel chunk and output tile (powers of two), weight copy
  int LW;                // x staging: lanes per row (a power of two)
  int xs_floats, ws_floats;  // one stage of each (multiples of 4)
  int rows;              // staged rows per chunk: CC * SD * SH (the row table's entries)
  int nchunks, items;    // chunks per item; items: n * boxes * f_tiles, the f tile fastest
};

__host__ __device__ constexpr bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

__host__ __device__ constexpr int ilog2(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of BYTES (4 or 16); zeros when `in` is false (nothing is read).
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool in) {
  const int src_bytes = in ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes)
                 : "memory");
  } else {
    static_assert(BYTES == 4, "4 or 16 bytes");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Work item `item` -> sample, box origin and first output channel.
__device__ __forceinline__ void item_origin(const Geo& g, int item, int& n, int& d0, int& h0,
                                            int& w0, int& f0) {
  f0 = (item % g.f_tiles) * g.FT;
  int b = item / g.f_tiles;
  w0 = (b % g.nbw) * g.BW;
  b /= g.nbw;
  h0 = (b % g.nbh) * g.BH;
  b /= g.nbh;
  d0 = (b % g.nbd) * g.BD;
  n = b / g.nbd;
}

// Chunk [c0, c0 + CC) of sample n's box at (d0, h0, w0) into one stage: the halo'd x box
// as xs[q * RS + sx], q = (cc * SD + sz) * SH + sy the row of the table (which packs cc,
// sz, sy as cc << 16 | sz << 8 | sy), and the weights as ws[(tap * CC + cc) * FT + ff],
// zero outside the volume and past C and F.  Commits nothing (the caller does).
__device__ __forceinline__ void stage_chunk(const Geo& g, const int* tab,
                                            const float* __restrict__ x,
                                            const float* __restrict__ w, float* buf, int n,
                                            int c0, int d0, int h0, int w0, int f0) {
  const size_t plane = static_cast<size_t>(g.H) * g.W;
  const float* xc = x + (static_cast<size_t>(n) * g.C + c0) * g.D * plane;
  const uint32_t xb = smem_u32(buf);
  for (int q = threadIdx.x / g.LW; q < g.rows; q += blockDim.x / g.LW) {
    const int t = tab[q];
    const int cc = t >> 16;
    const int gd = d0 - g.PD + ((t >> 8) & 255), gh = h0 - g.PH + (t & 255);
    const bool row_in = c0 + cc < g.C && gd >= 0 && gd < g.D && gh >= 0 && gh < g.H;
    const float* src_row = xc + (static_cast<size_t>(cc) * g.D + gd) * plane +
                           static_cast<size_t>(gh) * g.W;
    const uint32_t dst = xb + static_cast<uint32_t>(q * g.RS) * 4u;
    for (int sx = threadIdx.x & (g.LW - 1); sx < g.SW; sx += g.LW) {
      const int gw = w0 + sx - g.PW;
      const bool in = row_in && gw >= 0 && gw < g.W;
      cp_async<4>(dst + sx * 4u, in ? src_row + gw : x, in);
    }
  }
  const uint32_t wb = xb + static_cast<uint32_t>(g.xs_floats) * 4u;
  if (g.vw == 4) {
    const int lpr = g.lft - 2;  // float4 words per row: FT / 4
    const int items = (g.taps * g.CC) << lpr;
    for (int i = threadIdx.x; i < items; i += blockDim.x) {
      const int j = i & ((1 << lpr) - 1);
      const int t = i >> lpr;
      const int c = c0 + (t & (g.CC - 1)), f = f0 + 4 * j;
      const bool in = c < g.C && f < g.F;
      const float* src = in ? w + (static_cast<size_t>(t >> g.lcc) * g.C + c) * g.F + f : w;
      cp_async<16>(wb + static_cast<uint32_t>(t * g.FT + 4 * j) * 4u, src, in);
    }
  } else {
    const int items = (g.taps * g.CC) << g.lft;
    for (int i = threadIdx.x; i < items; i += blockDim.x) {
      const int ff = i & (g.FT - 1);
      const int t = i >> g.lft;
      const int c = c0 + (t & (g.CC - 1)), f = f0 + ff;
      const bool in = c < g.C && f < g.F;
      const float* src = in ? w + (static_cast<size_t>(t >> g.lcc) * g.C + c) * g.F + f : w;
      cp_async<4>(wb + static_cast<uint32_t>(i) * 4u, src, in);
    }
  }
}

// FPT weights of one (tap, channel) row, as float4, float2 or float words.
template <int FPT>
__device__ __forceinline__ void load_w(const float* p, float (&wv)[FPT]) {
  if constexpr (FPT % 4 == 0) {
#pragma unroll
    for (int q = 0; q < FPT / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(p)[q];
      wv[4 * q] = v.x, wv[4 * q + 1] = v.y, wv[4 * q + 2] = v.z, wv[4 * q + 3] = v.w;
    }
  } else if constexpr (FPT == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    wv[0] = v.x, wv[1] = v.y;
  } else {
    wv[0] = p[0];
  }
}

template <int KW, int VPT, int FPT>
__global__ void __launch_bounds__(VPT == 8 ? 256 : 128, VPT == 8 ? 2 : 4)
conv3d_fwd_v2_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ y, const Geo g) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int stage = g.xs_floats + g.ws_floats;
  int* tab = reinterpret_cast<int*>(smem + STAGES * stage);

  // thread -> (output-channel group, position group); the group fg is warp-uniform
  // wherever a warp's threads cover positions only
  const int wgs = g.BW / VPT;
  const int tpos = g.BD * g.BH * wgs;
  const int fg = threadIdx.x / tpos;
  const int pt = threadIdx.x - fg * tpos;
  const int lx = (pt % wgs) * VPT;
  const int ly = (pt / wgs) % g.BH;
  const int lz = pt / (wgs * g.BH);

  const int plane_rows = g.SD * g.SH;
  for (int q = threadIdx.x; q < g.rows; q += blockDim.x) {
    const int cc = q / plane_rows, rr = q - cc * plane_rows;
    tab[q] = (cc << 16) | ((rr / g.SH) << 8) | (rr % g.SH);
  }
  __syncthreads();

  // this block's stages: (item, chunk) for its items blockIdx.x + k * gridDim.x
  const int mine = static_cast<int>(blockIdx.x) < g.items
                       ? (g.items - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1
                       : 0;
  const int total = mine * g.nchunks;
  auto issue = [&](int t) {
    int n, d0, h0, w0, f0;
    item_origin(g, blockIdx.x + (t / g.nchunks) * gridDim.x, n, d0, h0, w0, f0);
    stage_chunk(g, tab, x, w, smem + (t % STAGES) * stage, n, (t % g.nchunks) * g.CC, d0, h0,
                w0, f0);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) issue(s);
    cp_async_commit();  // empty groups keep the count uniform
  }

  float acc[VPT][FPT];
#pragma unroll
  for (int v = 0; v < VPT; ++v)
#pragma unroll
    for (int f = 0; f < FPT; ++f) acc[v][f] = 0.f;

  const int wstep = g.CC * g.FT;  // floats from one kx tap to the next
  const size_t plane = static_cast<size_t>(g.H) * g.W;
  for (int t = 0; t < total; ++t) {
    cp_async_wait<STAGES - 2>();  // stage t has landed (this thread's copies) ...
    __syncthreads();              // ... everyone's, and stage t - 1's slot is free
    if (t + STAGES - 1 < total) issue(t + STAGES - 1);
    cp_async_commit();

    const int chunk = t % g.nchunks;
    const float* xs = smem + (t % STAGES) * stage + (lz * g.SH + ly) * g.RS + lx;
    const float* ws = smem + (t % STAGES) * stage + g.xs_floats + fg * FPT;
    const int cn = min(g.CC, g.C - chunk * g.CC);  // the chunk's channels that exist
    for (int cc = 0; cc < cn; ++cc) {
      for (int kz = 0; kz < g.KD; ++kz) {
        for (int ky = 0; ky < g.KH; ++ky) {
          const float* row = xs + ((cc * g.SD + kz) * g.SH + ky) * g.RS;
          float xr[VPT + KW - 1];
#pragma unroll
          for (int j = 0; j < VPT + KW - 1; ++j) xr[j] = row[j];
          const float* wt = ws + ((kz * g.KH + ky) * KW * g.CC + cc) * g.FT;
#pragma unroll
          for (int kx = 0; kx < KW; ++kx) {
            float wv[FPT];
            load_w<FPT>(wt + kx * wstep, wv);
#pragma unroll
            for (int v = 0; v < VPT; ++v)
#pragma unroll
              for (int f = 0; f < FPT; ++f) acc[v][f] = fmaf(xr[v + kx], wv[f], acc[v][f]);
          }
        }
      }
    }

    if (chunk != g.nchunks - 1) continue;
    // the item's last chunk: store and restart the sums
    int n, d0, h0, w0, f0;
    item_origin(g, blockIdx.x + (t / g.nchunks) * gridDim.x, n, d0, h0, w0, f0);
    const int gd = d0 + lz, gh = h0 + ly;
    const bool row_in = gd < g.D && gh < g.H;
#pragma unroll
    for (int f = 0; f < FPT; ++f) {
      const int gf = f0 + fg * FPT + f;
      float* yrow = y + ((static_cast<size_t>(n) * g.F + gf) * g.D + gd) * plane +
                    static_cast<size_t>(gh) * g.W;
#pragma unroll
      for (int v = 0; v < VPT; ++v) {
        const int gw = w0 + lx + v;
        if (row_in && gf < g.F && gw < g.W) yrow[gw] = acc[v][f];
        acc[v][f] = 0.f;
      }
    }
  }
}

template <int KW, int VPT, int FPT>
int launch(const float* x, const float* w, float* y, const Geo& g, int threads, int blocks,
           size_t smem, cudaStream_t stream) {
  const auto kernel = conv3d_fwd_v2_kernel<KW, VPT, FPT>;
  if (threads > (VPT == 8 ? 256 : 128)) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, threads, smem, stream>>>(x, w, y, g);
  return static_cast<int>(cudaGetLastError());
}

template <int VPT, int FPT>
int launch_kw(int kw, const float* x, const float* w, float* y, const Geo& g, int threads,
              int blocks, size_t smem, cudaStream_t s) {
  switch (kw) {
    case 1: return launch<1, VPT, FPT>(x, w, y, g, threads, blocks, smem, s);
    case 3: return launch<3, VPT, FPT>(x, w, y, g, threads, blocks, smem, s);
    case 5: return launch<5, VPT, FPT>(x, w, y, g, threads, blocks, smem, s);
    case 7: return launch<7, VPT, FPT>(x, w, y, g, threads, blocks, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: (n, c, d, h, wd), w: (kd, kh, kw, c, f), y: (n, f, d, h, wd), f32, contiguous on the
// device of `stream`.  The plan (ops/conv3d_flat.py::conv_v2_simt_plan): the output box
// (bd, bh, bw), the channel chunk cc, the output tile ft, the register tile vpt x fpt
// (8 x 8, 4 x 4, 4 x 2 or 4 x 1), the weight copy vw (4: 16-byte copies, w 16-byte
// aligned and f % 4 == 0; or 1), the persistent grid `blocks` and the shared bytes it
// computed; a plan this kernel cannot run is refused.
// Returns a cudaError_t (0 when the launch was accepted); the caller checks it.
extern "C" int saragan_conv3d_fwd_v2(const void* x, const void* w, void* y, int n, int c, int d,
                                     int h, int wd, int kd, int kh, int kw, int f, int bd,
                                     int bh, int bw, int cc, int ft, int vpt, int fpt, int vw,
                                     int blocks, long long smem, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || c <= 0 || d <= 0 || h <= 0 || wd <= 0 || f <= 0) return bad;
  if (kd <= 0 || kh <= 0 || kw <= 0 || kd % 2 == 0 || kh % 2 == 0 || kw % 2 == 0) return bad;
  if (!pow2(bd) || !pow2(bh) || !pow2(bw) || !pow2(cc) || !pow2(ft)) return bad;
  if (!((vpt == 8 && fpt == 8) || (vpt == 4 && (fpt == 4 || fpt == 2 || fpt == 1)))) return bad;
  if (bw % vpt != 0 || ft % fpt != 0 || ft < 4) return bad;
  if (vw != 1 && !(vw == 4 && f % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0)) return bad;

  Geo g{};
  g.C = c, g.D = d, g.H = h, g.W = wd, g.F = f, g.KD = kd, g.KH = kh, g.taps = kd * kh * kw;
  g.BD = bd, g.BH = bh, g.BW = bw;
  g.SD = bd + kd - 1, g.SH = bh + kh - 1, g.SW = bw + kw - 1, g.RS = g.SW | 1;
  g.PD = kd / 2, g.PH = kh / 2, g.PW = kw / 2;
  if (g.SD > 255 || g.SH > 255 || cc > 32767) return bad;  // the row table's packing
  g.nbd = (d + bd - 1) / bd, g.nbh = (h + bh - 1) / bh, g.nbw = (wd + bw - 1) / bw;
  g.f_tiles = (f + ft - 1) / ft;
  g.CC = cc, g.lcc = ilog2(cc), g.FT = ft, g.lft = ilog2(ft), g.vw = vw;
  g.nchunks = (c + cc - 1) / cc;
  const int threads = (bd * bh * bw / vpt) * (ft / fpt);
  int lw = 1;
  while (lw < g.SW && lw < 32 && lw < threads) lw *= 2;
  g.LW = lw;
  g.rows = cc * g.SD * g.SH;
  g.xs_floats = round_up(g.rows * g.RS, 4);
  g.ws_floats = g.taps * cc * ft;
  const size_t need = STAGES * (static_cast<size_t>(g.xs_floats) + g.ws_floats) * sizeof(float) +
                      static_cast<size_t>(g.rows) * sizeof(int);
  if (need != static_cast<size_t>(smem) || need > MAX_SMEM) return bad;
  const long long items = static_cast<long long>(n) * g.nbd * g.nbh * g.nbw * g.f_tiles;
  if (items > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  g.items = static_cast<int>(items);
  if (blocks <= 0 || blocks > g.items) return bad;

  const float* xt = static_cast<const float*>(x);
  const float* wt = static_cast<const float*>(w);
  float* yt = static_cast<float*>(y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vpt == 8) return launch_kw<8, 8>(kw, xt, wt, yt, g, threads, blocks, need, s);
  if (fpt == 4) return launch_kw<4, 4>(kw, xt, wt, yt, g, threads, blocks, need, s);
  if (fpt == 2) return launch_kw<4, 2>(kw, xt, wt, yt, g, threads, blocks, need, s);
  return launch_kw<4, 1>(kw, xt, wt, yt, g, threads, blocks, need, s);
}

extern "C" const char* saragan_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
