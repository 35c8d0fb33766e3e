// SAME, stride-1 3-D convolution forward in f32 on CUDA cores, for Hopper (sm_90a).
//
// Replaces saragan_tpu/ops/pallas_conv.py::conv3d_flat (kernel body _fwd_kernel):
//   y[n, f, p] = sum_{kz,ky,kx} sum_c w[kz, ky, kx, c, f] * x[n, c, p + (kz, ky, kx) - k//2]
// with zero padding outside the volume, x in NCDHW, w in (kd, kh, kw, C, F) and f32
// accumulation.  f32 only (the serving convs and the f32 train step): bf16 goes to the
// tensor-core kernel conv3d_fwd_tc.cu (ops/conv3d_flat.py routes by dtype).  With
// flipped, io-swapped weights the same kernel is the dgrad (ops/conv3d_grad.py).  Only
// odd kernel sizes: SAME padding is then k//2 on both sides, which is what the
// reference's flat engine pads (pallas_conv.py:47); for even sizes the flat engine
// disagrees with SAME, so this entry point refuses them.
//
// What bounds it: at the phase-6 shapes the convolution does 27*C multiply-adds per
// output for about 8 bytes of input and output, so on CUDA cores it is bound by
// operations (67 TFLOP/s), not by device memory.  Tensor cores in f32 would mean TF32,
// which the port keeps off.
//
// Design.  The TPU kernel keeps a whole zero-padded, flattened volume window in VMEM and
// reads every tap as a lane shift of it; on Hopper a block stages a halo'd box instead:
//   * a block owns one sample's 3-D box of output positions (BD, BH, BW) and FT output
//     channels.  The host plan (ops/conv3d_flat.py::conv_simt_plan) fits the box to the
//     volume, so a block of a 4x4 or 8x8 plane covers the plane (and several depth
//     slices) instead of staging a mostly empty tile, and picks the channel chunk CC and
//     the register tile: VPT consecutive W outputs x FPT output channels per thread, 8 x 8
//     where a sample has outputs enough to fill the card with them, narrower (4 x 4,
//     4 x 2, 4 x 1) as a sample's outputs get fewer, so that small planes still run
//     enough warps to hide latency;
//   * it walks the input channels in chunks of CC, two stages deep: cp.async copies
//     chunk k+1's halo'd x box (zero padding by zero-fill) and its K x CC x FT weights
//     (16-byte copies where F allows) while chunk k computes.  Where each staged row comes
//     from is worked out once per block into a table in shared memory, so a chunk's
//     staging does no division; element offsets are formed from it in 64 bits, so no
//     tensor size meets a 32-bit limit;
//   * each thread reads one staged x row per (channel, kz, ky), reuses it across the KW
//     taps, and reads its FPT weights as float4 (float2, float) words that the threads of
//     a warp share; the x row stride is odd, so the rows a warp reads spread over the banks.
// Each output is summed by one thread, channel by channel and tap by tap within a channel,
// whatever the plan: the sum order depends on neither the batch size nor a sample's slot
// in it, and reruns are bit-identical.  C is never split across blocks.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr size_t MAX_SMEM = 232448;  // 227 KB usable by one block

struct Geo {
  int C, D, H, W, F, KD, KH, taps;
  int BD, BH, BW;        // output box
  int SD, SH, SW, RS;    // staged box: SD x SH rows of SW columns at row stride RS (odd)
  int PD, PH, PW;        // padding: k // 2
  int nbh, nbw, nbox;    // boxes along H and W, and per sample
  int CC, lcc, FT, lft, vw;  // channel chunk and output tile (powers of two), weight copy
  int LW;                // x staging: lanes per row (a power of two)
  int xs_floats, ws_floats;  // one stage of each (multiples of 4)
  int rows;              // staged rows per chunk: CC * SD * SH (the row table's entries)
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

// The row table: for staged row q = (cc * SD + sz) * SH + sy, {its row gd * H + gh in
// the channel's D x H rows, or -1 outside the volume, cc}.  Element offsets are formed
// from it in 64 bits at use, so no size of x is limited by 32-bit arithmetic.
__device__ __forceinline__ void build_row_table(const Geo& g, int2* tab, int d0, int h0) {
  const int plane_rows = g.SD * g.SH;
  for (int q = threadIdx.x; q < g.rows; q += blockDim.x) {
    const int cc = q / plane_rows;
    const int rr = q - cc * plane_rows;
    const int gd = d0 + rr / g.SH - g.PD, gh = h0 + rr % g.SH - g.PH;
    const bool in = gd >= 0 && gd < g.D && gh >= 0 && gh < g.H;
    tab[q] = make_int2(in ? gd * g.H + gh : -1, cc);
  }
}

// Chunk [c0, c0 + CC) into one stage: the halo'd x box as xs[q * RS + sx] (q the row of
// the table) and the weights as ws[(tap * CC + cc) * FT + ff], zero outside the volume and
// past C and F.  Commits nothing (the caller does).
__device__ __forceinline__ void stage_chunk(const Geo& g, const int2* tab,
                                            const float* __restrict__ xn,
                                            const float* __restrict__ w, float* buf, int c0,
                                            int w0, int f0) {
  const size_t rows = static_cast<size_t>(g.D) * g.H;  // W-rows per channel
  const uint32_t xb = smem_u32(buf);
  for (int q = threadIdx.x / g.LW; q < g.rows; q += blockDim.x / g.LW) {
    const int2 t = tab[q];
    const bool row_in = t.x >= 0 && c0 + t.y < g.C;
    const float* src_row =
        row_in ? xn + (static_cast<size_t>(c0 + t.y) * rows + static_cast<size_t>(t.x)) * g.W
               : xn;
    const uint32_t dst = xb + static_cast<uint32_t>(q * g.RS) * 4u;
    for (int sx = threadIdx.x & (g.LW - 1); sx < g.SW; sx += g.LW) {
      const int gw = w0 + sx - g.PW;
      const bool in = row_in && gw >= 0 && gw < g.W;
      cp_async<4>(dst + sx * 4u, in ? src_row + gw : xn, in);
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
conv3d_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ y, const Geo g) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int stage = g.xs_floats + g.ws_floats;
  int2* tab = reinterpret_cast<int2*>(smem + 2 * stage);

  int bid = blockIdx.x;
  const int n = bid / g.nbox;
  bid -= n * g.nbox;
  const int bwi = bid % g.nbw;
  bid /= g.nbw;
  const int d0 = (bid / g.nbh) * g.BD, h0 = (bid % g.nbh) * g.BH, w0 = bwi * g.BW;
  const int f0 = blockIdx.y * g.FT;

  // thread -> (output-channel group, position group); the group fg is warp-uniform
  // wherever a warp's threads cover positions only
  const int wgs = g.BW / VPT;
  const int tpos = g.BD * g.BH * wgs;
  const int fg = threadIdx.x / tpos;
  const int pt = threadIdx.x - fg * tpos;
  const int lx = (pt % wgs) * VPT;
  const int ly = (pt / wgs) % g.BH;
  const int lz = pt / (wgs * g.BH);

  float acc[VPT][FPT];
#pragma unroll
  for (int v = 0; v < VPT; ++v)
#pragma unroll
    for (int f = 0; f < FPT; ++f) acc[v][f] = 0.f;

  const float* xn = x + static_cast<size_t>(n) * g.C * g.D * g.H * g.W;
  const int nchunks = (g.C + g.CC - 1) / g.CC;
  const int wstep = g.CC * g.FT;  // floats from one kx tap to the next
  build_row_table(g, tab, d0, h0);
  __syncthreads();
  stage_chunk(g, tab, xn, w, smem, 0, w0, f0);
  cp_async_commit();
  for (int k = 0; k < nchunks; ++k) {
    if (k + 1 < nchunks) {
      stage_chunk(g, tab, xn, w, smem + ((k + 1) & 1) * stage, (k + 1) * g.CC, w0, f0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* xs = smem + (k & 1) * stage + (lz * g.SH + ly) * g.RS + lx;
    const float* ws = smem + (k & 1) * stage + g.xs_floats + fg * FPT;
    const int cn = min(g.CC, g.C - k * g.CC);  // the chunk's channels that exist
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
    __syncthreads();
  }

  const int gd = d0 + lz, gh = h0 + ly;
  if (gd >= g.D || gh >= g.H) return;
  const size_t plane = static_cast<size_t>(g.H) * g.W;
#pragma unroll
  for (int f = 0; f < FPT; ++f) {
    const int gf = f0 + fg * FPT + f;
    if (gf >= g.F) continue;
    float* yrow = y + ((static_cast<size_t>(n) * g.F + gf) * g.D + gd) * plane +
                  static_cast<size_t>(gh) * g.W;
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const int gw = w0 + lx + v;
      if (gw < g.W) yrow[gw] = acc[v][f];
    }
  }
}

template <int KW, int VPT, int FPT>
int launch(const float* x, const float* w, float* y, int n, const Geo& g, int threads,
           size_t smem, cudaStream_t stream) {
  const auto kernel = conv3d_fwd_kernel<KW, VPT, FPT>;
  if (threads > (VPT == 8 ? 256 : 128)) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(static_cast<long long>(n) * g.nbox),
                  static_cast<unsigned>((g.F + g.FT - 1) / g.FT));
  kernel<<<grid, threads, smem, stream>>>(x, w, y, g);
  return static_cast<int>(cudaGetLastError());
}

template <int VPT, int FPT>
int launch_kw(int kw, const float* x, const float* w, float* y, int n, const Geo& g,
              int threads, size_t smem, cudaStream_t s) {
  switch (kw) {
    case 1: return launch<1, VPT, FPT>(x, w, y, n, g, threads, smem, s);
    case 3: return launch<3, VPT, FPT>(x, w, y, n, g, threads, smem, s);
    case 5: return launch<5, VPT, FPT>(x, w, y, n, g, threads, smem, s);
    case 7: return launch<7, VPT, FPT>(x, w, y, n, g, threads, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: (n, c, d, h, wd), w: (kd, kh, kw, c, f), y: (n, f, d, h, wd), f32, contiguous on the
// device of `stream`.  The plan (ops/conv3d_flat.py::conv_simt_plan): the output box
// (bd, bh, bw), the channel chunk cc, the output tile ft, the register tile vpt x fpt
// (8 x 8, 4 x 4, 4 x 2 or 4 x 1), the weight copy vw (4: 16-byte copies, w 16-byte
// aligned and f % 4 == 0; or 1) and the shared bytes it computed; a plan this kernel
// cannot run is refused.
// Returns a cudaError_t (0 when the launch was accepted); the caller checks it.
extern "C" int saragan_conv3d_fwd(const void* x, const void* w, void* y, int n, int c, int d,
                                  int h, int wd, int kd, int kh, int kw, int f, int bd, int bh,
                                  int bw, int cc, int ft, int vpt, int fpt, int vw,
                                  long long smem, void* stream) {
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
  g.nbh = (h + bh - 1) / bh, g.nbw = (wd + bw - 1) / bw;
  const long long nbox = static_cast<long long>((d + bd - 1) / bd) * g.nbh * g.nbw;
  g.CC = cc, g.lcc = ilog2(cc), g.FT = ft, g.lft = ilog2(ft), g.vw = vw;
  const int threads = (bd * bh * bw / vpt) * (ft / fpt);
  int lw = 1;
  while (lw < g.SW && lw < 32 && lw < threads) lw *= 2;
  g.LW = lw;
  g.rows = cc * g.SD * g.SH;
  g.xs_floats = round_up(g.rows * g.RS, 4);
  g.ws_floats = g.taps * cc * ft;
  if (static_cast<long long>(d) * h > INT_MAX) return bad;  // the row table's rows
  const size_t need = 2 * (static_cast<size_t>(g.xs_floats) + g.ws_floats) * sizeof(float) +
                      static_cast<size_t>(g.rows) * sizeof(int2);
  if (need != static_cast<size_t>(smem) || need > MAX_SMEM) return bad;
  if (nbox * n > INT_MAX || (f + ft - 1) / ft > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  g.nbox = static_cast<int>(nbox);

  const float* xt = static_cast<const float*>(x);
  const float* wt = static_cast<const float*>(w);
  float* yt = static_cast<float*>(y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vpt == 8) return launch_kw<8, 8>(kw, xt, wt, yt, n, g, threads, need, s);
  if (fpt == 4) return launch_kw<4, 4>(kw, xt, wt, yt, n, g, threads, need, s);
  if (fpt == 2) return launch_kw<4, 2>(kw, xt, wt, yt, n, g, threads, need, s);
  return launch_kw<4, 1>(kw, xt, wt, yt, n, g, threads, need, s);
}

extern "C" const char* saragan_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
