// SAME, stride-1 3-D convolution forward, pipelined variant, in bf16 on the tensor cores
// (mma.sync), for Hopper (sm_90a).
//
// Replaces saragan_tpu/ops/pallas_conv.py::conv3d_flat_v2 (kernel body _fwd_v2_kernel) for
// bf16:
//   y[n, f, p] = sum_{kz,ky,kx} sum_c w[kz, ky, kx, c, f] * x[n, c, p + (kz, ky, kx) - k//2]
// the same function as kernel #1 (conv3d_fwd_tc.cu), with x in NCDHW, w in (kd, kh, kw, C, F),
// bf16 operands, f32 accumulation and one rounding at the store.  Odd kernel sizes only
// (SAME = k//2 on both sides); any C and F.  f32 goes to conv3d_fwd_v2.cu (CUDA cores: tensor
// cores in f32 would mean TF32, which the port keeps off).
//
// What makes v2 a kernel of its own is the TPU kernel's window pipeline: the input stays in
// device memory and asynchronous copies bring each work item's halo'd window into fast
// memory, several items ahead, while the current one computes (pallas_conv.py:246-267, its
// make_async_copy and semaphores).  Here, in Hopper's terms:
//   * blocks are persistent: the grid holds one or two blocks per SM (the host plan,
//     ops/conv3d_flat.py::conv_v2_tc_plan), and block b walks the work items b, b + grid,
//     ...; an item is one sample's 3-D box of output positions and FT outputs, walked in
//     channel chunks of CC (16 or 32);
//   * each (item, chunk) stage lands, by cp.async (16-byte copies, zero-filled outside the
//     volume: SAME padding for free), in a ring of STAGES = 3 shared-memory stages; stage
//     t + 2 is in flight while stage t computes (commit_group / wait_group, one block
//     barrier per stage).  Where the input has one chunk (C <= CC) the weights of the
//     block's fixed f tile are staged once, outside the ring (the TPU kernel keeps them
//     resident too); else each stage carries its chunk's weights (keeping every chunk's
//     resident where they fit measured slower on the card where a block takes few items,
//     PERF.md);
//   * the TPU stacks an im2col operand for C <= 32 to fill the MXU's contraction depth; here
//     a tap's 16-channel slice is already one mma k-step, read by ldmatrix from the staged
//     box at a row offset.  For that the box is staged channels-last (a tap shift along W
//     is then a whole row, 16-byte aligned; see mma_bf16.cuh), and so that the copy into
//     shared memory is a plain cp.async, a first pass writes x channels-last to a scratch
//     buffer (C rounded up to 8, zero-filled): one read and one write of x, which every
//     stage then reads in whole 32-byte sectors;
//   * the mma work is kernel #1's (mma_bf16.cuh: warp tiles of 2 x 16 positions by FT over
//     four or eight warps, or 16 positions by FT / 4 on the smallest planes; A by ldmatrix
//     from the box, B by ldmatrix.trans from the F-contiguous weights; k steps
//     software-pipelined).
// What bounds it: 27*C multiply-adds per output against 2 bytes in and 2 out, so the
// tensor cores' rate; the channels-last pass is bound by bytes.  Each output is summed by
// one thread (its mma accumulator) over the chunks in order, taps in (kz, ky, kx) order:
// the sum order depends on neither the batch size nor a sample's slot, whichever block
// takes the item, and reruns are bit-identical.  No atomics.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "mma_bf16.cuh"

namespace {

using namespace saragan::tc;

constexpr int STAGES = 3;  // the ring of (item, chunk) stages

struct Geo {
  BoxGeo box;          // the staged box (box.C: x's channels, those of the weights)
  int Cp;              // channels of the channels-last copy: C rounded up to 8
  int F, KD, KH, KW, taps;
  int nbd, nbh, nbw, f_tiles;  // boxes along D, H, W; output tiles
  int nchunks;         // ceil(C / CC)
  int FT, lft, WRS, vw;  // output channels per item and log2, weight row stride, weight vector
  int ws_elems;        // one weight stage (a multiple of 8 elements)
  int resident;        // 1: one chunk, the weights staged once per block outside the ring
  int stage_elems;     // one ring stage: the x box, and the weights unless resident
  int items;           // n * boxes * f_tiles, the f tile fastest
};

// x (N, C, vol) NCDHW -> xcl (N, vol, Cp) channels-last, channels C..Cp-1 zero.  One
// thread per position: its reads of one channel are consecutive across the warp.
__global__ void channels_last_kernel(const unsigned short* __restrict__ x, uint4* __restrict__ xcl,
                                     int C, int Cp, long long vol, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long n = i / vol;
  const unsigned short* src = x + i + n * (C - 1) * vol;  // x[n, 0, p], p = i - n * vol
  uint4* dst = xcl + i * (Cp / 8);
  for (int c0 = 0; c0 < Cp; c0 += 8) {
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + 2 * e;
      const uint32_t lo = c < C ? __ldg(src + c * vol) : 0u;
      const uint32_t hi = c + 1 < C ? __ldg(src + (c + 1) * vol) : 0u;
      v[e] = lo | (hi << 16);
    }
    dst[c0 / 8] = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// Chunk [c0, c0 + CC) of sample n's box at (d0, h0, w0) into `xs`, channels-last rows of
// RS: one 16-byte cp.async per (staged position, 8 channels), zeros outside the volume and
// past Cp.  `ptab` holds each staged position's (sz, sy, sx), packed 10 bits each.
template <int NTHREADS>
__device__ __forceinline__ void stage_x(const Geo& g, const int* ptab, const bf16* __restrict__ xcl,
                                        bf16* xs, int n, int d0, int h0, int w0, int c0) {
  const BoxGeo& b = g.box;
  const int lv = b.CC == 32 ? 2 : 1;  // log2 of the 16-byte vectors per staged position
  const int items = (b.srows * b.SW) << lv;
  const uint32_t base = smem_u32(xs);
  for (int i = threadIdx.x; i < items; i += NTHREADS) {
    const int j = i & ((1 << lv) - 1);
    const int s = i >> lv;
    const int t = ptab[s];
    const int gd = d0 - b.PD + (t >> 20), gh = h0 - b.PH + ((t >> 10) & 1023);
    const int gw = w0 - b.PW + (t & 1023);
    const int c = c0 + 8 * j;
    const bool in = c < g.Cp && gd >= 0 && gd < b.D && gh >= 0 && gh < b.H && gw >= 0 &&
                    gw < b.W;
    const bf16* src =
        in ? xcl + (((static_cast<size_t>(n) * b.D + gd) * b.H + gh) * b.W + gw) * g.Cp + c
           : xcl;
    cp_async<16>(base + (s * b.RS + 8 * j) * 2, src, in);
  }
}

// Work item `item` -> sample, box origin and first output channel.
__device__ __forceinline__ void item_origin(const Geo& g, int item, int& n, int& d0, int& h0,
                                            int& w0, int& f0) {
  f0 = (item % g.f_tiles) * g.FT;
  int b = item / g.f_tiles;
  w0 = (b % g.nbw) * g.box.BW;
  b /= g.nbw;
  h0 = (b % g.nbh) * g.box.BH;
  b /= g.nbh;
  d0 = (b % g.nbd) * g.box.BD;
  n = b / g.nbd;
}

template <int MT, int NT, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN)
conv3d_fwd_v2_tc_kernel(const bf16* __restrict__ xcl, const bf16* __restrict__ w,
                        bf16* __restrict__ y, Geo g) {
  constexpr int NTHREADS = 32 * WM * WN;
  static_assert(NT % 2 == 0, "B fragments come in pairs of n8 tiles");
  extern __shared__ uint4 smem[];
  const BoxGeo& bx = g.box;
  bf16* wres = reinterpret_cast<bf16*>(smem);  // the resident weights (g.resident)
  bf16* ring = wres + (g.resident ? g.ws_elems : 0);
  int* ptab = reinterpret_cast<int*>(ring + STAGES * g.stage_elems);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % WM, wn = warp / WM;
  // A: lane l addresses row l % 16 of its m tile, channels (l / 16) * 8 of the k step
  int arow[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) arow[mt] = box_row(bx, (wm * MT + mt) * 16 + (lane & 15));
  const int acol = (lane >> 4) * 8;
  // B (ldmatrix.trans of F-contiguous rows): k row (l % 8) + 8 * ((l / 8) % 2), n (l / 16) * 8
  const int bk = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int bn = wn * NT * 8 + (lane >> 4) * 8;

  for (int s = threadIdx.x; s < bx.srows * bx.SW; s += NTHREADS) {
    const int row = s / bx.SW;
    ptab[s] = ((row / bx.SH) << 20) | ((row % bx.SH) << 10) | (s - row * bx.SW);
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
    const int c0 = (t % g.nchunks) * bx.CC;
    bf16* st = ring + (t % STAGES) * g.stage_elems;
    stage_x<NTHREADS>(g, ptab, xcl, st, n, d0, h0, w0, c0);
    if (!g.resident) stage_w<NTHREADS>(g, w, st + bx.xs_elems, c0, f0);
  };
  if (g.resident && total > 0) {  // the grid is a multiple of f_tiles: one f tile per block
    stage_w<NTHREADS>(g, w, wres, 0, (blockIdx.x % g.f_tiles) * g.FT);
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) issue(s);
    cp_async_commit();  // empty groups keep the count uniform
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  const size_t plane = static_cast<size_t>(bx.H) * bx.W;
  const size_t vol = plane * bx.D;
  for (int t = 0; t < total; ++t) {
    cp_async_wait<STAGES - 2>();  // stage t has landed (this thread's copies) ...
    __syncthreads();              // ... everyone's, and stage t - 1's slot is free
    if (t + STAGES - 1 < total) issue(t + STAGES - 1);
    cp_async_commit();

    const bf16* xs = ring + (t % STAGES) * g.stage_elems;
    const bf16* ws = g.resident ? wres : xs + bx.xs_elems;
    uint32_t xrow[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) xrow[mt] = smem_u32(xs) + (arow[mt] * bx.RS + acol) * 2;
    const uint32_t wrow = smem_u32(ws) + (bk * g.WRS + bn) * 2;
    const uint32_t wstep = 16 * g.WRS * 2;  // bytes per k step of weight rows
    const int steps = g.taps * (bx.CC >> 4);
    KCursor kc{0, 0, 0, 0};
    uint32_t a0[MT][4], b0[NT / 2][4], a1[MT][4], b1[NT / 2][4];
    load_frags<MT, NT>(a0, b0, xrow, wrow, kc, bx.RS);
    advance(kc, g);
    for (int st = 0; st < steps; st += 2) {
      const bool one = st + 1 < steps, two = st + 2 < steps;
      if (one) {
        load_frags<MT, NT>(a1, b1, xrow, wrow + (st + 1) * wstep, kc, bx.RS);
        advance(kc, g);
      }
      mma_frags<MT, NT>(acc, a0, b0);
      if (one) {
        if (two) {
          load_frags<MT, NT>(a0, b0, xrow, wrow + (st + 2) * wstep, kc, bx.RS);
          advance(kc, g);
        }
        mma_frags<MT, NT>(acc, a1, b1);
      }
    }

    if (t % g.nchunks != g.nchunks - 1) continue;
    // the item's last chunk: store (d fragment: rows l / 4 and + 8, columns 2 * (l % 4)
    // and + 1) and restart the sums
    int n, d0, h0, w0, f0;
    item_origin(g, blockIdx.x + (t / g.nchunks) * gridDim.x, n, d0, h0, w0, f0);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = (wm * MT + mt) * 16 + (lane >> 2) + half * 8;
        const int gw = w0 + (p & (bx.BW - 1));
        const int gh = h0 + ((p >> bx.lbw) & (bx.BH - 1));
        const int gd = d0 + (p >> (bx.lbw + bx.lbh));
        const bool in = gd < bx.D && gh < bx.H && gw < bx.W;
        bf16* yp = y + static_cast<size_t>(n) * g.F * vol + gd * plane +
                   static_cast<size_t>(gh) * bx.W + gw;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int f = f0 + (wn * NT + nt) * 8 + (lane & 3) * 2;
          if (in && f < g.F) yp[f * vol] = __float2bfloat16_rn(acc[mt][nt][half * 2]);
          if (in && f + 1 < g.F) yp[(f + 1) * vol] = __float2bfloat16_rn(acc[mt][nt][half * 2 + 1]);
          acc[mt][nt][half * 2] = acc[mt][nt][half * 2 + 1] = 0.f;
        }
      }
    }
  }
}

int ilog2(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

template <int MT, int NT, int WM, int WN>
int launch(const bf16* xcl, const bf16* w, bf16* y, const Geo& g, size_t smem, int blocks,
           cudaStream_t stream) {
  auto kernel = conv3d_fwd_v2_tc_kernel<MT, NT, WM, WN>;
  // per launch, not cached: the attribute belongs to the current device's context
  const cudaError_t allowed = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  kernel<<<blocks, 32 * WM * WN, smem, stream>>>(xcl, w, y, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (n, c, d, h, wd), w: (kd, kh, kw, c, f), y: (n, f, d, h, wd), bf16, contiguous on the
// device of `stream`; xcl: bf16 scratch of n * d * h * wd * cp elements (16-byte aligned),
// cp = c rounded up to 8.  The plan (ops/conv3d_flat.py::conv_v2_tc_plan): the box
// bd x bh x bw, the channel chunk cc, the output tile ft, the warp layout (0: 128
// positions, four warps along M; 1: 16 positions, four warps along N; 2: 256 positions,
// eight warps along M), n8 tiles per warp nt, the weight vector vw (8: 16-byte copies, or
// 1), resident weights (one chunk only), the persistent grid `blocks` (a multiple of the
// f tiles where the weights are resident) and the shared bytes; a plan this function
// cannot run is refused.  Launches the channels-last pass, then the conv.  Returns a
// cudaError_t (0 when both launches were accepted); the caller checks it.
extern "C" int saragan_conv3d_fwd_v2_tc(const void* x, const void* w, void* y, void* xcl, int n,
                                        int c, int d, int h, int wd, int kd, int kh, int kw,
                                        int f, int bd, int bh, int bw, int cc, int ft,
                                        int layout, int nt, int vw, int resident, int blocks,
                                        long long smem, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || c <= 0 || d <= 0 || h <= 0 || wd <= 0 || f <= 0) return bad;
  if (kd <= 0 || kh <= 0 || kw <= 0 || kd % 2 == 0 || kh % 2 == 0 || kw % 2 == 0) return bad;
  if (!pow2(bd) || !pow2(bh) || !pow2(bw)) return bad;
  if ((cc != 16 && cc != 32) || (nt != 2 && nt != 4) || layout < 0 || layout > 2) return bad;
  if (bd * bh * bw != (layout == 0 ? 128 : layout == 1 ? 16 : 256)) return bad;
  if (ft != (layout == 1 ? 32 * nt : 8 * nt)) return bad;
  if (vw != 1 && !(vw == 8 && f % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0)) return bad;
  if (reinterpret_cast<uintptr_t>(xcl) % 16 != 0) return bad;

  Geo g{};
  BoxGeo& b = g.box;
  b.C = c, b.D = d, b.H = h, b.W = wd;
  b.BD = bd, b.BH = bh, b.BW = bw, b.lbd = ilog2(bd), b.lbh = ilog2(bh), b.lbw = ilog2(bw);
  b.PD = kd / 2, b.PH = kh / 2, b.PW = kw / 2;
  b.SD = bd + kd - 1, b.SH = bh + kh - 1, b.SW = bw + kw - 1, b.srows = b.SD * b.SH;
  b.CC = cc, b.RS = cc + 8, b.lpairs = ilog2(cc / 2);
  b.xs_elems = round_up(b.srows * b.SW * b.RS, 8);
  if (b.SD >= 1024 || b.SH >= 1024 || b.SW >= 1024) return bad;  // ptab packs 10 bits each
  g.Cp = round_up(c, 8);
  g.F = f, g.KD = kd, g.KH = kh, g.KW = kw, g.taps = kd * kh * kw;
  g.nbd = (d + bd - 1) / bd, g.nbh = (h + bh - 1) / bh, g.nbw = (wd + bw - 1) / bw;
  g.nchunks = (c + cc - 1) / cc;
  g.FT = ft, g.lft = ilog2(ft), g.WRS = ft + 8, g.vw = vw;
  g.f_tiles = (f + ft - 1) / ft;
  g.ws_elems = round_up(g.taps * cc * g.WRS, 8);
  if (resident != 0 && (resident != 1 || g.nchunks != 1)) return bad;
  g.resident = resident;
  g.stage_elems = b.xs_elems + (resident ? 0 : g.ws_elems);
  const size_t need = (static_cast<size_t>(resident ? g.ws_elems : 0) +
                       static_cast<size_t>(STAGES) * g.stage_elems) * sizeof(bf16) +
                      static_cast<size_t>(b.srows) * b.SW * sizeof(int);
  if (need != static_cast<size_t>(smem) || need > MAX_SMEM) return bad;
  const long long items = static_cast<long long>(n) * g.nbd * g.nbh * g.nbw * g.f_tiles;
  if (items > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  g.items = static_cast<int>(items);
  if (blocks <= 0 || blocks > g.items || (resident && blocks % g.f_tiles != 0)) return bad;

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long vol = static_cast<long long>(d) * h * wd;
  const long long positions = vol * n;
  channels_last_kernel<<<static_cast<unsigned>((positions + 255) / 256), 256, 0, s>>>(
      static_cast<const unsigned short*>(x), static_cast<uint4*>(xcl), c, g.Cp, vol, positions);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const bf16* xt = static_cast<const bf16*>(xcl);
  const bf16* wt = static_cast<const bf16*>(w);
  bf16* yt = static_cast<bf16*>(y);
  if (layout == 0)
    return nt == 2 ? launch<2, 2, 4, 1>(xt, wt, yt, g, need, blocks, s)
                   : launch<2, 4, 4, 1>(xt, wt, yt, g, need, blocks, s);
  if (layout == 2)
    return nt == 2 ? launch<2, 2, 8, 1>(xt, wt, yt, g, need, blocks, s)
                   : launch<2, 4, 8, 1>(xt, wt, yt, g, need, blocks, s);
  return nt == 2 ? launch<1, 2, 1, 4>(xt, wt, yt, g, need, blocks, s)
                 : launch<1, 4, 1, 4>(xt, wt, yt, g, need, blocks, s);
}

extern "C" const char* saragan_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
