// SAME, stride-1 3-D convolution forward in bf16 on the tensor cores (mma.sync), for
// Hopper (sm_90a).
//
// Replaces saragan_tpu/ops/pallas_conv.py::conv3d_flat (kernel body _fwd_kernel) for bf16:
//   y[n, f, p] = sum_{kz,ky,kx} sum_c w[kz, ky, kx, c, f] * x[n, c, p + (kz, ky, kx) - k//2]
// with zero padding outside the volume, x in NCDHW, w in (kd, kh, kw, C, F), bf16 operands,
// f32 accumulation and one rounding at the store.  With flipped, io-swapped weights it is
// the dgrad (ops/conv3d_grad.py).  Odd kernel sizes only (SAME = k//2 on both sides), as
// in conv3d_fwd.cu, which keeps the f32 convs (tensor cores in f32 would mean TF32, which
// the port keeps off).
//
// What bounds it: at the phase-6 shapes 27*C multiply-adds per output against 2 bytes in
// and 2 out, so the card's bound is the tensor cores' rate.  What holds this kernel back
// at the large planes is staging: each block reads its box with a halo of k//2 on every
// side, in 32-byte sectors of rows only 8 to 34 elements long, so the device-to-SM
// traffic is several times the input; the mmas and their shared-memory reads take less.
//
// Design: an implicit GEMM, y[p][f] = sum_tap sum_c xbox[p + delta_tap][c] * w[tap][c][f],
// M = positions, N = F, K = taps x channels.
//   * A block owns one sample's 3-D box of output positions, 256 on planes that hold
//     them, else 128, or 16 where the whole sample has 16 or fewer, and FT output
//     channels.  The host plan chooses the box's shape per volume: the shape whose staged
//     halo touches the fewest 32-byte sectors of device memory per output.
//   * It walks the input channels in chunks of CC (16 or 32).  Per chunk it stages the
//     halo'd box channels-last through registers (mma_bf16.cuh, STAGER_REGS: over the
//     step's shapes it beat the cp.async stager, PERF.md), one stage, and the weights
//     w[tap][c][f0:f0+FT] as they lie (F-contiguous rows, cp.async where 16-byte aligned),
//     two stages: chunk k+1's loads are in flight while chunk k runs its mmas.
//   * Warp tiles: layouts 0 and 2, four or eight warps along M, each 2 x 16 positions by
//     FT; layout 1, four warps along N, each 16 positions by FT / 4.  A comes from the box
//     via ldmatrix at row offset delta (every tap reads the same staged box); B from the
//     weights via ldmatrix.trans; the k steps are software-pipelined, step s+1's
//     fragments loading while step s runs its mmas.
//   * Channels past C and outputs past F are zero-filled in shared memory and masked at
//     the store, so any C and F are taken.  Each output is summed by one thread in a
//     fixed order: reruns are bit-identical.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "mma_bf16.cuh"

namespace {

using namespace saragan::tc;


struct Geo {
  BoxGeo box;
  int F, KD, KH, KW, taps;
  int nbd, nbh, nbw;   // boxes along D, H, W
  int nchunks;         // ceil(C / CC)
  int FT, lft, WRS, vw;  // output channels per block and log2, weight row stride (FT + 8),
                         // weight vector
  int ws_elems;        // one weight stage (a multiple of 8 elements)
};

template <int MT, int NT, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN)
conv3d_fwd_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ y,
                     Geo g) {
  constexpr int NTHREADS = 32 * WM * WN;
  constexpr int MAXI = NTHREADS == 128 ? 6 : 5;  // register-staged items per thread
  static_assert(NT % 2 == 0, "B fragments come in pairs of n8 tiles");
  extern __shared__ uint4 smem[];
  const BoxGeo& bx = g.box;
  // one x stage (the next chunk waits in registers while this one computes), two weight
  // stages
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws[2] = {xs + bx.xs_elems, xs + bx.xs_elems + g.ws_elems};

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % WM, wn = warp / WM;
  int b = blockIdx.x;
  const int ib = b % g.nbw;
  b /= g.nbw;
  const int jb = b % g.nbh;
  b /= g.nbh;
  const int kb = b % g.nbd;
  const int n = b / g.nbd;
  const int d0 = kb * bx.BD, h0 = jb * bx.BH, w0 = ib * bx.BW;
  const int f0 = blockIdx.y * g.FT;

  // A: lane l addresses row l % 16 of its m tile, channels (l / 16) * 8 of the k step
  int arow[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) arow[mt] = box_row(bx, (wm * MT + mt) * 16 + (lane & 15));
  const int acol = (lane >> 4) * 8;
  // B (ldmatrix.trans of F-contiguous rows): k row (l % 8) + 8 * ((l / 8) % 2), n (l / 16) * 8
  const int bk = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int bn = wn * NT * 8 + (lane >> 4) * 8;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  XRegs<MAXI> regs;
  stage_w<NTHREADS>(g, w, ws[0], 0, f0);
  x_begin<STAGER_REGS, MAXI, NTHREADS>(bx, regs, nullptr, x, n, d0, h0, w0, 0);
  cp_async_commit();
  x_end<STAGER_REGS, MAXI, NTHREADS>(bx, regs, nullptr, xs, x, n, d0, h0, w0, 0);
  cp_async_wait<0>();
  __syncthreads();

  for (int k = 0; k < g.nchunks; ++k) {
    const int cur = k & 1;
    const bool more = k + 1 < g.nchunks;
    const int c_next = (k + 1) * bx.CC;
    if (more) {  // stage chunk k+1 while chunk k computes
      stage_w<NTHREADS>(g, w, ws[cur ^ 1], c_next, f0);
      x_begin<STAGER_REGS, MAXI, NTHREADS>(bx, regs, nullptr, x, n, d0, h0, w0, c_next);
      cp_async_commit();
    }
    // the chunk's k steps, software-pipelined: step s+1's fragments load while step s
    // runs its mmas (two register sets, the loop unrolled by two)
    uint32_t xrow[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) xrow[mt] = smem_u32(xs) + (arow[mt] * bx.RS + acol) * 2;
    const uint32_t wrow = smem_u32(ws[cur]) + (bk * g.WRS + bn) * 2;
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
    if (more) {
      __syncthreads();  // every warp is done with this chunk's x
      x_end<STAGER_REGS, MAXI, NTHREADS>(bx, regs, nullptr, xs, x, n, d0, h0, w0, c_next);
      cp_async_wait<0>();
    }
    __syncthreads();
  }

  // d fragment: rows (positions) l / 4 and + 8, columns (outputs) 2 * (l % 4) and + 1
  const size_t plane = static_cast<size_t>(bx.H) * bx.W;
  const size_t vol = plane * bx.D;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = (wm * MT + mt) * 16 + (lane >> 2) + half * 8;
      const int gw = w0 + (p & (bx.BW - 1));
      const int gh = h0 + ((p >> bx.lbw) & (bx.BH - 1));
      const int gd = d0 + (p >> (bx.lbw + bx.lbh));
      if (gd >= bx.D || gh >= bx.H || gw >= bx.W) continue;
      bf16* yp = y + static_cast<size_t>(n) * g.F * vol + gd * plane +
                 static_cast<size_t>(gh) * bx.W + gw;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int f = f0 + (wn * NT + nt) * 8 + (lane & 3) * 2;
        if (f < g.F) yp[f * vol] = __float2bfloat16_rn(acc[mt][nt][half * 2]);
        if (f + 1 < g.F) yp[(f + 1) * vol] = __float2bfloat16_rn(acc[mt][nt][half * 2 + 1]);
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
int launch(const bf16* x, const bf16* w, bf16* y, const Geo& g, size_t smem, long long blocks,
           int f_tiles, cudaStream_t stream) {
  auto kernel = conv3d_fwd_tc_kernel<MT, NT, WM, WN>;
  // per launch, not cached: the attribute belongs to the current device's context
  const cudaError_t allowed = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  kernel<<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(f_tiles)), 32 * WM * WN,
           smem, stream>>>(x, w, y, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (n, c, d, h, wd), w: (kd, kh, kw, c, f), y: (n, f, d, h, wd), bf16, contiguous on the
// device of `stream`.  The plan (box bd x bh x bw, channel chunk cc, output tile ft, warp
// layout, n8 tiles per warp nt, x vector width ve, weight vector width vw, shared bytes) comes from ops/conv3d_flat.py::conv_tc_plan; this function re-derives what it can
// and refuses a plan it cannot run.  Returns a cudaError_t (0 when the launch was
// accepted); the caller checks it.
extern "C" int saragan_conv3d_fwd_tc(const void* x, const void* w, void* y, int n, int c, int d,
                                     int h, int wd, int kd, int kh, int kw, int f, int bd, int bh,
                                     int bw, int cc, int ft, int layout, int nt, int ve, int vw,
                                     long long smem, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || c <= 0 || d <= 0 || h <= 0 || wd <= 0 || f <= 0) return bad;
  if (kd <= 0 || kh <= 0 || kw <= 0 || kd % 2 == 0 || kh % 2 == 0 || kw % 2 == 0) return bad;
  if (!pow2(bd) || !pow2(bh) || !pow2(bw)) return bad;
  // layouts: 0, 128 positions, four warps along M; 1, 16 positions, four warps along N;
  // 2, 256 positions, eight warps along M
  if (cc < 16 || !pow2(cc) || (nt != 2 && nt != 4) || layout < 0 || layout > 2) return bad;
  if (bd * bh * bw != (layout == 0 ? 128 : layout == 1 ? 16 : 256)) return bad;
  if (ft != (layout == 1 ? 32 * nt : 8 * nt)) return bad;
  if (ve != 1 && ve != 2 && ve != 4 && ve != 8) return bad;
  if (ve > bw || wd % ve != 0 || reinterpret_cast<uintptr_t>(x) % (2 * ve) != 0) return bad;
  if (vw != 1 && !(vw == 8 && f % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0)) return bad;

  Geo g{};
  BoxGeo& b = g.box;
  b.C = c, b.D = d, b.H = h, b.W = wd;
  b.BD = bd, b.BH = bh, b.BW = bw, b.lbd = ilog2(bd), b.lbh = ilog2(bh), b.lbw = ilog2(bw);
  b.PD = kd / 2, b.PH = kh / 2, b.PW = kw / 2;
  b.SD = bd + kd - 1, b.SH = bh + kh - 1, b.SW = bw + kw - 1, b.srows = b.SD * b.SH;
  b.CC = cc, b.RS = cc + 8, b.lpairs = ilog2(cc / 2);
  b.ve = ve, b.wpad = round_up(b.PW, ve), b.nv = (bw + 2 * b.wpad) / ve;
  b.xs_elems = round_up(b.srows * b.SW * b.RS, 8);
  g.F = f, g.KD = kd, g.KH = kh, g.KW = kw, g.taps = kd * kh * kw;
  g.nbd = (d + bd - 1) / bd, g.nbh = (h + bh - 1) / bh, g.nbw = (wd + bw - 1) / bw;
  g.nchunks = (c + cc - 1) / cc;
  g.FT = ft, g.lft = ilog2(ft), g.WRS = ft + 8, g.vw = vw;
  g.ws_elems = round_up(g.taps * cc * g.WRS, 8);
  const size_t need =
      (static_cast<size_t>(b.xs_elems) + 2 * static_cast<size_t>(g.ws_elems)) * sizeof(bf16);
  if (need != static_cast<size_t>(smem) || need > MAX_SMEM) return bad;

  const long long blocks = static_cast<long long>(n) * g.nbd * g.nbh * g.nbw;
  const int f_tiles = (f + ft - 1) / ft;
  if (blocks > INT_MAX || f_tiles > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bf16* xt = static_cast<const bf16*>(x);
  const bf16* wt = static_cast<const bf16*>(w);
  bf16* yt = static_cast<bf16*>(y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layout == 0)
    return nt == 2 ? launch<2, 2, 4, 1>(xt, wt, yt, g, need, blocks, f_tiles, s)
                   : launch<2, 4, 4, 1>(xt, wt, yt, g, need, blocks, f_tiles, s);
  if (layout == 2)
    return nt == 2 ? launch<2, 2, 8, 1>(xt, wt, yt, g, need, blocks, f_tiles, s)
                   : launch<2, 4, 8, 1>(xt, wt, yt, g, need, blocks, f_tiles, s);
  return nt == 2 ? launch<1, 2, 1, 4>(xt, wt, yt, g, need, blocks, f_tiles, s)
                 : launch<1, 4, 1, 4>(xt, wt, yt, g, need, blocks, f_tiles, s);
}

extern "C" const char* saragan_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
