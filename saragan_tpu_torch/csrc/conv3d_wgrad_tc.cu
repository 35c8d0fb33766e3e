// Weight gradient of the SAME, stride-1 3-D convolution in bf16 on the tensor cores
// (mma.sync), for Hopper (sm_90a).
//
// Replaces saragan_tpu/ops/pallas_conv.py::conv3d_flat_wgrad (kernel body _wgrad_kernel)
// for bf16:
//   dw[kz, ky, kx, c, f] = sum_{n, p} x[n, c, p + (kz, ky, kx) - k//2] * dy[n, f, p]
// with zero padding outside the volume, x and dy in NCDHW, dw in (kd, kh, kw, C, F); bf16
// operands, f32 products and sums, dw rounded once.  Odd kernel sizes only.  f32 stays on
// conv3d_wgrad.cu (CUDA cores; no TF32).
//
// What bounds it: a reduction over every position of the batch (8.4 M at the phase-6
// stacked critic pass) into a small output, 2 * taps * C * F operations per position for
// (C + F) * 2 bytes: the tensor cores' rate on the card.
//
// Design: per tap a GEMM dw[tap][c][f] = sum_p xbox[p + delta_tap][c] * dy[p][f], M = input
// channels, N = output channels, K = positions.
//   * Split-K as in conv3d_wgrad.cu: the position boxes (one sample, 128 positions, the box
//     of the host plan) are cut into `splits` fixed chunks; block (split, c-tile,
//     f-tile x tap group) reduces its chunk into its own slot of an f32 workspace, and a
//     second kernel adds the slots in split order.  No float atomics: dw is bit-identical
//     from run to run, which the trainer's bitwise resume depends on.
//   * Per box the block stages x channels-last with its halo (mma_bf16.cuh) and dy as it
//     lies, position-contiguous per output channel (cp.async where aligned), two stages
//     deep: box b+1 is staged while box b runs its mmas.  The x stager follows the output
//     tile: registers at 16 outputs per block, cp.async at 32, where the register
//     stager's extra registers would leave one block per SM (PERF.md).
//   * A (channels x positions) comes from the channels-last box via ldmatrix.trans at row
//     offset delta; B (positions x outputs) from the dy tile via plain ldmatrix.  The
//     block's jobs, (tap, 16-channel tile) pairs, are dealt to its 8 warps, at most 4 each,
//     so a thread holds at most 4 x NT x 4 accumulators; every warp shares one B fragment
//     per k step across its jobs.
//   * Channels past C and outputs past F are zero-filled and masked, so any C and F work.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "mma_bf16.cuh"

namespace {

using namespace saragan::tc;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int JPW = 4;   // jobs per warp at most
constexpr int MAXI = 4;  // register-staged items per thread (STAGER_REGS)
constexpr int REDUCE_THREADS = 256;

struct Geo {
  BoxGeo box;              // x box; box.CC is the channel tile
  int F, KD, KH, KW, taps;
  int nbd, nbh, nbw;       // boxes along D, H, W
  long long tiles, per_split;
  int FT, f_tiles, TPB;    // outputs per block, f tiles, taps per block
  int BP, DRS, ve_dy, lve_dy;  // box positions, dy row stride (BP + 8), dy vector width
                               // and its log2
  int dy_elems;            // one dy stage (a multiple of 8 elements)
};

// dy of outputs [f0, f0 + FT) over the box at (d0, h0, w0) as dys[ff * DRS + p], zero past
// F and outside the volume: cp.async of ve_dy elements where ve_dy >= 2, plain loads
// otherwise.
__device__ __forceinline__ void stage_dy(const Geo& g, const bf16* __restrict__ dy, bf16* dys, int n,
                                         int d0, int h0, int w0, int f0) {
  const BoxGeo& b = g.box;
  const size_t plane = static_cast<size_t>(b.H) * b.W;
  const size_t vol = plane * b.D;
  const int ve = g.ve_dy;
  const int lpr = b.lbw - g.lve_dy;  // vectors per box row: BW / ve (powers of two)
  const int items = (g.FT * b.BD * b.BH) << lpr;
  const uint32_t base = smem_u32(dys);
  for (int i = threadIdx.x; i < items; i += THREADS) {
    const int j = i & ((1 << lpr) - 1);
    int t = i >> lpr;
    const int ph = t & (b.BH - 1);
    t >>= b.lbh;
    const int pd = t & (b.BD - 1);
    const int ff = t >> b.lbd;
    const int f = f0 + ff, gd = d0 + pd, gh = h0 + ph, gw = w0 + j * ve;
    const bool in = f < g.F && gd < b.D && gh < b.H && gw < b.W;
    const int at = ff * g.DRS + (pd * b.BH + ph) * b.BW + j * ve;
    const bf16* src = in ? dy + (static_cast<size_t>(n) * g.F + f) * vol + gd * plane +
                               static_cast<size_t>(gh) * b.W + gw
                         : dy;
    if (ve >= 2) cp_async_ve(base + at * 2, src, ve, in);
    else dys[at] = in ? *src : __float2bfloat16_rn(0.f);
  }
}

__device__ __forceinline__ void box_origin(const Geo& g, long long t, int& n, int& d0, int& h0,
                                           int& w0) {
  const int ib = static_cast<int>(t % g.nbw);
  t /= g.nbw;
  const int jb = static_cast<int>(t % g.nbh);
  t /= g.nbh;
  const int kb = static_cast<int>(t % g.nbd);
  n = static_cast<int>(t / g.nbd);
  d0 = kb * g.box.BD, h0 = jb * g.box.BH, w0 = ib * g.box.BW;
}

template <int NT, int STAGER>
__global__ void __launch_bounds__(THREADS)
wgrad_tc_partial_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                        float* __restrict__ ws, Geo g) {
  static_assert(NT % 2 == 0, "B fragments come in pairs of n8 tiles");
  extern __shared__ uint4 smem[];
  const BoxGeo& bx = g.box;
  bf16* xs[2] = {reinterpret_cast<bf16*>(smem), reinterpret_cast<bf16*>(smem) + bx.xs_elems};
  bf16* dys[2] = {xs[1] + bx.xs_elems, xs[1] + bx.xs_elems + g.dy_elems};
  bf16* lnd = dys[1] + g.dy_elems;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long split = blockIdx.x;
  const int c0 = blockIdx.y * bx.CC;
  const int ftile = blockIdx.z % g.f_tiles;
  const int t0 = (blockIdx.z / g.f_tiles) * g.TPB;
  const int f0 = ftile * g.FT;
  const int ctiles = bx.CC / 16;
  const int t1 = min(g.taps, t0 + g.TPB);
  const int jobs = (t1 - t0) * ctiles;

  // this warp's jobs: (tap, 16-channel tile); A offset of each at the box's row 0
  int aoff[JPW];
  int jtap[JPW];
  int jct[JPW];
#pragma unroll
  for (int i = 0; i < JPW; ++i) {
    const int j = warp + i * WARPS;
    const int tap = t0 + (j < jobs ? j / ctiles : 0);
    jtap[i] = tap;
    jct[i] = j < jobs ? j % ctiles : -1;
    const int kx = tap % g.KW;
    const int ky = (tap / g.KW) % g.KH;
    const int kz = tap / (g.KW * g.KH);
    // ldmatrix.trans of the box: lane l addresses position (l / 16) * 8 + l % 8 of the k
    // step, channels ((l / 8) % 2) * 8 of the tile
    aoff[i] = ((kz * bx.SH + ky) * bx.SW + kx) * bx.RS + (jct[i] < 0 ? 0 : jct[i]) * 16 +
              ((lane >> 3) & 1) * 8;
  }
  const int apos = (lane >> 4) * 8 + (lane & 7);
  // B (plain ldmatrix of position-contiguous dy rows): output (l / 16) * 8 + l % 8,
  // positions ((l / 8) % 2) * 8 of the k step
  const int boff = ((lane >> 4) * 8 + (lane & 7)) * g.DRS + ((lane >> 3) & 1) * 8;

  float acc[JPW][NT][4];
#pragma unroll
  for (int i = 0; i < JPW; ++i)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][nt][q] = 0.f;

  const long long b_begin = split * g.per_split;
  const long long b_end = min(g.tiles, b_begin + g.per_split);
  XRegs<MAXI> regs;
  if (b_begin < b_end) {
    int n, d0, h0, w0;
    box_origin(g, b_begin, n, d0, h0, w0);
    stage_dy(g, dy, dys[0], n, d0, h0, w0, f0);
    x_begin<STAGER, MAXI, THREADS>(bx, regs, lnd, x, n, d0, h0, w0, c0);
    cp_async_commit();
    x_end<STAGER, MAXI, THREADS>(bx, regs, lnd, xs[0], x, n, d0, h0, w0, c0);
    cp_async_wait<0>();
    __syncthreads();
  }

  for (long long t = b_begin; t < b_end; ++t) {
    const int cur = static_cast<int>((t - b_begin) & 1);
    const bool more = t + 1 < b_end;
    int n, d0, h0, w0;
    if (more) {  // stage box t+1 while box t computes
      box_origin(g, t + 1, n, d0, h0, w0);
      stage_dy(g, dy, dys[cur ^ 1], n, d0, h0, w0, f0);
      x_begin<STAGER, MAXI, THREADS>(bx, regs, lnd, x, n, d0, h0, w0, c0);
      cp_async_commit();
    }
    const uint32_t xbase = smem_u32(xs[cur]);
    const uint32_t dbase = smem_u32(dys[cur]) + boff * 2;
    for (int k0 = 0; k0 < g.BP; k0 += 16) {
      uint32_t bf[NT / 2][4];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        ldmatrix_x4(bf[np], dbase + (np * 16 * g.DRS + k0) * 2);
      const int prow = box_row(bx, k0 + apos) * bx.RS;
#pragma unroll
      for (int i = 0; i < JPW; ++i) {
        if (jct[i] < 0) continue;  // warp-uniform
        uint32_t a[4];
        ldmatrix_x4_trans(a, xbase + (prow + aoff[i]) * 2);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_16816(acc[i][nt], a, bf[nt / 2][(nt & 1) * 2], bf[nt / 2][(nt & 1) * 2 + 1]);
      }
    }
    if (more) {
      x_end<STAGER, MAXI, THREADS>(bx, regs, lnd, xs[cur ^ 1], x, n, d0, h0, w0, c0);
      cp_async_wait<0>();
    }
    __syncthreads();
  }

  // d fragment: rows (input channels) l / 4 and + 8, columns (outputs) 2 * (l % 4) and + 1.
  // Every (split, tap, c, f) slot is written by exactly one thread, empty chunks too.
#pragma unroll
  for (int i = 0; i < JPW; ++i) {
    if (jct[i] < 0) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = c0 + jct[i] * 16 + (lane >> 2) + half * 8;
      if (c >= bx.C) continue;
      float* out = ws + ((split * g.taps + jtap[i]) * bx.C + c) * g.F;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int f = f0 + nt * 8 + (lane & 3) * 2;
        if (f < g.F) out[f] = acc[i][nt][half * 2];
        if (f + 1 < g.F) out[f + 1] = acc[i][nt][half * 2 + 1];
      }
    }
  }
}

__global__ void wgrad_tc_reduce_kernel(const float* __restrict__ ws, bf16* __restrict__ dw,
                                       long long kcf, long long splits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= kcf) return;
  float s = 0.f;
  for (long long k = 0; k < splits; ++k) s += ws[k * kcf + i];  // fixed order
  dw[i] = __float2bfloat16_rn(s);
}

int ilog2(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

template <int NT, int STAGER>
int launch(const bf16* x, const bf16* dy, bf16* dw, float* ws, const Geo& g, size_t smem,
           long long splits, int c_tiles, int z, cudaStream_t stream) {
  auto kernel = wgrad_tc_partial_kernel<NT, STAGER>;
  // per launch, not cached: the attribute belongs to the current device's context
  const cudaError_t allowed = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  kernel<<<dim3(static_cast<unsigned>(splits), static_cast<unsigned>(c_tiles),
                static_cast<unsigned>(z)),
           THREADS, smem, stream>>>(x, dy, ws, g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long kcf = static_cast<long long>(g.taps) * g.box.C * g.F;
  const long long blocks = (kcf + REDUCE_THREADS - 1) / REDUCE_THREADS;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  wgrad_tc_reduce_kernel<<<static_cast<unsigned>(blocks), REDUCE_THREADS, 0, stream>>>(
      ws, dw, kcf, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (n, c, d, h, wd), dy: (n, f, d, h, wd), dw: (kd, kh, kw, c, f), bf16, contiguous on
// the device of `stream`; ws: f32 scratch of splits * kd*kh*kw * c * f elements.  The plan
// (box, channel tile ct, output tile ft, taps per block tpb, splits and boxes per split,
// stager, vector widths of x and dy, shared bytes) comes from
// ops/conv3d_flat.py::wgrad_tc_plan; this function re-derives what it can and refuses a
// plan it cannot run.  Returns a cudaError_t (0 when both launches were accepted).
extern "C" int saragan_conv3d_wgrad_tc(const void* x, const void* dy, void* dw, float* ws,
                                       long long ws_floats, int n, int c, int d, int h, int wd,
                                       int kd, int kh, int kw, int f, int bd, int bh, int bw,
                                       int ct, int ft, int tpb, long long splits,
                                       long long per_split, int stager, int ve, int ve_dy,
                                       long long smem, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || c <= 0 || d <= 0 || h <= 0 || wd <= 0 || f <= 0) return bad;
  if (kd <= 0 || kh <= 0 || kw <= 0 || kd % 2 == 0 || kh % 2 == 0 || kw % 2 == 0) return bad;
  if (!pow2(bd) || !pow2(bh) || !pow2(bw) || bd * bh * bw < 16) return bad;
  if (ct < 16 || !pow2(ct) || (ft != 16 && ft != 32)) return bad;
  const int taps = kd * kh * kw;
  if (tpb <= 0 || tpb * (ct / 16) > WARPS * JPW) return bad;
  if (stager != STAGER_REGS && !(stager == STAGER_CPASYNC && ft == 32)) return bad;
  if (ve != 1 && ve != 2 && ve != 4 && ve != 8) return bad;
  if (ve > bw || wd % ve != 0 || reinterpret_cast<uintptr_t>(x) % (2 * ve) != 0) return bad;
  if (stager == STAGER_CPASYNC && ve < 2) return bad;
  if (ve_dy != 1 && ve_dy != 2 && ve_dy != 4 && ve_dy != 8) return bad;
  if (ve_dy > bw || wd % ve_dy != 0 || reinterpret_cast<uintptr_t>(dy) % (2 * ve_dy) != 0)
    return bad;

  Geo g{};
  BoxGeo& b = g.box;
  b.C = c, b.D = d, b.H = h, b.W = wd;
  b.BD = bd, b.BH = bh, b.BW = bw, b.lbd = ilog2(bd), b.lbh = ilog2(bh), b.lbw = ilog2(bw);
  b.PD = kd / 2, b.PH = kh / 2, b.PW = kw / 2;
  b.SD = bd + kd - 1, b.SH = bh + kh - 1, b.SW = bw + kw - 1, b.srows = b.SD * b.SH;
  b.CC = ct, b.RS = ct + 8, b.lpairs = ilog2(ct / 2);
  b.ve = ve, b.wpad = round_up(b.PW, ve), b.nv = (bw + 2 * b.wpad) / ve;
  b.LW = round_up(b.nv * ve, 8);
  b.xs_elems = round_up(b.srows * b.SW * b.RS, 8);
  b.lnd_elems = stager == STAGER_CPASYNC ? ct * b.srows * b.LW : 0;
  g.F = f, g.KD = kd, g.KH = kh, g.KW = kw, g.taps = taps;
  g.nbd = (d + bd - 1) / bd, g.nbh = (h + bh - 1) / bh, g.nbw = (wd + bw - 1) / bw;
  g.tiles = static_cast<long long>(n) * g.nbd * g.nbh * g.nbw;
  g.per_split = per_split;
  g.FT = ft, g.f_tiles = (f + ft - 1) / ft, g.TPB = tpb;
  g.BP = bd * bh * bw, g.DRS = g.BP + 8, g.ve_dy = ve_dy, g.lve_dy = ilog2(ve_dy);
  g.dy_elems = round_up(ft * g.DRS, 8);
  const size_t need = (2 * static_cast<size_t>(b.xs_elems) + 2 * static_cast<size_t>(g.dy_elems) +
                       static_cast<size_t>(b.lnd_elems)) * sizeof(bf16);
  if (need != static_cast<size_t>(smem) || need > MAX_SMEM) return bad;
  // every split holds at least one box, and the splits cover every box exactly once
  if (per_split <= 0 || splits <= 0 || (splits - 1) * per_split >= g.tiles ||
      splits * per_split < g.tiles)
    return bad;
  const long long kcf = static_cast<long long>(taps) * c * f;
  if (ws_floats < splits * kcf) return bad;
  const int c_tiles = (c + ct - 1) / ct;
  const long long z = static_cast<long long>(g.f_tiles) * ((taps + tpb - 1) / tpb);
  if (splits > INT_MAX || c_tiles > 65535 || z > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const bf16* xt = static_cast<const bf16*>(x);
  const bf16* dyt = static_cast<const bf16*>(dy);
  bf16* dwt = static_cast<bf16*>(dw);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int zi = static_cast<int>(z);
  if (ft == 16) return launch<2, STAGER_REGS>(xt, dyt, dwt, ws, g, need, splits, c_tiles, zi, s);
  // 32 outputs: cp.async, or registers where x allows no vector of 2 or more elements
  return stager == STAGER_CPASYNC
             ? launch<4, STAGER_CPASYNC>(xt, dyt, dwt, ws, g, need, splits, c_tiles, zi, s)
             : launch<4, STAGER_REGS>(xt, dyt, dwt, ws, g, need, splits, c_tiles, zi, s);
}

extern "C" const char* saragan_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
