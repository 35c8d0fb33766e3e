// Weight gradient of the SAME, stride-1 3-D convolution, f32 on CUDA cores, for Hopper
// (sm_90a).
//
// Replaces saragan_tpu/ops/pallas_conv.py::conv3d_flat_wgrad (kernel body _wgrad_kernel):
//   dw[kz, ky, kx, c, f] = sum_{n, p} x[n, c, p + (kz, ky, kx) - k//2] * dy[n, f, p]
// with zero padding outside the volume, x in NCDHW, dy in NCDHW with F channels, dw in
// (kd, kh, kw, C, F).  f32 only: bf16 goes to the tensor-core kernel conv3d_wgrad_tc.cu
// (ops/conv3d_flat.py routes by dtype).  Products and sums are f32, as the reference's
// f32 accumulator (pallas_conv.py:218).  Only odd kernel sizes, as in conv3d_fwd.cu.
//
// What bounds it: the reduction runs over every position of the batch (8.4 M at the
// phase-6 stacked critic pass) into a small output (27 x 16 x 32), so there are about
// 2 * K * C * F operations for each (C + F) * 4 bytes read: operations, not device
// memory, on CUDA cores (67 TFLOP/s; tensor cores in f32 would mean TF32, which the port
// keeps off).
//
// Design: the GEMM dw[(tap, c), f] = sum_p xshift[(tap, c), p] * dy[f, p], K = positions.
// The TPU kernel walks its sequential grid and adds into one VMEM-resident output; blocks
// on Hopper run in parallel, so the reduction is split instead, in a fixed way (split-K),
// with no float atomics, so dw is bit-identical from run to run:
//   * pass 1: block (s, c tile, f tile) reduces the s-th run of consecutive position
//     boxes (one sample's BD x BH x BW positions each, the box fitted to the volume by the
//     host plan, ops/conv3d_flat.py::wgrad_simt_plan).  Per box it stages the halo'd x box
//     of its CT input channels and the dy box of its FT outputs by cp.async, 16-byte copies
//     where W % 4 == 0 and the operand is aligned (x rows then start 4 columns before the
//     box, on a 16-byte word), two stages deep (box t + 1 lands while box t computes;
//     zero-fill outside the volume and past C and F); where each staged x row lies is
//     worked out once per block into a table, so staging does no division;
//   * thread (f group, position group, c, kz, ky group) keeps an outer-product tile of
//     RY x KW taps (a tap row group of one (c, kz)) by 8 outputs in registers, 72 sums for
//     3 x 3.  Per VPT (8, or 4 in boxes 4 wide) W positions of a box row it reads RY x-row
//     segments of VPT + KW - 1 floats as float4 words, every float reused across the KW
//     taps, and 8 x VPT / 4 dy float4 words that the threads of a warp share, for
//     RY * KW * 8 * VPT FMAs.  Consecutive
//     threads read x rows of consecutive (c, kz), whose starts are odd multiples of 16
//     bytes apart: a quarter warp's float4 reads fall in distinct banks;
//   * the position groups split each box's rows; each (split, position group) writes its
//     own slot of an f32 workspace, so a sum never crosses threads inside a block;
//   * pass 2: the slots are added in slot order, 32 at a time into partial sums (one
//     thread per (output, group)), then the partial sums in order, so that a few thousand
//     outputs still keep enough loads in flight.
// The split, the box, the tile and so the summation order are functions of the shapes
// alone (never of pointer alignment, which only picks dy's copy width).

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int FPT = 8;          // outputs per thread
constexpr int MAX_THREADS = 384;
constexpr size_t MAX_SMEM = 232448;  // 227 KB usable by one block
constexpr int REDUCE_THREADS = 256;
constexpr int REDUCE_GROUP = 32;  // slots per partial sum of pass 2

struct Geo {
  int C, D, H, W, F, KD, KH, KW;
  int BD, BH, BW, lbh, lbw, lrows;  // position box (powers of two), log2 BH, BW, BD * BH
  int SD, SH, SHs, SWv, RS, CS;  // staged x box: SD x SH rows of SWv = BW + 8 columns from
                                 // w0 - 4; row stride RS (4 x odd), SHs (odd) rows per
                                 // plane, channel stride CS (floats, a multiple of 4)
  int PD, PH, PW;
  int CT, FT, PG, YG;           // channels, outputs, position groups, ky groups per block
  int nbd, nbh, nbw;
  int xrows;                    // staged x rows per box: CT * SD * SH (the row table)
  int xs_floats, ds_floats;     // one stage of each (multiples of 4)
  int vx, vdy;                  // x and dy copies: 4 (16-byte) or 1 floats
  int LW;                       // x staging: lanes per row (a power of two)
  long long tiles, per_split;
};

__host__ __device__ constexpr bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

__host__ __device__ constexpr int ilog2(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// Box `tile` of the batch (W fastest, then H, D, sample) into one stage: the halo'd x box
// of channels [c0, c0 + CT) as xs[cl * CS + (sz * SHs + sy) * RS + sx], column sx holding
// x at w0 - 4 + sx (so rows start on 16-byte words wherever W % 4 == 0), the dy box of
// outputs [f0, f0 + FT) as ds[ff * (BD * BH * BW) + (bz * BH + by) * BW + bx]; zeros
// outside the volume and past C and F.  `tab` packs each staged x row as cl << 16 | sz << 8
// | sy.  Commits nothing (the caller does).
__device__ __forceinline__ void stage_box(const Geo& g, const int* tab, const float* __restrict__ x,
                                          const float* __restrict__ dy, float* buf, long long tile,
                                          int c0, int f0) {
  long long b = tile;
  const int w0 = static_cast<int>(b % g.nbw) * g.BW;
  b /= g.nbw;
  const int h0 = static_cast<int>(b % g.nbh) * g.BH;
  b /= g.nbh;
  const int d0 = static_cast<int>(b % g.nbd) * g.BD;
  const int n = static_cast<int>(b / g.nbd);
  const size_t plane = static_cast<size_t>(g.H) * g.W;

  const float* xn = x + (static_cast<size_t>(n) * g.C + c0) * g.D * plane;
  const uint32_t xb = smem_u32(buf);
  const int groups = blockDim.x / g.LW;  // whole groups of LW lanes, one x row each
  for (int q = threadIdx.x / g.LW; q < g.xrows && threadIdx.x < groups * g.LW; q += groups) {
    const int t = tab[q];
    const int cl = t >> 16, sz = (t >> 8) & 255, sy = t & 255;
    const int gd = d0 - g.PD + sz, gh = h0 - g.PH + sy;
    const bool row_in = c0 + cl < g.C && gd >= 0 && gd < g.D && gh >= 0 && gh < g.H;
    const float* src_row = xn + (static_cast<size_t>(cl) * g.D + gd) * plane +
                           static_cast<size_t>(gh) * g.W;
    const uint32_t dst = xb + static_cast<uint32_t>(cl * g.CS + (sz * g.SHs + sy) * g.RS) * 4u;
    for (int v = threadIdx.x & (g.LW - 1); v * g.vx < g.SWv; v += g.LW) {
      // W % 4 == 0 with 16-byte copies: a vector lies wholly in or out of the volume
      const int gw = w0 - 4 + v * g.vx;
      const bool in = row_in && gw >= 0 && gw < g.W;
      if (g.vx == 4) cp_async<16>(dst + v * 16u, in ? src_row + gw : x, in);
      else cp_async<4>(dst + v * 4u, in ? src_row + gw : x, in);
    }
  }

  const float* dyn = dy + (static_cast<size_t>(n) * g.F + f0) * g.D * plane;
  const uint32_t db = xb + static_cast<uint32_t>(g.xs_floats) * 4u;
  const int lvec = ilog2(g.BW / g.vdy);  // vectors per box row: BW / vdy
  const int items = (g.FT << g.lrows) << lvec;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int j = i & ((1 << lvec) - 1);
    const int row = i >> lvec;          // (ff, bz, by)
    const int ff = row >> g.lrows;
    const int r = row & ((1 << g.lrows) - 1);
    const int gd = d0 + (r >> g.lbh), gh = h0 + (r & (g.BH - 1)), gw = w0 + j * g.vdy;
    const bool in = f0 + ff < g.F && gd < g.D && gh < g.H && gw < g.W;
    const float* src = in ? dyn + (static_cast<size_t>(ff) * g.D + gd) * plane +
                                static_cast<size_t>(gh) * g.W + gw
                          : dy;
    const uint32_t dst = db + static_cast<uint32_t>(i * g.vdy) * 4u;  // rows are BW long
    if (g.vdy == 4) cp_async<16>(dst, src, in);
    else cp_async<4>(dst, src, in);
  }
}

template <int KW, int RY, int VPT>
__global__ void __launch_bounds__(MAX_THREADS, 1)
wgrad_partial_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                     float* __restrict__ ws, const Geo g) {
  constexpr int PW = KW / 2;
  // the float4 words of a staged row that hold the columns the taps need: x at
  // w0 + bx - PW .. + VPT + PW - 1, staged at bx + 4 - PW ..
  constexpr int Q0 = (4 - PW) / 4, Q1 = (3 + VPT + PW) / 4;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int stage = g.xs_floats + g.ds_floats;
  int* tab = reinterpret_cast<int*>(smem + 2 * stage);

  const int c0 = blockIdx.y * g.CT;
  const int f0 = blockIdx.z * g.FT;
  // thread -> (f group, position group, c, kz, ky group), the ky group fastest
  int t = threadIdx.x;
  const int yg = t % g.YG;
  t /= g.YG;
  const int kz = t % g.KD;
  t /= g.KD;
  const int cl = t % g.CT;
  t /= g.CT;
  const int pg = t % g.PG;
  const int fg = t / g.PG;

  for (int q = threadIdx.x; q < g.xrows; q += blockDim.x) {
    const int plane_rows = g.SD * g.SH;
    const int c = q / plane_rows, rr = q - c * plane_rows;
    tab[q] = (c << 16) | ((rr / g.SH) << 8) | (rr % g.SH);
  }
  __syncthreads();

  float acc[RY][KW][FPT];
#pragma unroll
  for (int i = 0; i < RY; ++i)
#pragma unroll
    for (int k = 0; k < KW; ++k)
#pragma unroll
      for (int f = 0; f < FPT; ++f) acc[i][k][f] = 0.f;

  const long long first = static_cast<long long>(blockIdx.x) * g.per_split;
  const long long last = first + g.per_split < g.tiles ? first + g.per_split : g.tiles;
  const int count = static_cast<int>(last - first);
  const int box = (1 << g.lrows) * g.BW;  // positions per box
  if (count > 0) stage_box(g, tab, x, dy, smem, first, c0, f0);
  cp_async_commit();
  for (int k = 0; k < count; ++k) {
    cp_async_wait<0>();  // box k has landed (this thread's copies) ...
    __syncthreads();     // ... everyone's, and box k - 1's stage is free
    if (k + 1 < count) stage_box(g, tab, x, dy, smem + ((k + 1) & 1) * stage, first + k + 1, c0, f0);
    cp_async_commit();

    const float* xs = smem + (k & 1) * stage + cl * g.CS + yg * RY * g.RS;
    const float* ds = smem + (k & 1) * stage + g.xs_floats + fg * FPT * box;
    for (int r = pg; r < (1 << g.lrows); r += g.PG) {
      const int bz = r >> g.lbh, by = r & (g.BH - 1);
      const float* xr0 = xs + ((bz + kz) * g.SHs + by) * g.RS;
      const float* dr = ds + r * g.BW;
      for (int bx = 0; bx < g.BW; bx += VPT) {
        float xr[RY][VPT + KW - 1];
#pragma unroll
        for (int i = 0; i < RY; ++i) {
          const float4* q = reinterpret_cast<const float4*>(xr0 + i * g.RS + bx);
          float row[VPT + 8];
#pragma unroll
          for (int k = Q0; k <= Q1; ++k) {
            const float4 v = q[k];
            row[4 * k] = v.x, row[4 * k + 1] = v.y, row[4 * k + 2] = v.z, row[4 * k + 3] = v.w;
          }
#pragma unroll
          for (int j = 0; j < VPT + KW - 1; ++j) xr[i][j] = row[4 - PW + j];
        }
#pragma unroll
        for (int f = 0; f < FPT; ++f) {
          float dv[VPT];
#pragma unroll
          for (int k = 0; k < VPT / 4; ++k) {
            const float4 d4 = *reinterpret_cast<const float4*>(dr + f * box + bx + 4 * k);
            dv[4 * k] = d4.x, dv[4 * k + 1] = d4.y, dv[4 * k + 2] = d4.z, dv[4 * k + 3] = d4.w;
          }
#pragma unroll
          for (int i = 0; i < RY; ++i)
#pragma unroll
            for (int kx = 0; kx < KW; ++kx)
#pragma unroll
              for (int v = 0; v < VPT; ++v)
                acc[i][kx][f] = fmaf(xr[i][v + kx], dv[v], acc[i][kx][f]);
        }
      }
    }
  }

  // every (slot, tap, c, f) is written by exactly one thread, for empty splits too
  const int c = c0 + cl;
  if (c >= g.C) return;
  const long long taps = static_cast<long long>(g.KD) * g.KH * KW;
  const long long kcf = taps * g.C * g.F;
  float* slot = ws + (static_cast<long long>(blockIdx.x) * g.PG + pg) * kcf;
#pragma unroll
  for (int i = 0; i < RY; ++i) {
#pragma unroll
    for (int kx = 0; kx < KW; ++kx) {
      const long long tap = (static_cast<long long>(kz) * g.KH + yg * RY + i) * KW + kx;
      float* out = slot + (tap * g.C + c) * g.F;
#pragma unroll
      for (int f = 0; f < FPT; ++f) {
        const int gf = f0 + fg * FPT + f;
        if (gf < g.F) out[gf] = acc[i][kx][f];
      }
    }
  }
}

// out[g][i] = sum of slots [g * group, (g + 1) * group) of ws at output i, in slot order.
__global__ void wgrad_reduce_kernel(const float* __restrict__ ws, float* __restrict__ out,
                                    long long kcf, long long slots, int group) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= kcf) return;
  const long long k0 = static_cast<long long>(blockIdx.y) * group;
  const long long k1 = k0 + group < slots ? k0 + group : slots;
  float s = 0.f;
#pragma unroll 8
  for (long long k = k0; k < k1; ++k) s += ws[k * kcf + i];  // fixed order
  out[blockIdx.y * kcf + i] = s;
}

// Workspace floats: the slots, and the partial sums of REDUCE_GROUP slots each where there
// are more slots than one group.
long long workspace_floats(long long slots, long long kcf) {
  const long long groups = (slots + REDUCE_GROUP - 1) / REDUCE_GROUP;
  return (slots + (groups > 1 ? groups : 0)) * kcf;
}

template <int KW, int RY, int VPT>
int launch(const Geo& g, const float* x, const float* dy, float* dw, float* ws, int splits,
           int c_tiles, int f_tiles, int threads, size_t smem, long long kcf,
           cudaStream_t stream) {
  const auto kernel = wgrad_partial_kernel<KW, RY, VPT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(splits, c_tiles, f_tiles), threads, smem, stream>>>(x, dy, ws, g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // pass 2, a fixed association: groups of REDUCE_GROUP slots in order, then the groups
  // in order (one step where the slots fill one group)
  const long long blocks = (kcf + REDUCE_THREADS - 1) / REDUCE_THREADS;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long slots = static_cast<long long>(splits) * g.PG;
  const long long groups = (slots + REDUCE_GROUP - 1) / REDUCE_GROUP;
  if (groups == 1) {
    wgrad_reduce_kernel<<<dim3(static_cast<unsigned>(blocks), 1), REDUCE_THREADS, 0, stream>>>(
        ws, dw, kcf, slots, REDUCE_GROUP);
    return static_cast<int>(cudaGetLastError());
  }
  float* partial = ws + slots * kcf;
  wgrad_reduce_kernel<<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(groups)),
                        REDUCE_THREADS, 0, stream>>>(ws, partial, kcf, slots, REDUCE_GROUP);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  wgrad_reduce_kernel<<<dim3(static_cast<unsigned>(blocks), 1), REDUCE_THREADS, 0, stream>>>(
      partial, dw, kcf, groups, static_cast<int>(groups));
  return static_cast<int>(cudaGetLastError());
}

template <int VPT>
int launch_kw(int kw, int ry, const Geo& g, const float* x, const float* dy, float* dw, float* ws,
              int splits, int c_tiles, int f_tiles, int threads, size_t smem, long long kcf,
              cudaStream_t s) {
  if (ry == 3) {
    switch (kw) {
      case 1: return launch<1, 3, VPT>(g, x, dy, dw, ws, splits, c_tiles, f_tiles, threads, smem, kcf, s);
      case 3: return launch<3, 3, VPT>(g, x, dy, dw, ws, splits, c_tiles, f_tiles, threads, smem, kcf, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (kw) {
    case 1: return launch<1, 1, VPT>(g, x, dy, dw, ws, splits, c_tiles, f_tiles, threads, smem, kcf, s);
    case 3: return launch<3, 1, VPT>(g, x, dy, dw, ws, splits, c_tiles, f_tiles, threads, smem, kcf, s);
    case 5: return launch<5, 1, VPT>(g, x, dy, dw, ws, splits, c_tiles, f_tiles, threads, smem, kcf, s);
    case 7: return launch<7, 1, VPT>(g, x, dy, dw, ws, splits, c_tiles, f_tiles, threads, smem, kcf, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: (n, c, d, h, wd), dy: (n, f, d, h, wd), dw: (kd, kh, kw, c, f), f32, contiguous on
// the device of `stream`; ws: f32 scratch of ws_floats >= (slots + groups) * kd*kh*kw*c*f
// floats, slots = splits * pg, groups = ceil(slots / 32) (none where that is 1).
// The plan (ops/conv3d_flat.py::wgrad_simt_plan): the position box (bd, bh, bw), the
// channel and output tiles ct and ft (ft a multiple of 8), the position groups pg, the
// tap rows per thread ry (1, or 3 where kh is a multiple of 3 and kw <= 3), the W
// positions per inner step vpt (4, or 8 where bw allows), the splits
// and the boxes per split, x's and dy's copy widths vx, vdy (4: 16-byte copies, the
// operand 16-byte aligned and wd % 4 == 0; or 1) and the shared bytes; a plan this kernel
// cannot run is refused.
// Returns a cudaError_t (0 when both launches were accepted); the caller checks it.
extern "C" int saragan_conv3d_wgrad(const void* x, const void* dy, void* dw, float* ws,
                                    long long ws_floats, int n, int c, int d, int h, int wd,
                                    int kd, int kh, int kw, int f, int bd, int bh, int bw,
                                    int ct, int ft, int pg, int ry, int vpt, int splits,
                                    long long per_split, int vx, int vdy, long long smem,
                                    void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || c <= 0 || d <= 0 || h <= 0 || wd <= 0 || f <= 0) return bad;
  if (kd <= 0 || kh <= 0 || kw <= 0 || kd % 2 == 0 || kh % 2 == 0 || kw % 2 == 0) return bad;
  if (!pow2(bd) || !pow2(bh) || !pow2(bw) || (vpt != 4 && vpt != 8) || bw < vpt || !pow2(ct) ||
      !pow2(ft) || ft < FPT ||
      !pow2(pg) || pg > bd * bh) return bad;
  if (!(ry == 1 || (ry == 3 && kh % 3 == 0 && kw <= 3))) return bad;
  if (!(vdy == 1 || (vdy == 4 && wd % 4 == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0)) ||
      !(vx == 1 || (vx == 4 && wd % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0))) {
    return bad;
  }

  Geo g{};
  g.C = c, g.D = d, g.H = h, g.W = wd, g.F = f, g.KD = kd, g.KH = kh, g.KW = kw;
  g.BD = bd, g.BH = bh, g.BW = bw, g.lbh = ilog2(bh), g.lbw = ilog2(bw), g.lrows = ilog2(bd * bh);
  g.SD = bd + kd - 1, g.SH = bh + kh - 1, g.SHs = g.SH | 1, g.SWv = bw + 8;
  if (g.SD > 255 || g.SH > 255 || ct > 32767 || kw > 9) return bad;  // packing; 4-word halo
  // strides in 16-byte words: RQ odd, and a channel's CQ the least at or above its rows
  // with CQ = KD * SHs * RQ (mod 8), so that the rows of 8 consecutive (c, kz) start at
  // consecutive odd multiples of SHs * RQ words: a quarter warp's float4 reads of one
  // column fall in distinct banks
  const int rq = (bw + 8) / 4 | 1;
  const int box_q = g.SD * g.SHs * rq;
  g.RS = 4 * rq;
  g.CS = 4 * (box_q + ((kd * g.SHs * rq - box_q) % 8 + 8) % 8);
  g.PD = kd / 2, g.PH = kh / 2, g.PW = kw / 2;
  g.CT = ct, g.FT = ft, g.PG = pg, g.YG = kh / ry;
  g.nbd = (d + bd - 1) / bd, g.nbh = (h + bh - 1) / bh, g.nbw = (wd + bw - 1) / bw;
  g.xrows = ct * g.SD * g.SH;
  g.xs_floats = ct * g.CS;
  g.ds_floats = ft * bd * bh * bw;
  g.vx = vx, g.vdy = vdy;
  const int threads = (ft / FPT) * pg * ct * kd * g.YG;
  if (threads > MAX_THREADS) return bad;
  int lw = 1;  // at most the block's threads, which need not be a power of two
  while (lw * vx < g.SWv && lw < 32 && 2 * lw <= threads) lw *= 2;
  g.LW = lw;
  const size_t need = 2 * (static_cast<size_t>(g.xs_floats) + g.ds_floats) * sizeof(float) +
                      static_cast<size_t>(g.xrows) * sizeof(int);
  if (need != static_cast<size_t>(smem) || need > MAX_SMEM) return bad;
  g.tiles = static_cast<long long>(n) * g.nbd * g.nbh * g.nbw;
  g.per_split = per_split;
  if (splits <= 0 || per_split <= 0 || (splits - 1) * per_split >= g.tiles ||
      splits * per_split < g.tiles) return bad;
  const int c_tiles = (c + ct - 1) / ct, f_tiles = (f + ft - 1) / ft;
  if (c_tiles > 65535 || f_tiles > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long kcf = static_cast<long long>(kd) * kh * kw * c * f;
  const long long slots = static_cast<long long>(splits) * pg;
  if (ws_floats < workspace_floats(slots, kcf) || (slots + REDUCE_GROUP - 1) / REDUCE_GROUP > 65535) {
    return bad;
  }

  const float* xt = static_cast<const float*>(x);
  const float* dyt = static_cast<const float*>(dy);
  float* dwt = static_cast<float*>(dw);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vpt == 8 ? launch_kw<8>(kw, ry, g, xt, dyt, dwt, ws, splits, c_tiles, f_tiles, threads,
                                 need, kcf, s)
                  : launch_kw<4>(kw, ry, g, xt, dyt, dwt, ws, splits, c_tiles, f_tiles, threads,
                                 need, kcf, s);
}

extern "C" const char* saragan_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
