// Shared pieces of the tensor-core conv kernels (conv3d_fwd_tc.cu, conv3d_wgrad_tc.cu,
// conv3d_fwd_v2_tc.cu): thin wrappers of ldmatrix, mma.sync m16n8k16 (bf16 in, f32
// accumulators) and cp.async, the stager that copies a halo'd 3-D box of one sample from
// NCDHW device memory into shared memory channels-last, and the implicit-GEMM forward's
// weight staging and k-step loop.
//
// Why channels-last.  An mma fragment holds pairs of consecutive K elements, and both
// kernels contract over channels (the forward) or read a channel tile per position (the
// wgrad).  The taps shift the box by whole positions; along W that is an odd element
// offset, so in NCDHW shared memory a shifted operand would start at an odd bf16 address,
// where neither ldmatrix nor 32-bit loads work.  Channels-last, a tap shift is a change of
// row, and ldmatrix takes one 16-byte-aligned address per row: all taps read one staged
// box.  Rows hold CC channels plus 8 of padding, so the row stride is an odd multiple of
// 16 bytes and the 8 rows of one ldmatrix phase fall in 8 distinct bank groups.
//
// The stager transposes on the way in, which cp.async (contiguous bytes to contiguous
// bytes) cannot do, so it comes in two variants (the forward takes STAGER_REGS; the
// wgrad's host plan picks one by its output tile):
//   * STAGER_REGS: vector loads along W into registers, issued before the current chunk's
//     mma loop (x_begin), stored transposed after it (x_end): register double buffering.
//     Items beyond MAXI per thread are loaded and stored in x_end;
//   * STAGER_CPASYNC: cp.async into an NCDHW landing buffer (x_begin), then, after the mma
//     loop, a shared-to-shared transpose (x_end).  Needs vectors of at least 2 elements
//     (cp.async copies 4, 8 or 16 bytes); the plan falls back to STAGER_REGS otherwise.
// Both zero-fill outside the volume and past the last channel.  A vector of `ve` elements
// (8, 4, 2 or 1) is read where the global address allows it: W % ve == 0 and a base
// aligned to 2 * ve bytes; the plan takes the widest such ve.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace saragan {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int STAGER_REGS = 0;
constexpr int STAGER_CPASYNC = 1;
constexpr size_t MAX_SMEM = 232448;  // 227 KB usable by one block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8 and
// receives, of each matrix i, row l / 4, columns 2 * (l % 4) and + 1 in r[i].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same, each matrix transposed: lane l receives rows 2 * (l % 4) and + 1, column l / 4.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a * b over a 16x8x16 tile: a row-major 16x16 (4 registers of bf16 pairs), b
// column-major 16x8 (2 registers), d 16x8 f32 (lane l: rows l / 4 and + 8, columns
// 2 * (l % 4) and + 1).
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One cp.async of BYTES (4, 8 or 16); `in` false zero-fills the destination.
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool in) {
  const int src_bytes = in ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes)
                 : "memory");
  } else {
    static_assert(BYTES == 8 || BYTES == 4, "cp.async copies 4, 8 or 16 bytes");
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                 "n"(BYTES), "r"(src_bytes)
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

// cp.async of `ve` bf16 elements (2, 4 or 8).
__device__ __forceinline__ void cp_async_ve(uint32_t dst, const bf16* src, int ve, bool in) {
  if (ve == 8) cp_async<16>(dst, src, in);
  else if (ve == 4) cp_async<8>(dst, src, in);
  else cp_async<4>(dst, src, in);
}

// `ve` bf16 elements (8, 4, 2 or 1) from an address aligned to 2 * ve bytes, in the low
// words of a uint4; zeros when `in` is false (nothing is read).
__device__ __forceinline__ uint4 load_vec(const bf16* p, int ve, bool in) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (!in) return v;
  if (ve == 8) {
    v = __ldg(reinterpret_cast<const uint4*>(p));
  } else if (ve == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    v.x = t.x;
    v.y = t.y;
  } else if (ve == 2) {
    v.x = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    v.x = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  return v;
}

// Element e (a compile-time index after unrolling) of a vector from load_vec.
__device__ __forceinline__ uint32_t vec_elem(const uint4& v, int e) {
  const uint32_t word = e < 2 ? v.x : e < 4 ? v.y : e < 6 ? v.z : v.w;
  return (e & 1) ? (word >> 16) : (word & 0xffffu);
}

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Geometry of one staged box: the output (or, in the wgrad, reduction) box of
// BD x BH x BW positions with its halo, CC channels from c0, channels-last rows of RS.
struct BoxGeo {
  int C, D, H, W;           // input volume
  int BD, BH, BW, lbd, lbh, lbw;  // box (powers of two) and log2 of BD, BH, BW
  int PD, PH, PW;           // halo before the box: kd / 2, kh / 2, kw / 2
  int SD, SH, SW, srows;    // staged extents (box + k - 1), srows = SD * SH
  int CC, RS, lpairs;       // channels per stage (16 * 2^k), row stride CC + 8, log2(CC / 2)
  int ve, nv, wpad, LW;     // vector width, vectors per staged W row, left pad of the first
                            // vector (round_up(PW, ve)), landing row length (elements)
  int xs_elems, lnd_elems;  // one channels-last stage, the landing buffer (multiples of 8)
};

// Staged row of box position p (positions run W fastest, then H, then D).
__device__ __forceinline__ int box_row(const BoxGeo& g, int p) {
  const int pw = p & (g.BW - 1);
  const int ph = (p >> g.lbw) & (g.BH - 1);
  const int pd = p >> (g.lbw + g.lbh);
  return (pd * g.SH + ph) * g.SW + pw;
}

template <int MAXI>
struct XRegs {
  uint4 lo[MAXI];  // channel c of an item
  uint4 hi[MAXI];  // channel c + 1
};

// Register-stager item idx: the channel pair fastest (idx % (CC / 2)), then the staged
// (d, h) row, then the vector along W.  A warp's stores of one element then cover
// consecutive words of a few positions one staged row apart; with the vector fastest they
// would hit 32 positions a vector (8 x an odd multiple of 16 bytes) apart, one bank.
__device__ __forceinline__ void reg_item(const BoxGeo& g, const bf16* __restrict__ x, int idx,
                                         int n, int d0, int h0, int w0, int c0, uint4& lo,
                                         uint4& hi) {
  const int t = idx >> g.lpairs;
  const int row = t % g.srows;
  const int v = t / g.srows;
  const int c = c0 + 2 * (idx & ((1 << g.lpairs) - 1));
  const int gd = d0 - g.PD + row / g.SH;
  const int gh = h0 - g.PH + row % g.SH;
  const int gw = w0 - g.wpad + v * g.ve;
  const bool in = gd >= 0 && gd < g.D && gh >= 0 && gh < g.H && gw >= 0 && gw < g.W;
  const size_t vol = static_cast<size_t>(g.D) * g.H * g.W;
  const bf16* p = x + (static_cast<size_t>(n) * g.C + c) * vol +
                  (static_cast<size_t>(gd) * g.H + gh) * g.W + gw;
  lo = load_vec(p, g.ve, in && c < g.C);
  hi = load_vec(p + vol, g.ve, in && c + 1 < g.C);
}

__device__ __forceinline__ void reg_store(const BoxGeo& g, bf16* xs, int idx, const uint4& lo,
                                          const uint4& hi) {
  const int t = idx >> g.lpairs;
  const int row = t % g.srows;
  const int v = t / g.srows;
  const int cc = 2 * (idx & ((1 << g.lpairs) - 1));
  const int s0 = v * g.ve - g.wpad + g.PW;  // staged column of the vector's first element
  uint32_t* xs32 = reinterpret_cast<uint32_t*>(xs);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int s = s0 + e;
    if (e < g.ve && s >= 0 && s < g.SW)
      xs32[((row * g.SW + s) * g.RS + cc) >> 1] = vec_elem(lo, e) | (vec_elem(hi, e) << 16);
  }
}

// Start staging channels [c0, c0 + CC) of sample n around the box at (d0, h0, w0):
// STAGER_REGS loads up to MAXI items per thread into `r`; STAGER_CPASYNC issues the
// copies into the landing buffer (the caller commits the group).
template <int STAGER, int MAXI, int NTHREADS>
__device__ __forceinline__ void x_begin(const BoxGeo& g, XRegs<MAXI>& r, bf16* lnd,
                                        const bf16* __restrict__ x, int n, int d0, int h0,
                                        int w0, int c0) {
  if constexpr (STAGER == STAGER_REGS) {
    const int items = (g.CC / 2) * g.srows * g.nv;
#pragma unroll
    for (int j = 0; j < MAXI; ++j) {
      const int idx = threadIdx.x + j * NTHREADS;
      if (idx < items) reg_item(g, x, idx, n, d0, h0, w0, c0, r.lo[j], r.hi[j]);
    }
  } else {
    const int items = g.CC * g.srows * g.nv;
    const size_t vol = static_cast<size_t>(g.D) * g.H * g.W;
    const uint32_t base = smem_u32(lnd);
    for (int idx = threadIdx.x; idx < items; idx += NTHREADS) {
      const int v = idx % g.nv;
      const int t = idx / g.nv;
      const int row = t % g.srows;
      const int cl = t / g.srows;
      const int c = c0 + cl;
      const int gd = d0 - g.PD + row / g.SH;
      const int gh = h0 - g.PH + row % g.SH;
      const int gw = w0 - g.wpad + v * g.ve;
      const bool in = c < g.C && gd >= 0 && gd < g.D && gh >= 0 && gh < g.H && gw >= 0 &&
                      gw < g.W;
      const bf16* src = in ? x + (static_cast<size_t>(n) * g.C + c) * vol +
                                 (static_cast<size_t>(gd) * g.H + gh) * g.W + gw
                           : x;
      cp_async_ve(base + ((cl * g.srows + row) * g.LW + v * g.ve) * 2, src, g.ve, in);
    }
  }
}

// Finish the stage into `xs` (channels-last).  STAGER_CPASYNC waits for every cp.async
// group of this thread and synchronises the block first.
template <int STAGER, int MAXI, int NTHREADS>
__device__ __forceinline__ void x_end(const BoxGeo& g, XRegs<MAXI>& r, const bf16* lnd, bf16* xs,
                                      const bf16* __restrict__ x, int n, int d0, int h0, int w0,
                                      int c0) {
  if constexpr (STAGER == STAGER_REGS) {
    const int items = (g.CC / 2) * g.srows * g.nv;
#pragma unroll
    for (int j = 0; j < MAXI; ++j) {
      const int idx = threadIdx.x + j * NTHREADS;
      if (idx < items) reg_store(g, xs, idx, r.lo[j], r.hi[j]);
    }
    for (int idx = threadIdx.x + MAXI * NTHREADS; idx < items; idx += NTHREADS) {
      uint4 lo, hi;
      reg_item(g, x, idx, n, d0, h0, w0, c0, lo, hi);
      reg_store(g, xs, idx, lo, hi);
    }
  } else {
    cp_async_wait<0>();
    __syncthreads();
    // one thread per (position, 8 channels): 8 two-byte reads of consecutive columns
    // across the warp, one 16-byte store; 8 consecutive positions are an odd multiple of
    // 16 bytes apart, so each quarter warp's stores fall in distinct banks
    const unsigned short* l16 = reinterpret_cast<const unsigned short*>(lnd);
    const int npos = g.srows * g.SW;
    const int plane = g.srows * g.LW;  // one channel of the landing buffer
    const int off = g.wpad - g.PW;     // landing column of staged column 0
    for (int cg = 0; cg < g.CC; cg += 8) {
      for (int pos = threadIdx.x; pos < npos; pos += NTHREADS) {
        const int row = pos / g.SW;
        const unsigned short* src = l16 + (cg * g.srows + row) * g.LW + pos - row * g.SW + off;
        uint4 v;
        v.x = src[0] | (static_cast<uint32_t>(src[plane]) << 16);
        v.y = src[2 * plane] | (static_cast<uint32_t>(src[3 * plane]) << 16);
        v.z = src[4 * plane] | (static_cast<uint32_t>(src[5 * plane]) << 16);
        v.w = src[6 * plane] | (static_cast<uint32_t>(src[7 * plane]) << 16);
        *reinterpret_cast<uint4*>(xs + pos * g.RS + cg) = v;
      }
    }
  }
}

// --- the implicit-GEMM forward's pieces (conv3d_fwd_tc.cu, conv3d_fwd_v2_tc.cu): M =
// positions, N = outputs, K = (tap, channel).  `G` is a kernel's geometry: it holds a
// BoxGeo `box` and F, KH, KW, taps, FT, lft (log2 FT), WRS (weight row stride, FT + 8) and
// vw (weight vector width).

// Weights of channels [c0, c0 + CC) and outputs [f0, f0 + FT) as ws[(tap * CC + cc) * WRS + ff],
// zero past C and F: 16-byte cp.async where vw == 8, plain loads otherwise.
template <int NTHREADS, class G>
__device__ __forceinline__ void stage_w(const G& g, const bf16* __restrict__ w, bf16* ws, int c0,
                                        int f0) {
  const int C = g.box.C, CC = g.box.CC, lcc = g.box.lpairs + 1;  // CC and FT: powers of two
  if (g.vw == 8) {
    const int lpr = g.lft - 3;  // 16-byte vectors per row: FT / 8
    const int items = (g.taps * CC) << lpr;
    const uint32_t base = smem_u32(ws);
    for (int i = threadIdx.x; i < items; i += NTHREADS) {
      const int j = i & ((1 << lpr) - 1);
      const int t = i >> lpr;
      const int cc = t & (CC - 1);
      const int tap = t >> lcc;
      const int c = c0 + cc, f = f0 + 8 * j;
      const bool in = c < C && f < g.F;
      const bf16* src = in ? w + (static_cast<size_t>(tap) * C + c) * g.F + f : w;
      cp_async<16>(base + (t * g.WRS + 8 * j) * 2, src, in);
    }
  } else {
    const int items = (g.taps * CC) << g.lft;
    for (int i = threadIdx.x; i < items; i += NTHREADS) {
      const int ff = i & (g.FT - 1);
      const int t = i >> g.lft;
      const int cc = t & (CC - 1);
      const int tap = t >> lcc;
      const int c = c0 + cc, f = f0 + ff;
      ws[t * g.WRS + ff] = (c < C && f < g.F)
                               ? w[(static_cast<size_t>(tap) * C + c) * g.F + f]
                               : __float2bfloat16_rn(0.f);
    }
  }
}

// Walks a chunk's k steps, (tap, 16 channels), in the order of the weight rows: tap-major,
// taps in (kz, ky, kx) order; `delta` is the tap's staged-row offset.
struct KCursor {
  int ks, kx, ky, delta;
};

template <class G>
__device__ __forceinline__ void advance(KCursor& k, const G& g) {
  k.ks += 16;
  if (k.ks < g.box.CC) return;
  k.ks = 0;
  ++k.delta;
  if (++k.kx < g.KW) return;
  k.kx = 0;
  k.delta += g.box.SW - g.KW;
  if (++k.ky < g.KH) return;
  k.ky = 0;
  k.delta += (g.box.SH - g.KH) * g.box.SW;
}

// A fragments of the step at `k` for each m tile (lane base addresses `xrow`) and B
// fragments of the step's 16 weight rows at `wrow`.
template <int MT, int NT>
__device__ __forceinline__ void load_frags(uint32_t (&a)[MT][4], uint32_t (&b)[NT / 2][4],
                                           const uint32_t (&xrow)[MT], uint32_t wrow,
                                           const KCursor& k, int RS) {
  const uint32_t at = (k.delta * RS + k.ks) * 2;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(a[mt], xrow[mt] + at);
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) ldmatrix_x4_trans(b[np], wrow + np * 32);
}

template <int MT, int NT>
__device__ __forceinline__ void mma_frags(float (&acc)[MT][NT][4], const uint32_t (&a)[MT][4],
                                          const uint32_t (&b)[NT / 2][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      mma_16816(acc[mt][nt], a[mt], b[nt / 2][(nt & 1) * 2], b[nt / 2][(nt & 1) * 2 + 1]);
}

}  // namespace tc
}  // namespace saragan
