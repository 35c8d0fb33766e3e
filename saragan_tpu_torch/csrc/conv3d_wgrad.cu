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
// memory, on CUDA cores.
//
// Design.  The TPU kernel walks its sequential grid and adds into one VMEM-resident
// output.  Blocks on Hopper run in parallel, so the reduction is split instead, and split
// in a fixed way (split-K), with no float atomics, so dw is bit-identical from run to run:
//   * pass 1: block (s, c-tile, f-tile) reduces the s-th chunk of position tiles (one
//     sample, one depth slice, TH x TW positions each) into its own slot of an f32
//     workspace.  Per tile it stages the halo'd x tile of its CT input channels (zero
//     padding applied while loading) and the dy tile of its FT output channels in shared
//     memory, so every tap reuses one load from device memory.  Thread (f-group, c, kz, ky)
//     keeps the KW x FPT sums of one input channel, one (kz, ky) tap row and FPT output
//     channels in registers, reuses each x row it reads across the KW taps, and reads dy
//     as float4 words that the threads of a warp share (one broadcast);
//   * pass 2: one thread per output adds the chunks' partial sums in chunk order.
// Tensor cores in f32 would mean TF32, which the port keeps off.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstddef>

namespace {

constexpr int TH = 8;                  // positions (H) per tile
constexpr int TW = 32;                 // positions (W) per tile
constexpr int FT = 16;                 // output channels per block
constexpr int FPT = 8;                 // output channels per thread
constexpr int FG = FT / FPT;           // f-groups per block
constexpr int VPT = 4;                 // consecutive W positions per inner step
constexpr int MAX_CT = 64;             // input channels per block
constexpr int MAX_THREADS = 512;
constexpr int TARGET_BLOCKS = 4 * 132;         // four per SM of an H100
constexpr long long WORKSPACE_CAP = 8LL << 20;  // f32 partial sums (32 MB)
constexpr size_t MAX_SMEM = 232448;             // 227 KB usable by one block
constexpr int REDUCE_THREADS = 256;

__host__ __device__ constexpr int odd_stride(int width) { return width | 1; }

struct Plan {
  int ct, c_tiles, f_tiles, tiles_h, tiles_w, threads, x_tile;
  long long tiles, per_split, splits, kcf;
  size_t smem;
};

// The split is a function of the shapes alone, so a given problem always sums in the
// same order.
bool make_plan(int n, int c, int d, int h, int wd, int kd, int kh, int kw, int f, Plan* p) {
  if (n <= 0 || c <= 0 || d <= 0 || h <= 0 || wd <= 0 || f <= 0) return false;
  if (kd % 2 == 0 || kh % 2 == 0 || kw % 2 == 0 || kd <= 0 || kh <= 0) return false;
  const int taps_dh = kd * kh;
  int ct = 1;
  while (ct < c && ct < MAX_CT && 2 * ct * taps_dh * FG <= MAX_THREADS) ct *= 2;
  p->ct = ct;
  p->threads = ct * taps_dh * FG;
  if (p->threads > 1024) return false;
  p->c_tiles = (c + ct - 1) / ct;
  p->f_tiles = (f + FT - 1) / FT;
  p->tiles_h = (h + TH - 1) / TH;
  p->tiles_w = (wd + TW - 1) / TW;
  p->tiles = static_cast<long long>(n) * d * p->tiles_h * p->tiles_w;
  p->kcf = static_cast<long long>(taps_dh) * kw * c * f;
  const long long per_grid = static_cast<long long>(p->c_tiles) * p->f_tiles;
  long long s = std::max(1LL, (TARGET_BLOCKS + per_grid - 1) / per_grid);
  s = std::min(s, std::max(1LL, WORKSPACE_CAP / p->kcf));
  s = std::min(s, p->tiles);
  p->per_split = (p->tiles + s - 1) / s;
  p->splits = (p->tiles + p->per_split - 1) / p->per_split;
  if (p->splits > INT_MAX || p->c_tiles > 65535 || p->f_tiles > 65535) return false;
  // the dy tile starts 16-byte aligned: it is read as float4
  p->x_tile = (ct * kd * (TH + kh - 1) * odd_stride(TW + kw - 1) + 3) & ~3;
  p->smem = (static_cast<size_t>(p->x_tile) + static_cast<size_t>(FT) * TH * TW) * sizeof(float);
  return p->smem <= MAX_SMEM;
}

template <int KW>
__global__ void __launch_bounds__(MAX_THREADS)
wgrad_partial_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                     float* __restrict__ ws,
                     int C, int D, int H, int W, int KD, int KH, int F, int CT, int tiles_h,
                     int tiles_w, long long tiles, long long per_split, int x_tile) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* ds = xs + x_tile;

  constexpr int WW = TW + KW - 1;      // staged columns
  constexpr int WS = odd_stride(WW);   // shared row stride
  const int HH = TH + KH - 1;          // staged rows
  const int taps_dh = KD * KH;
  const int pd = KD / 2, ph = KH / 2, pw = KW / 2;

  const long long split = blockIdx.x;
  const int c0 = blockIdx.y * CT;
  const int f0 = blockIdx.z * FT;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  // f-group slowest: the threads of a warp mostly share one f-group, so their dy reads
  // are one broadcast
  const int fg = tid / (CT * taps_dh);
  const int r = tid % (CT * taps_dh);
  const int cl = r / taps_dh;
  const int kz = (r % taps_dh) / KH;
  const int ky = (r % taps_dh) % KH;

  float acc[KW][FPT];
#pragma unroll
  for (int k = 0; k < KW; ++k)
#pragma unroll
    for (int f = 0; f < FPT; ++f) acc[k][f] = 0.f;

  const size_t plane = static_cast<size_t>(H) * W;
  const int x_count = CT * KD * HH * WW;
  const int d_count = FT * TH * TW;
  const long long t_end = min(tiles, (split + 1) * per_split);

  for (long long t = split * per_split; t < t_end; ++t) {
    long long b = t;
    const int tw = static_cast<int>(b % tiles_w);
    b /= tiles_w;
    const int th = static_cast<int>(b % tiles_h);
    b /= tiles_h;
    const int d0 = static_cast<int>(b % D);
    const int n = static_cast<int>(b / D);
    const int h0 = th * TH, w0 = tw * TW;

    __syncthreads();  // every thread is done with the previous tile
    const float* xn = x + static_cast<size_t>(n) * C * D * plane;
    for (int i = tid; i < x_count; i += nthreads) {
      const int xx = i % WW;
      int q = i / WW;
      const int yy = q % HH;
      q /= HH;
      const int zz = q % KD;
      const int cc = q / KD;
      const int c = c0 + cc;
      const int gd = d0 + zz - pd, gh = h0 + yy - ph, gw = w0 + xx - pw;
      float v = 0.f;
      if (c < C && gd >= 0 && gd < D && gh >= 0 && gh < H && gw >= 0 && gw < W)
        v = __ldg(xn + (static_cast<size_t>(c) * D + gd) * plane +
                  static_cast<size_t>(gh) * W + gw);
      xs[((cc * KD + zz) * HH + yy) * WS + xx] = v;
    }
    // dy as ds[ff][yy][xx], zero past the volume and the last output channel
    const float* dyn = dy + static_cast<size_t>(n) * F * D * plane;
    for (int i = tid; i < d_count; i += nthreads) {
      const int xx = i % TW;
      const int yy = (i / TW) % TH;
      const int ff = i / (TW * TH);
      const int f = f0 + ff, gh = h0 + yy, gw = w0 + xx;
      float v = 0.f;
      if (f < F && gh < H && gw < W)
        v = __ldg(dyn + (static_cast<size_t>(f) * D + d0) * plane +
                  static_cast<size_t>(gh) * W + gw);
      ds[i] = v;
    }
    __syncthreads();

    for (int ly = 0; ly < TH; ++ly) {
      const float* xrow = xs + ((cl * KD + kz) * HH + ly + ky) * WS;
      const float* drow = ds + fg * FPT * TH * TW + ly * TW;
      for (int lx = 0; lx < TW; lx += VPT) {
        float xr[VPT + KW - 1];
#pragma unroll
        for (int j = 0; j < VPT + KW - 1; ++j) xr[j] = xrow[lx + j];
#pragma unroll
        for (int f = 0; f < FPT; ++f) {
          const float4 d4 = *reinterpret_cast<const float4*>(drow + f * TH * TW + lx);
          const float dv[VPT] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
          for (int kx = 0; kx < KW; ++kx)
#pragma unroll
            for (int v = 0; v < VPT; ++v) acc[kx][f] = fmaf(xr[v + kx], dv[v], acc[kx][f]);
        }
      }
    }
  }

  // every (split, tap, c, f) slot is written by exactly one thread, empty chunks too
  const int c = c0 + cl;
  if (c >= C) return;
  const long long taps = static_cast<long long>(taps_dh) * KW;
#pragma unroll
  for (int kx = 0; kx < KW; ++kx) {
    const long long tap = (kz * KH + ky) * KW + kx;
    float* out = ws + ((split * taps + tap) * C + c) * F;
#pragma unroll
    for (int f = 0; f < FPT; ++f) {
      const int gf = f0 + fg * FPT + f;
      if (gf < F) out[gf] = acc[kx][f];
    }
  }
}

__global__ void wgrad_reduce_kernel(const float* __restrict__ ws, float* __restrict__ dw,
                                    long long kcf, long long splits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= kcf) return;
  float s = 0.f;
  for (long long k = 0; k < splits; ++k) s += ws[k * kcf + i];  // fixed order
  dw[i] = s;
}

template <int KW>
int launch(const Plan& p, const float* x, const float* dy, float* dw, float* ws, int c, int d, int h,
           int wd, int kd, int kh, int f, cudaStream_t stream) {
  if (p.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(wgrad_partial_kernel<KW>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(p.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(p.splits), static_cast<unsigned>(p.c_tiles),
                  static_cast<unsigned>(p.f_tiles));
  wgrad_partial_kernel<KW><<<grid, p.threads, p.smem, stream>>>(
      x, dy, ws, c, d, h, wd, kd, kh, f, p.ct, p.tiles_h, p.tiles_w, p.tiles, p.per_split,
      p.x_tile);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (p.kcf + REDUCE_THREADS - 1) / REDUCE_THREADS;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  wgrad_reduce_kernel<<<static_cast<unsigned>(blocks), REDUCE_THREADS, 0, stream>>>(
      ws, dw, p.kcf, p.splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 elements of workspace the wgrad of these shapes needs (splits * kd*kh*kw*c*f), or
// -1 when the kernel does not take them.
extern "C" long long saragan_conv3d_wgrad_workspace_floats(int n, int c, int d, int h, int wd,
                                                           int kd, int kh, int kw, int f) {
  Plan p;
  if (!make_plan(n, c, d, h, wd, kd, kh, kw, f, &p)) return -1;
  return p.splits * p.kcf;
}

// x: (n, c, d, h, wd), dy: (n, f, d, h, wd), dw: (kd, kh, kw, c, f), f32, contiguous on
// the device of `stream`; ws: f32 scratch of saragan_conv3d_wgrad_workspace_floats(...)
// elements.  Returns a cudaError_t (0 when both launches were accepted); the caller checks
// it.
extern "C" int saragan_conv3d_wgrad(const void* x, const void* dy, void* dw, float* ws,
                                    long long ws_floats, int n, int c, int d, int h, int wd,
                                    int kd, int kh, int kw, int f, void* stream) {
  Plan p;
  if (!make_plan(n, c, d, h, wd, kd, kh, kw, f, &p)) return static_cast<int>(cudaErrorInvalidValue);
  if (ws_floats < p.splits * p.kcf) return static_cast<int>(cudaErrorInvalidValue);
  const float* xt = static_cast<const float*>(x);
  const float* dyt = static_cast<const float*>(dy);
  float* dwt = static_cast<float*>(dw);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kw) {
    case 1: return launch<1>(p, xt, dyt, dwt, ws, c, d, h, wd, kd, kh, f, s);
    case 3: return launch<3>(p, xt, dyt, dwt, ws, c, d, h, wd, kd, kh, f, s);
    case 5: return launch<5>(p, xt, dyt, dwt, ws, c, d, h, wd, kd, kh, f, s);
    case 7: return launch<7>(p, xt, dyt, dwt, ws, c, d, h, wd, kd, kh, f, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* saragan_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
