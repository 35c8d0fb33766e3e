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
// operations, not by device memory.  Tensor cores in f32 would mean TF32, which the port
// keeps off.
//
// Design.  The TPU kernel keeps a whole zero-padded, flattened volume window in VMEM and
// reads every tap as a lane shift of it.  At 32x128x128 that window needs about 17K
// positions of halo on each side, more than a block's shared memory, so the kernel is
// rethought for Hopper instead of copied:
//   * one block owns one sample, one depth slice of TH x TW output voxels and FT output
//     channels;
//   * it walks the input channels in chunks of CC, staging the halo'd input tile (zero
//     padding applied while loading) and the K x CC x FT weights in shared memory, so
//     every tap of the chunk reuses one load from device memory;
//   * each thread keeps VPT consecutive W outputs for FPT output channels in registers
//     and reuses each input row it reads from shared memory across the KW taps;
//   * the shared row stride is odd, so the four rows a warp reads fall in distinct banks.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int TH = 16;   // output rows (H) per block
constexpr int TW = 32;   // output columns (W) per block
constexpr int FT = 16;   // output channels per block
constexpr int CC = 8;    // input channels staged per step
constexpr int VPT = 4;   // consecutive W outputs per thread
constexpr int FPT = 8;   // output channels per thread
constexpr int VOX_THREADS = TH * TW / VPT;           // 128
constexpr int THREADS = VOX_THREADS * (FT / FPT);    // 256
constexpr size_t MAX_SMEM = 232448;                  // 227 KB usable by one block

__host__ __device__ constexpr int odd_stride(int width) { return width | 1; }

template <int KW>
__global__ void __launch_bounds__(THREADS)
conv3d_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ y, int C, int D, int H, int W, int KD, int KH,
                  int F, int tiles_h, int tiles_w, int x_tile_floats) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* ws = xs + x_tile_floats;

  constexpr int WW = TW + KW - 1;      // staged columns
  constexpr int WS = odd_stride(WW);   // shared row stride
  const int HH = TH + KH - 1;          // staged rows
  const int K = KD * KH * KW;

  int bid = blockIdx.x;
  const int tw = bid % tiles_w;
  bid /= tiles_w;
  const int th = bid % tiles_h;
  bid /= tiles_h;
  const int d0 = bid % D;
  const int n = bid / D;
  const int f0 = blockIdx.y * FT;
  const int h0 = th * TH;
  const int w0 = tw * TW;
  const int pd = KD / 2, ph = KH / 2, pw = KW / 2;

  const int tid = threadIdx.x;
  const int fg = tid / VOX_THREADS;             // which FPT-wide slice of the FT channels
  const int vt = tid % VOX_THREADS;
  const int ly = vt / (TW / VPT);               // output row inside the tile
  const int lx = (vt % (TW / VPT)) * VPT;       // first output column inside the tile

  float acc[VPT][FPT];
#pragma unroll
  for (int v = 0; v < VPT; ++v)
#pragma unroll
    for (int f = 0; f < FPT; ++f) acc[v][f] = 0.f;

  const size_t plane = static_cast<size_t>(H) * W;
  const float* xn = x + static_cast<size_t>(n) * C * D * plane;
  const int x_count = CC * KD * HH * WW;
  const int w_count = K * CC * FT;

  for (int c0 = 0; c0 < C; c0 += CC) {
    // input halo, zero outside the volume and past the last channel
    for (int i = tid; i < x_count; i += THREADS) {
      const int xx = i % WW;
      int t = i / WW;
      const int yy = t % HH;
      t /= HH;
      const int zz = t % KD;
      const int cc = t / KD;
      const int c = c0 + cc;
      const int gd = d0 + zz - pd, gh = h0 + yy - ph, gw = w0 + xx - pw;
      float v = 0.f;
      if (c < C && gd >= 0 && gd < D && gh >= 0 && gh < H && gw >= 0 && gw < W)
        v = __ldg(xn + (static_cast<size_t>(c) * D + gd) * plane +
                  static_cast<size_t>(gh) * W + gw);
      xs[((cc * KD + zz) * HH + yy) * WS + xx] = v;
    }
    // weights as ws[tap][cc][FT], zero past the last channel / filter
    for (int i = tid; i < w_count; i += THREADS) {
      const int ff = i % FT;
      const int t = i / FT;
      const int cc = t % CC;
      const int k = t / CC;
      const int c = c0 + cc, f = f0 + ff;
      ws[i] = (c < C && f < F) ? __ldg(w + (static_cast<size_t>(k) * C + c) * F + f) : 0.f;
    }
    __syncthreads();

    for (int cc = 0; cc < CC; ++cc) {
      for (int kz = 0; kz < KD; ++kz) {
        for (int ky = 0; ky < KH; ++ky) {
          const float* row = xs + ((cc * KD + kz) * HH + ly + ky) * WS + lx;
          float xr[VPT + KW - 1];
#pragma unroll
          for (int j = 0; j < VPT + KW - 1; ++j) xr[j] = row[j];
#pragma unroll
          for (int kx = 0; kx < KW; ++kx) {
            const float4* wp = reinterpret_cast<const float4*>(
                ws + (((kz * KH + ky) * KW + kx) * CC + cc) * FT + fg * FPT);
            const float4 a = wp[0];
            const float4 b = wp[1];
            const float wv[FPT] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
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

  const int gh = h0 + ly;
  if (gh >= H) return;
#pragma unroll
  for (int f = 0; f < FPT; ++f) {
    const int gf = f0 + fg * FPT + f;
    if (gf >= F) continue;
    float* yrow = y + ((static_cast<size_t>(n) * F + gf) * D + d0) * plane +
                  static_cast<size_t>(gh) * W;
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const int gw = w0 + lx + v;
      if (gw < W) yrow[gw] = acc[v][f];
    }
  }
}

template <int KW>
int launch(const float* x, const float* w, float* y, int n, int c, int d, int h, int wd,
           int kd, int kh, int f, cudaStream_t stream) {
  const int tiles_h = (h + TH - 1) / TH;
  const int tiles_w = (wd + TW - 1) / TW;
  const long long blocks = static_cast<long long>(n) * d * tiles_h * tiles_w;
  if (blocks <= 0 || blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  // the weight tile starts 16-byte aligned: it is read as float4
  const int x_tile = ((CC * kd * (TH + kh - 1) * odd_stride(TW + KW - 1)) + 3) & ~3;
  const size_t smem = (static_cast<size_t>(x_tile) + static_cast<size_t>(kd) * kh * KW * CC * FT) *
                      sizeof(float);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv3d_fwd_kernel<KW>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>((f + FT - 1) / FT));
  conv3d_fwd_kernel<KW><<<grid, THREADS, smem, stream>>>(x, w, y, c, d, h, wd, kd, kh, f,
                                                         tiles_h, tiles_w, x_tile);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (n, c, d, h, wd), w: (kd, kh, kw, c, f), y: (n, f, d, h, wd), f32, contiguous on the
// device of `stream`.  Returns a cudaError_t (0 when the launch was accepted); the caller
// checks it.
extern "C" int saragan_conv3d_fwd(const void* x, const void* w, void* y, int n, int c, int d,
                                  int h, int wd, int kd, int kh, int kw, int f, void* stream) {
  if (kd % 2 == 0 || kh % 2 == 0 || kw % 2 == 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* xt = static_cast<const float*>(x);
  const float* wt = static_cast<const float*>(w);
  float* yt = static_cast<float*>(y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kw) {
    case 1: return launch<1>(xt, wt, yt, n, c, d, h, wd, kd, kh, f, s);
    case 3: return launch<3>(xt, wt, yt, n, c, d, h, wd, kd, kh, f, s);
    case 5: return launch<5>(xt, wt, yt, n, c, d, h, wd, kd, kh, f, s);
    case 7: return launch<7>(xt, wt, yt, n, c, d, h, wd, kd, kh, f, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* saragan_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
