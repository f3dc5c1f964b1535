// Banded line resample: the 1-D linear resampler behind both passes of the
// banded two-pass warp (vkit_tpu_torch/ops/warp_banded.py), i.e. every
// camera, MLS and perspective-skew sample of the geometric stage.
//
// Replaces vkit_tpu/ops/pallas_kernels.py _banded_resample_kernel /
// banded_line_resample (K3).  The TPU kernel computes, per line l and
// output position j (p = j mod 128, b = base[n, l / 8, j / 128]):
//   out[n, l, c, j] = sum_{t < taps} max(0, 1 - |u - t|) * src(b + p + t),
//   u = pos[n, l, j] - (float(b) + float(p)),
// where src(k) reads a 2048-lane window that holds the row at lane 512
// and the border value elsewhere, with the lane index taken mod 2048.
//
// What bounds it on the H100: bytes moved.  The TPU kernel streamed all
// `taps` (32..128) shifted copies of the window through the vector unit;
// only the two taps floor(u) and floor(u) + 1 can carry weight, so this
// kernel reads just those two values per (output, channel): one 4-byte
// pos read per (n, l, j), two source reads and one 4-byte write per
// channel.  That is a few bytes per output and a handful of flops, far
// below the card's compute roof, so device-memory bandwidth is the limit.
//
// Design: one thread per (n, l, j), threads of a warp on consecutive j
// (coalesced pos loads and output stores; the source reads of a warp fall
// on one or two contiguous lines because positions move with j).  The
// thread loops over the channels, reusing its weights and window indices.
// Each of the two taps is masked to [0, taps) and to the mod-2048 window
// rule, so samples where the planner's band guarantee fails give the same
// answer as the TPU kernel.  The zero-weight taps of the reference add
// exact zeros for finite inputs, so two taps reproduce its sum.  The blend
// uses __fmul_rn / __fadd_rn so nvcc cannot contract it into an FMA and
// the result rounds like the plain PyTorch version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWindow = 2048;
constexpr int kRowOffset = 512;
constexpr int kLanes = 128;
constexpr int kThreads = 256;

__device__ __forceinline__ float window_tap(
    const float* __restrict__ row, int width, int k, float border) {
  int lane = (k + kRowOffset) & (kWindow - 1);
  int col = lane - kRowOffset;
  return (col >= 0 && col < width) ? row[col] : border;
}

__global__ void banded_resample_kernel(
    const float* __restrict__ x, const int32_t* __restrict__ base,
    const float* __restrict__ pos, float* __restrict__ out, int64_t total,
    int lines, int channels, int width, int jp, int groups, int taps,
    float border) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= total) return;
  int j = (int)(i % jp);
  int64_t nl = i / jp;                 // n * lines + l
  int l = (int)(nl % lines);
  int64_t n = nl / lines;
  int blocks = jp / kLanes;
  int p = j % kLanes;
  int b = base[(n * groups + l / 8) * blocks + j / kLanes];

  float u = pos[i] - ((float)b + (float)p);
  float t0f = floorf(u);
  int t0 = (int)t0f;
  int t1 = t0 + 1;
  float w0 = (t0 >= 0 && t0 < taps) ? fmaxf(1.0f - fabsf(u - t0f), 0.0f) : 0.0f;
  float w1 = (t1 >= 0 && t1 < taps)
                 ? fmaxf(1.0f - fabsf(u - (t0f + 1.0f)), 0.0f) : 0.0f;
  int k0 = b + p + t0;

  const float* row = x + nl * (int64_t)channels * width;
  float* dst = out + nl * (int64_t)channels * jp + j;
  for (int c = 0; c < channels; ++c) {
    const float* src = row + (int64_t)c * width;
    float v0 = w0 != 0.0f ? window_tap(src, width, k0, border) : 0.0f;
    float v1 = w1 != 0.0f ? window_tap(src, width, k0 + 1, border) : 0.0f;
    dst[(int64_t)c * jp] = __fadd_rn(__fmul_rn(w0, v0), __fmul_rn(w1, v1));
  }
}

}  // namespace

extern "C" int vk_banded_line_resample(
    const float* x, const int32_t* base, const float* pos, float* out,
    int n, int lines, int channels, int width, int jp, int groups, int taps,
    float border, void* stream) {
  int64_t total = (int64_t)n * lines * jp;
  unsigned int blocks = (unsigned int)((total + kThreads - 1) / kThreads);
  banded_resample_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, base, pos, out, total, lines, channels, width, jp, groups, taps,
      border);
  return (int)cudaGetLastError();
}
