// Per-row integer shifts: the data-movement half of the two-shear affine
// warp (vkit_tpu_torch/ops/warp_mxu.py apply_line_resample).
//
// Replaces three TPU kernels of vkit_tpu/ops/pallas_kernels.py:
//   vk_row_shift_window_slab  <- _row_shift_window_slab_kernel /
//                                row_shift_window_slab (K1)
//   vk_row_shift              <- _row_shift_kernel / row_shift (K2)
//   vk_row_shift_window       <- _row_shift_window_kernel /
//                                row_shift_window (K4: K1 with one channel)
//
// What bounds it on the H100: bytes moved.  Each output element is one
// 4-byte read and one 4-byte write with no arithmetic, so the ceiling is
// device-memory bandwidth (3.35 TB/s on an H100 SXM).
//
// Design: one thread per output element, threads of a warp on consecutive
// j, so both the store and the (shifted) load of a warp touch one or two
// contiguous 128-byte lines.  The TPU kernel rolled a 2048-lane VMEM
// window filled with the border value; here the border is made in
// registers: K1 evaluates the same mod-2048 window index arithmetic, so the
// result is bit-identical to the TPU kernel for every start, in bounds or
// not.  No shared memory, no arithmetic on the values: the output equals
// the plain PyTorch version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWindow = 2048;
constexpr int kThreads = 256;

// out[r, c, j] = win_r[c][(starts[r] + j) mod 2048], where win_r holds
// x[r, c, :] at [0, width) and border elsewhere.
__global__ void row_shift_window_slab_kernel(
    const float* __restrict__ x, const int32_t* __restrict__ starts,
    float* __restrict__ out, int64_t total, int channels, int width,
    int out_width, float border) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= total) return;
  int j = (int)(i % out_width);
  int64_t rc = i / out_width;           // row * channels + c
  int64_t row = rc / channels;
  int k = (starts[row] + j) & (kWindow - 1);  // two's complement mod 2048
  out[i] = k < width ? x[rc * width + k] : border;
}

// out[r, j] = x[r, clamp(starts[r] + j, 0, m_padded - 1)].  The caller
// pads the rows (the TPU kernel's contract: 0 <= starts and
// starts + 1024 <= m_padded); the clamp only keeps a start outside that
// contract from reading another row.
__global__ void row_shift_kernel(
    const float* __restrict__ x, const int32_t* __restrict__ starts,
    float* __restrict__ out, int64_t total, int m_padded, int out_width) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= total) return;
  int j = (int)(i % out_width);
  int64_t row = i / out_width;
  int k = starts[row] + j;
  k = k < 0 ? 0 : (k >= m_padded ? m_padded - 1 : k);
  out[i] = x[row * (int64_t)m_padded + k];
}

unsigned int blocks_for(int64_t total) {
  return (unsigned int)((total + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int vk_row_shift_window_slab(
    const float* x, const int32_t* starts, float* out, int64_t rows,
    int channels, int width, int out_width, float border, void* stream) {
  int64_t total = rows * channels * (int64_t)out_width;
  row_shift_window_slab_kernel<<<blocks_for(total), kThreads, 0,
                                 (cudaStream_t)stream>>>(
      x, starts, out, total, channels, width, out_width, border);
  return (int)cudaGetLastError();
}

// K4 is K1 with one channel: the same device code, its own entry point.
extern "C" int vk_row_shift_window(
    const float* x, const int32_t* starts, float* out, int64_t rows,
    int width, int out_width, float border, void* stream) {
  int64_t total = rows * (int64_t)out_width;
  row_shift_window_slab_kernel<<<blocks_for(total), kThreads, 0,
                                 (cudaStream_t)stream>>>(
      x, starts, out, total, 1, width, out_width, border);
  return (int)cudaGetLastError();
}

extern "C" int vk_row_shift(
    const float* x, const int32_t* starts, float* out, int64_t rows,
    int m_padded, int out_width, void* stream) {
  int64_t total = rows * (int64_t)out_width;
  row_shift_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      x, starts, out, total, m_padded, out_width);
  return (int)cudaGetLastError();
}
