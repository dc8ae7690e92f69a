// Shi-Tomasi (minimum-eigenvalue) corner response for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dynosam_tpu/ops/pallas/shi_tomasi.py
// (`_kernel` and `_kernel_batched`, reached through
// `shi_tomasi_response_pallas`). It computes, per pixel, what the XLA
// reference dynosam_tpu/frontend/tracker.py::shi_tomasi_response computes
// over the WHOLE frame:
//
//   gx = 0.5 (I[r, c+1] - I[r, c-1]),  zero at columns 0 and W-1
//   gy = 0.5 (I[r+1, c] - I[r-1, c]),  zero at rows 0 and H-1
//   sxx, syy, sxy = 3x3 box sums of gx*gx, gy*gy, gx*gy, indices wrapping
//                   around the frame (jnp.roll semantics)
//   response = 0.5 (sxx + syy) - sqrt((0.5 (sxx - syy))^2 + sxy^2)
//
// The Pallas kernel zero-pads rows and so differs within 2 px of the frame
// edge; this kernel keeps the XLA semantics so whole-frame parity holds, and
// it has no H % 64 restriction (that was a TPU tiling limit).
//
// Design: one thread per output pixel, 32x8 blocks, blockIdx.z over the
// batch (no halo is shared between images). Each thread loads its 5x5
// wrap-indexed neighbourhood through the read-only cache (__ldg) into
// registers and does all the arithmetic in f32.
//
// Bound: it reads 4 bytes and writes 4 bytes per pixel (the 25 neighbour
// reads hit L1/L2), about 3.9 MB per 384x1280 frame, i.e. ~1.2 us of HBM
// time at 3.35 TB/s. A single frame is therefore memory and launch bound;
// shared-memory tiles and fusing the per-cell argmax into this pass are left
// for later.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

__global__ void shi_tomasi_kernel(const float* __restrict__ img,
                                  float* __restrict__ out, int H, int W) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (c >= W || r >= H) return;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* im = img + blockIdx.z * plane;

  int cols[5];
  int rows[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    cols[k] = wrap(c + k - 2, W);
    rows[k] = wrap(r + k - 2, H);
  }
  float p[5][5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float* row = im + static_cast<size_t>(rows[i]) * W;
#pragma unroll
    for (int j = 0; j < 5; ++j) p[i][j] = __ldg(row + cols[j]);
  }

  // gradient products at the 3x3 neighbours (i, j in 1..3 of the 5x5 patch)
  float ixx[3][3], iyy[3][3], ixy[3][3];
#pragma unroll
  for (int i = 1; i < 4; ++i) {
#pragma unroll
    for (int j = 1; j < 4; ++j) {
      const int cc = cols[j];
      const int rr = rows[i];
      const float gx =
          (cc == 0 || cc == W - 1) ? 0.f : 0.5f * (p[i][j + 1] - p[i][j - 1]);
      const float gy =
          (rr == 0 || rr == H - 1) ? 0.f : 0.5f * (p[i + 1][j] - p[i - 1][j]);
      ixx[i - 1][j - 1] = gx * gx;
      iyy[i - 1][j - 1] = gy * gy;
      ixy[i - 1][j - 1] = gx * gy;
    }
  }

  // box3 in the reference's order: vertical sum (centre, up, down) per
  // column, then horizontal sum (centre, left, right)
  float vxx[3], vyy[3], vxy[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    vxx[j] = ixx[1][j] + ixx[0][j] + ixx[2][j];
    vyy[j] = iyy[1][j] + iyy[0][j] + iyy[2][j];
    vxy[j] = ixy[1][j] + ixy[0][j] + ixy[2][j];
  }
  const float sxx = vxx[1] + vxx[0] + vxx[2];
  const float syy = vyy[1] + vyy[0] + vyy[2];
  const float sxy = vxy[1] + vxy[0] + vxy[2];

  const float tr = 0.5f * (sxx + syy);
  const float h = 0.5f * (sxx - syy);
  const float det = sqrtf(fmaxf(h * h + sxy * sxy, 0.f));
  out[blockIdx.z * plane + static_cast<size_t>(r) * W + c] = tr - det;
}

}  // namespace

// img, out: contiguous (B, H, W) float32 device buffers. Launches on
// `stream` and returns the launch's cudaError_t (0 on success); it does not
// synchronise and allocates nothing.
extern "C" int dyno_shi_tomasi_response_f32(const float* img, float* out,
                                             int B, int H, int W,
                                             void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(32, 8, 1);
  const dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y, B);
  shi_tomasi_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, out, H, W);
  return static_cast<int>(cudaGetLastError());
}
