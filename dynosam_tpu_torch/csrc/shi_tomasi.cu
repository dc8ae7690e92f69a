// Shi-Tomasi (minimum-eigenvalue) corner response fused with the per-cell
// argmax, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dynosam_tpu/ops/pallas/shi_tomasi.py
// (`_kernel` K1 and `_kernel_batched` K1b, reached through
// `shi_tomasi_response_pallas`) together with the per-cell reduction that
// follows it, dynosam_tpu/frontend/tracker.py::_cell_reduce. Per
// `cell` x `cell` cell of the frame (full cells only: H / cell rows and
// W / cell columns of cells) it emits the largest response and the (u, v)
// pixel of its first occurrence in the cell's row-major order, NaN counting
// as the largest value (torch.amax / torch.argmax). The response is the XLA
// reference's, tracker.py::shi_tomasi_response, over the WHOLE frame:
//
//   gx = 0.5 (I[r, c+1] - I[r, c-1]),  zero at columns 0 and W-1
//   gy = 0.5 (I[r+1, c] - I[r-1, c]),  zero at rows 0 and H-1
//   sxx, syy, sxy = 3x3 box sums of gx*gx, gy*gy, gx*gy, indices wrapping
//                   around the frame (jnp.roll semantics), vertical sum
//                   first (centre, -1, +1), then horizontal in the same order
//   response = 0.5 (sxx + syy) - sqrt((0.5 (sxx - syy))^2 + sxy^2)
//
// (The Pallas kernel zero-pads rows and so differs within 2 px of the frame
// edge; this kernel keeps the XLA semantics.) Every operation is an
// explicitly rounded __fadd_rn / __fsub_rn / __fmul_rn / __fsqrt_rn, so
// nothing is contracted into an FMA and the responses equal torch's own
// elementwise kernels bit for bit; the argmax then agrees exactly.
//
// Bound: at 384x1280 f32 the function must read the frame once (1.97 MB)
// and write 3 floats per cell (1920 cells at cell 16: 23 KB): 1.99 MB, i.e.
// 0.59 us at 3.35 TB/s; at B=8, 15.9 MB, 4.7 us. Its ~29 operations per
// pixel (14 MFLOP per frame, 0.2 us at 67 TFLOP/s f32) are well below that,
// so bytes bound it. At B=1 a single launch (about 2-3 us) sets the floor.
//
// Design, against that bound:
// - One block of 128 threads per tile of cell rows x (1024 / cell) columns
//   (16 x 64 = 4 cells at cell 16, 8 x 128 = 16 cells at cell 8),
//   blockIdx.z over the batch; no halo is shared between images. A frame
//   of 384x1280 is 480 tiles, enough to spread evenly over 132 SMs.
// - The (TH+4) x (TW+4) halo tile is read from device memory once, into
//   shared memory: the interior columns with 16-byte cp.async, coalesced,
//   when the rows are 16-byte aligned; the wrapped halo rows and columns
//   are computed once per tile element, not per pixel and neighbour.
// - gx, gy and their products ixx, iyy, ixy are computed once per pixel of
//   the (TH+2) x (TW+2) region and kept in shared memory (20 KB with the
//   image tile at cell 16, 22 KB at cell 8). Loops index the tile by
//   compile-time widths: no integer division at run time.
// - The box sums: each thread walks 8 rows of one column, keeping the
//   products of three rows x three columns in registers (the walk is
//   unrolled, so the rows rotate by renaming).
// - The per-cell reduction keeps a (value, in-cell index) pair per thread,
//   reduces across the cell's lanes with warp shuffles and across the
//   cell's row strips in shared memory: one write per cell. The response
//   map never goes to device memory unless asked for: an optional pointer
//   writes it (then the tiles cover the whole frame), which keeps one
//   kernel for the map entry and the fused one.
//
// Measured on the H100 the kernel stays an order of magnitude above the
// bound (PERF.md). Counting the code, each pixel takes some 90 instructions
// (the explicitly rounded arithmetic, shared-memory loads, the argmax), and
// those, not device memory, would set its time at these sizes, with the
// launch at B=1; no profiler on that machine can confirm it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kTilePixels = 1024;   // TH * TW
constexpr int kRowsPerThread = 8;   // kTilePixels / kThreads

// x mod n in [0, n); the common case (x already in range) takes no division
__device__ __forceinline__ int wrapi(int x, int n) {
  if (static_cast<unsigned>(x) < static_cast<unsigned>(n)) return x;
  x %= n;
  return x < 0 ? x + n : x;
}

// (va, ia) beats (vb, ib): NaN is the largest value; on equal values (or
// two NaNs) the smaller in-cell index wins, as torch.argmax's first index.
__device__ __forceinline__ bool beats(float va, int ia, float vb, int ib) {
  const bool na = va != va, nb = vb != vb;
  if (na != nb) return na;
  if (!na && va != vb) return va > vb;
  return ia < ib;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// gx or gy from the neighbours a (+1) and b (-1): zero on a border line.
// `at` is the frame line of the pixel before wrapping, in [-1, n]: -1 and n
// wrap to n - 1 and 0, both border lines.
__device__ __forceinline__ float grad(float a, float b, int at, int n) {
  return (at <= 0 || at >= n - 1) ? 0.f : __fmul_rn(0.5f, __fsub_rn(a, b));
}

template <int CELL>
__global__ void __launch_bounds__(kThreads)
shi_tomasi_cell_kernel(const float* __restrict__ img, float* __restrict__ map,
                       float* __restrict__ best, float* __restrict__ bu,
                       float* __restrict__ bv, int H, int W, int Hc, int Wc) {
  constexpr int TH = CELL;
  constexpr int TW = kTilePixels / CELL;
  constexpr int SW = TW + 8;        // image row stride; interior at column 4
  constexpr int PW = TW + 2;        // product row stride
  constexpr int NS = TH / kRowsPerThread;   // row strips per tile
  constexpr int CPT = TW / CELL;            // cells per tile row
  static_assert(NS * TW == kThreads && TW % 32 == 0 && 32 % CELL == 0, "tile shape");

  __shared__ __align__(16) float s_img[(TH + 4) * SW];
  __shared__ float s_xx[(TH + 2) * PW];
  __shared__ float s_yy[(TH + 2) * PW];
  __shared__ float s_xy[(TH + 2) * PW];
  __shared__ float s_rv[NS * CPT];
  __shared__ int s_ri[NS * CPT];

  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * TH;
  const int c0 = blockIdx.x * TW;
  const int the = min(TH, Hc - r0);   // rows and columns of this tile
  const int twe = min(TW, Wc - c0);
  const size_t plane = static_cast<size_t>(H) * W;
  const float* im = img + blockIdx.z * plane;

  // ---- 1. halo tile into shared memory, once ---------------------------
  // tile row i in [-2, the + 2) is smem row i + 2, tile column j in
  // [-2, twe + 2) smem column j + 4
  const int lrows = the + 4;
  if ((W % 4 == 0) && (twe % 4 == 0) && (reinterpret_cast<uintptr_t>(im) % 16 == 0)) {
    constexpr int Q = TW / 4;
    for (int k = tid; k < lrows * Q; k += kThreads) {
      const int i = k / Q, j = (k % Q) * 4;
      if (j < twe)
        cp_async16(&s_img[i * SW + 4 + j],
                   im + static_cast<size_t>(wrapi(r0 + i - 2, H)) * W + c0 + j);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    for (int k = tid; k < lrows * 4; k += kThreads) {
      const int i = k / 4, h = k % 4;
      const int j = h < 2 ? h - 2 : twe + h - 2;   // -2, -1, twe, twe + 1
      s_img[i * SW + 4 + j] =
          __ldg(im + static_cast<size_t>(wrapi(r0 + i - 2, H)) * W + wrapi(c0 + j, W));
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
  } else {
    constexpr int LC = TW + 4;
    for (int k = tid; k < lrows * LC; k += kThreads) {
      const int i = k / LC, j = k % LC - 2;
      if (j < twe + 2)
        s_img[i * SW + 4 + j] =
            __ldg(im + static_cast<size_t>(wrapi(r0 + i - 2, H)) * W + wrapi(c0 + j, W));
    }
  }
  __syncthreads();

  // ---- 2. gradients and their products, once per pixel ------------------
  // product row p, column q is tile pixel (p - 1, q - 1); the interior
  // columns first, then the two halo columns
  auto products = [&](int p, int q) {
    const float* c = &s_img[(p + 1) * SW + 3 + q];
    const float gx = grad(c[1], c[-1], c0 + q - 1, W);
    const float gy = grad(c[SW], c[-SW], r0 + p - 1, H);
    s_xx[p * PW + q] = __fmul_rn(gx, gx);
    s_yy[p * PW + q] = __fmul_rn(gy, gy);
    s_xy[p * PW + q] = __fmul_rn(gx, gy);
  };
  for (int k = tid; k < (the + 2) * TW; k += kThreads) {
    const int p = k / TW, q = k % TW + 1;
    if (q <= twe) products(p, q);
  }
  for (int k = tid; k < (the + 2) * 2; k += kThreads) products(k / 2, k % 2 ? twe + 1 : 0);
  __syncthreads();

  // ---- 3. box sums and response down 8 rows of one column ---------------
  const int j = tid % TW;
  const int strip = tid / TW;
  const int i0 = strip * kRowsPerThread;
  float vbest = -__int_as_float(0x7f800000);   // -inf
  int ibest = 0x7fffffff;
  if (j < twe && i0 < the) {
    // a[d][t][e]: product t at tile row (i - 1 + d), column (j - 1 + e)
    const float* src[3] = {s_xx, s_yy, s_xy};
    float a[3][3][3];
#pragma unroll
    for (int d = 0; d < 2; ++d)
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int e = 0; e < 3; ++e) a[d][t][e] = src[t][(i0 + d) * PW + j + e];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int i = i0 + r;
      if (i < the) {
#pragma unroll
        for (int t = 0; t < 3; ++t)
#pragma unroll
          for (int e = 0; e < 3; ++e) a[2][t][e] = src[t][(i + 2) * PW + j + e];
        float s[3];
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          float v[3];
#pragma unroll
          for (int e = 0; e < 3; ++e)
            v[e] = __fadd_rn(__fadd_rn(a[1][t][e], a[0][t][e]), a[2][t][e]);
          s[t] = __fadd_rn(__fadd_rn(v[1], v[0]), v[2]);
        }
        const float tr = __fmul_rn(0.5f, __fadd_rn(s[0], s[1]));
        const float h = __fmul_rn(0.5f, __fsub_rn(s[0], s[1]));
        // h*h + sxy*sxy is >= 0 or NaN, so the reference's clamp at 0 is a no-op
        const float det = __fsqrt_rn(__fadd_rn(__fmul_rn(h, h), __fmul_rn(s[2], s[2])));
        const float resp = __fsub_rn(tr, det);
        if (map) map[blockIdx.z * plane + static_cast<size_t>(r0 + i) * W + c0 + j] = resp;
        const int idx = i * CELL + (j % CELL);
        if (beats(resp, idx, vbest, ibest)) {
          vbest = resp;
          ibest = idx;
        }
#pragma unroll
        for (int t = 0; t < 3; ++t)
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            a[0][t][e] = a[1][t][e];
            a[1][t][e] = a[2][t][e];
          }
      }
    }
  }
  if (best == nullptr) return;   // map only: no thread reaches a barrier below

  // ---- 4. per-cell reduction: lanes of a cell, then its row strips ------
#pragma unroll
  for (int off = CELL / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, vbest, off);
    const int oi = __shfl_xor_sync(0xffffffffu, ibest, off);
    if (beats(ov, oi, vbest, ibest)) {
      vbest = ov;
      ibest = oi;
    }
  }
  if (j % CELL == 0) {
    s_rv[strip * CPT + j / CELL] = vbest;
    s_ri[strip * CPT + j / CELL] = ibest;
  }
  __syncthreads();
  const int gh = H / CELL, gw = W / CELL;
  const int cy = blockIdx.y, cx = c0 / CELL + tid;
  if (tid < CPT && cy < gh && cx < gw) {
    float v = s_rv[tid];
    int ix = s_ri[tid];
#pragma unroll
    for (int s = 1; s < NS; ++s) {
      if (beats(s_rv[s * CPT + tid], s_ri[s * CPT + tid], v, ix)) {
        v = s_rv[s * CPT + tid];
        ix = s_ri[s * CPT + tid];
      }
    }
    const size_t o = blockIdx.z * static_cast<size_t>(gh) * gw + static_cast<size_t>(cy) * gw + cx;
    best[o] = v;
    bu[o] = static_cast<float>(cx * CELL + ix % CELL);
    bv[o] = static_cast<float>(cy * CELL + ix / CELL);
  }
}

template <int CELL>
int launch(const float* img, float* map, float* best, float* u, float* v, int B, int H,
           int W, cudaStream_t stream) {
  constexpr int TH = CELL, TW = kTilePixels / CELL;
  // with the map the tiles cover the frame; without it only the full cells
  const int Hc = map ? H : (H / CELL) * CELL;
  const int Wc = map ? W : (W / CELL) * CELL;
  const dim3 grid((Wc + TW - 1) / TW, (Hc + TH - 1) / TH, B);
  shi_tomasi_cell_kernel<CELL><<<grid, kThreads, 0, stream>>>(img, map, best, u, v, H, W, Hc, Wc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img: contiguous (B, H, W) float32 device buffer. `map` (B, H, W), or null;
// `best`, `u`, `v` (B, (H / cell) * (W / cell)) each, or all null. At least
// one of the two outputs must be given; `cell` is 8 or 16 (with `best`
// null it only picks the tile shape). Launches on `stream` and returns the
// launch's cudaError_t (0 on success); it does not synchronise and
// allocates nothing.
extern "C" int dyno_shi_tomasi_f32(const float* img, float* map, float* best, float* u,
                                   float* v, int B, int H, int W, int cell, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (map == nullptr && (best == nullptr || H < cell || W < cell))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((best == nullptr) != (u == nullptr) || (best == nullptr) != (v == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (cell == 16) return launch<16>(img, map, best, u, v, B, H, W, s);
  if (cell == 8) return launch<8>(img, map, best, u, v, B, H, W, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
