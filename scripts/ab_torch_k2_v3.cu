// K2 v3, the mask-combination kernel of csrc/mask_combine.cu as it stood
// before its Hopper redesign (entry A v4 and the fused label entry B), kept
// verbatim below this note so that scripts/ab_torch_k2.py and chip_smoke.py
// can time it beside the current kernel in one process. Not on any path.
//
// YOLO mask combination for Hopper (sm_90a):
//
//   masks[k, p] = sigmoid(sum_c coef[k, c] * proto[p, c])
//
// for K detections, nm mask coefficients and P = Hp * Wp prototype pixels,
// in f32. Replaces the Pallas TPU kernel dynosam_tpu/ops/pallas/mask_combine.py
// (`_kernel`, reached through `mask_combine_pallas`). The TPU kernel padded
// K and nm to multiples of 8 and P to a multiple of 512 for its (8, 128)
// tiles; this kernel takes the shapes as they come and masks the ragged
// pixel edge instead.
//
// Design: one block per tile of TILE_P pixels, K_SPLIT threads per pixel
// (thread (x, y) computes pixel x for k = y, y + K_SPLIT, ...). The block
// stages the whole (K, nm) coefficient table and its (TILE_P, nm) slice of
// the prototype rows (NHWC, so c is contiguous) in shared memory, both with
// coalesced loads; the prototype tile gets one float of padding per row so
// that threads reading their own rows hit distinct banks, while every
// thread of a warp reading coef[k, c] at once is a broadcast. For each k the
// threads of a warp write neighbouring pixels, so the stores coalesce.
// Splitting K over thread rows keeps 16 warps per SM in flight on the
// detector path (one thread per pixel alone left 4, too few to hide the
// shared-memory latency of the dot products). Each thread then holds its
// prototype row in registers and reads the coefficients as broadcast
// float4s, so a dot product of nm terms costs nm/4 shared-memory loads
// instead of 2 nm: the loads, not the multiply-adds, bound the inner loop
// (an SM issues one warp-wide shared load per cycle, four FMAs). nm must be
// a multiple of 4, at most MAX_NM (YOLOv8-seg's nm is 32).
//
// Bound: on the detector path (K = 32, nm = 32, P = 96 x 160) it reads
// ~2.0 MB of prototypes and writes ~2.0 MB of masks (~1.2 us of HBM time at
// 3.35 TB/s) for ~16 M multiply-adds, so it is memory- and launch-bound;
// the tensor cores would not help, and fusing the x4 upsample, box crop and
// threshold into this pass is left for later.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_P = 64;
constexpr int K_SPLIT = 4;
constexpr int MAX_NM = 64;

__global__ void mask_combine_kernel(const float* __restrict__ proto,
                                    const float* __restrict__ coef,
                                    float* __restrict__ out, int P, int K,
                                    int nm) {
  extern __shared__ __align__(16) float smem[];
  float* coef_s = smem;                  // K * nm
  float* proto_s = smem + K * nm;        // TILE_P * (nm + 1)
  const int p0 = blockIdx.x * TILE_P;
  const int tid = threadIdx.y * TILE_P + threadIdx.x;
  const int n_threads = TILE_P * K_SPLIT;

  for (int i = tid; i < K * nm; i += n_threads) coef_s[i] = coef[i];
  const int n_tile = min(TILE_P, P - p0);
  const float* src = proto + static_cast<size_t>(p0) * nm;
  for (int i = tid; i < TILE_P * nm; i += n_threads) {
    const int r = i / nm;
    const int c = i - r * nm;
    proto_s[r * (nm + 1) + c] = r < n_tile ? src[i] : 0.f;
  }
  __syncthreads();

  const int x = threadIdx.x;
  if (x >= n_tile) return;
  float row[MAX_NM];
#pragma unroll
  for (int c = 0; c < MAX_NM; ++c) row[c] = c < nm ? proto_s[x * (nm + 1) + c] : 0.f;
  float* dst = out + p0 + x;
  for (int k = threadIdx.y; k < K; k += K_SPLIT) {
    const float4* ck = reinterpret_cast<const float4*>(coef_s + k * nm);
    float acc = 0.f;
#pragma unroll
    for (int c4 = 0; c4 < MAX_NM / 4; ++c4) {
      if (4 * c4 < nm) {
        const float4 w = ck[c4];
        acc = fmaf(w.x, row[4 * c4], acc);
        acc = fmaf(w.y, row[4 * c4 + 1], acc);
        acc = fmaf(w.z, row[4 * c4 + 2], acc);
        acc = fmaf(w.w, row[4 * c4 + 3], acc);
      }
    }
    dst[static_cast<size_t>(k) * P] = 1.f / (1.f + expf(-acc));
  }
}

}  // namespace

// Dynamic shared memory one launch needs, in bytes.
extern "C" int dyno_mask_combine_smem_bytes(int K, int nm) {
  return static_cast<int>(sizeof(float)) * (K * nm + TILE_P * (nm + 1));
}

// proto: contiguous (P, nm), coef: contiguous (K, nm), out: contiguous
// (K, P), all float32 device buffers. Launches on `stream` and returns the
// launch's cudaError_t (0 on success); it does not synchronise and
// allocates nothing.
extern "C" int dyno_mask_combine_f32(const float* proto, const float* coef,
                                     float* out, int P, int K, int nm,
                                     void* stream) {
  if (P <= 0 || K <= 0 || nm <= 0 || nm % 4 != 0 || nm > MAX_NM)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = dyno_mask_combine_smem_bytes(K, nm);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(TILE_P, K_SPLIT);
  const dim3 grid((P + TILE_P - 1) / TILE_P);
  mask_combine_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      proto, coef, out, P, K, nm);
  return static_cast<int>(cudaGetLastError());
}
