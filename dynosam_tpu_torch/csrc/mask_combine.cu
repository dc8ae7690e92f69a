// YOLO mask combination for Hopper (sm_90a): two entries of one source.
//
// Entry A, `dyno_mask_combine_f32` (the TPU kernel's function):
//
//   masks[k, p] = sigmoid(sum_c coef[k, c] * proto[p, c])
//
// for K detections, NM mask coefficients and P = Hp * Wp prototype pixels,
// in f32. It replaces the Pallas TPU kernel
// dynosam_tpu/ops/pallas/mask_combine.py (`_kernel`, reached through
// `mask_combine_pallas`), which kept the logits out of HBM and wrote the
// activated masks once.
//
// Entry B, `dyno_mask_label_f32` (the detector path's): one launch from
// (proto, coef, boxes, scores, valid) to the (H, W) int32 instance-label
// image that dynosam_tpu/nn/postprocess.py::combine_masks followed by
// masks_to_label_image computes. Per output pixel, for k ascending:
//
//   v_k  = bilinear value of the low-resolution sigmoid mask k at
//          F.interpolate(mode="bilinear", align_corners=False)'s source
//          index max((dst + 0.5) * Hp / H - 0.5, 0), the upper neighbour
//          clamped to the edge
//   in_k = valid[k] && v_k > mask_threshold
//          && x >= x1 - pad && x <= x2 + pad && y >= y1 - pad && y <= y2 + pad
//   label = 1 + the first k of largest score among in_k (strict >, so a
//           tie goes to the lower index, as argmax), or 0 where none is.
//
// It goes beyond the TPU kernel's idea: neither the (K, Hp, Wp) masks nor
// the (K, H, W) upsampled ones ever reach device memory, only the label.
//
// Bound, at the detector's shapes (K = 32, NM = 32, 96x160 prototypes,
// 384x640 labels): A reads 1.97 MB of prototypes and 4 KB of coefficients
// and writes 1.97 MB of masks, 1.18 us at 3.35 TB/s; its 31.5 MFLOP (the
// product and the sigmoid) take 0.47 us at the 67 TFLOP/s f32 rate. B needs
// only the prototype pixels under the valid padded boxes (with the one
// pixel the interpolation reads beyond them) and writes a 0.98 MB label
// image: 0.29 us with no detection, 0.88 us with boxes over the whole
// image; its operations (the product over each valid box, the lerp and the
// tests per output pixel inside a padded box) depend on the detections too
// and stay below that. Bytes bound both, and at these sizes the launch
// itself (a few us) is of the same order as the bound.
//
// Tensor cores are not used: the port runs f32 without TF32 (ROADMAP,
// rule (e)), and the product is below the byte bound on the CUDA cores.
//
// Design of A (v4), against that bound:
// - Templated on NM (instances 16 and 32); nothing is sized for a larger
//   nm than the one it runs.
// - The prototype is read in the caller's layout, one of two: planar
//   (pixel stride 1, the network's NCHW output seen as (Hp, Wp, nm),
//   strides (Wp, 1, Hp*Wp)) or interleaved (channel stride 1, pixel stride
//   a multiple of 4 floats, 16-byte aligned: NHWC, cuDNN's channels-last
//   output on the card). Neither is copied. Each thread holds 4 pixels x
//   NM channels in registers. Planar: 4 neighbouring pixels, one float4 per
//   channel straight from device memory (scalars where the planes are not
//   16-byte aligned, and at the ragged end). Interleaved: the block stages
//   its 128 pixels in shared memory with coalesced float4 loads, and each
//   thread reads pixels x + 32 i back as conflict-free float4s (rows padded
//   to NM + 4 floats).
// - A block is 32 pixel quads x 8 thread rows splitting K; a warp shares
//   one k, so the coefficients, kept in shared memory, are broadcast reads
//   (float4). Stores are float4s of 4 pixels (planar) or warp-contiguous
//   floats (interleaved), the ragged edge masked.
// - The grid is one wave of the SMs, striding over tiles of 128 pixels, so
//   each block reads the coefficient table once.
//
// Design of B, against that bound:
// - One block of 256 threads per 16 x 64 output tile. Before its first
//   barrier a block has three independent reads in flight: each thread's
//   first low-resolution halo pixel (NM channels, into registers), the
//   coefficient table (into shared memory) and, in one warp, the K boxes,
//   culled against the tile (padded boxes of valid rows only, order kept
//   by a ballot). Only the culled detections are evaluated; the
//   coefficients of the others, which may not be finite, are copied but
//   never used.
// - The block computes its halo tile of sigmoid values for the culled
//   detections into shared memory, exactly as A computes them (the same
//   FMA chain in channel order, so the two entries agree bit for bit), then
//   each thread walks 4 output pixels, with the interpolation written as
//   PyTorch's: h0 * (w0 * v00 + w1 * v01) + h1 * (w0 * v10 + w1 * v11),
//   every step explicitly rounded so nvcc contracts nothing into an FMA.
// - Instantiated for NM = 32, the network's; the same two layouts as A
//   (interleaved pixels as float4s, planar ones as scalars).
// - Any Hp, Wp, H, W: the halo's capacity is computed on the host from the
//   same float arithmetic over every tile.
//
// Both entries check their shared memory against the device's own opt-in
// limit per block and refuse a launch above it with SMEM_REFUSED.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int A_QUADS = 32;                       // pixel quads per thread row
constexpr int A_KSPLIT = 8;                       // thread rows splitting K
constexpr int A_TILE_P = 4 * A_QUADS;             // pixels per tile
constexpr int B_TH = 16, B_TW = 64;               // output tile of B
constexpr int B_THREADS = 256;
constexpr int SMEM_STATIC_LIMIT = 48 * 1024;      // above it a launch opts in
constexpr int SMEM_REFUSED = -1;                  // see the entries' comments

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// PyTorch's bilinear source coordinate (align_corners=False), clamped at 0.
__host__ __device__ __forceinline__ float src_coord(float scale, int d) {
#ifdef __CUDA_ARCH__
  const float s = __fsub_rn(__fmul_rn(scale, __fadd_rn(static_cast<float>(d), 0.5f)), 0.5f);
#else
  const float h = static_cast<float>(d) + 0.5f;
  const float m = scale * h;
  const float s = m - 0.5f;
#endif
  return s < 0.f ? 0.f : s;
}

// Low-resolution rows a run of outputs [d0, d1] reads: [i0(d0), i1(d1)].
__host__ __device__ __forceinline__ void src_span(float scale, int d0, int d1, int in, int* lo,
                                                  int* hi) {
  *lo = static_cast<int>(src_coord(scale, d0));
  const int i = static_cast<int>(src_coord(scale, d1));
  *hi = i < in - 1 ? i + 1 : i;
}

// Largest low-resolution span any tile of `tile` outputs reads.
int max_span(float scale, int out, int in, int tile) {
  int best = 1;
  for (int d0 = 0; d0 < out; d0 += tile) {
    const int d1 = d0 + tile < out ? d0 + tile - 1 : out - 1;
    int lo, hi;
    src_span(scale, d0, d1, in, &lo, &hi);
    if (hi - lo + 1 > best) best = hi - lo + 1;
  }
  return best;
}

// A device attribute of the current device, read once per device.
int device_attr(cudaDeviceAttr attr, int (&cached)[64]) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (cached[dev] == 0) cudaDeviceGetAttribute(&cached[dev], attr, dev);
  return cached[dev];
}

int sm_count() {
  static int cached[64] = {0};
  const int n = device_attr(cudaDevAttrMultiProcessorCount, cached);
  return n > 0 ? n : 1;
}

int smem_optin() {
  static int cached[64] = {0};
  return device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, cached);
}

// ---- entry A ------------------------------------------------------------------

// planar (pixel stride 1): thread x holds pixels p0 + 4x .. 4x+3, loaded
// as one float4 per channel where `vec` (channel planes 16-byte aligned)
// and as scalars elsewhere. Interleaved (channel stride 1, pixel stride a
// multiple of 4, 16-byte aligned): the block stages its tile of pixels in
// shared memory with coalesced float4 loads over channels and thread x
// holds pixels p0 + x + 32 i, read back as conflict-free float4s (row
// stride NM + 4 floats).
template <int NM>
__global__ void __launch_bounds__(A_QUADS * A_KSPLIT)
    mask_combine_kernel(const float* __restrict__ proto, long long sp, long long sc,
                        const float* __restrict__ coef, float* __restrict__ out, int P, int K,
                        int planar, int vec, int vec_out) {
  constexpr int S = NM + 4;
  extern __shared__ __align__(16) float coef_s[];   // K * NM, then A_TILE_P * S if interleaved
  float* tile_s = coef_s + K * NM;
  const int tid = threadIdx.y * A_QUADS + threadIdx.x;
  // the coefficient copy and the first tile's loads are in flight together:
  // the barrier after the loads also publishes coef_s
  for (int i = tid; i < K * NM; i += A_QUADS * A_KSPLIT) coef_s[i] = coef[i];

  for (int tile = blockIdx.x; tile * A_TILE_P < P; tile += gridDim.x) {
    const int p0 = tile * A_TILE_P;
    float v[NM][4];
    int pix[4];
    bool quad;
    if (planar) {
      const int p = p0 + 4 * threadIdx.x;
      quad = p + 3 < P;
#pragma unroll
      for (int i = 0; i < 4; ++i) pix[i] = p + i;
      if (quad && vec) {
#pragma unroll
        for (int c = 0; c < NM; ++c) {
          const float4 q = __ldg(reinterpret_cast<const float4*>(proto + c * sc + p));
          v[c][0] = q.x; v[c][1] = q.y; v[c][2] = q.z; v[c][3] = q.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < NM; ++c)
#pragma unroll
          for (int i = 0; i < 4; ++i) v[c][i] = p + i < P ? __ldg(proto + (p + i) + c * sc) : 0.f;
      }
      __syncthreads();
    } else {
      for (int e = tid; e < A_TILE_P * (NM / 4); e += A_QUADS * A_KSPLIT) {
        const int r = e / (NM / 4), c4 = e % (NM / 4), q = p0 + r;
        float4 x4 = make_float4(0.f, 0.f, 0.f, 0.f);
        if (q < P) x4 = __ldg(reinterpret_cast<const float4*>(proto + q * sp) + c4);
        *reinterpret_cast<float4*>(tile_s + r * S + 4 * c4) = x4;
      }
      __syncthreads();
      quad = false;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = threadIdx.x + A_QUADS * i;
        pix[i] = p0 + r;
#pragma unroll
        for (int c4 = 0; c4 < NM / 4; ++c4) {
          const float4 q = *reinterpret_cast<const float4*>(tile_s + r * S + 4 * c4);
          v[4 * c4][i] = q.x; v[4 * c4 + 1][i] = q.y; v[4 * c4 + 2][i] = q.z; v[4 * c4 + 3][i] = q.w;
        }
      }
    }
    if (pix[0] < P) {
      for (int k = threadIdx.y; k < K; k += A_KSPLIT) {
        const float4* ck = reinterpret_cast<const float4*>(coef_s + k * NM);
        float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c4 = 0; c4 < NM / 4; ++c4) {
          const float4 w = ck[c4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a[i] = fmaf(w.x, v[4 * c4][i], a[i]);
            a[i] = fmaf(w.y, v[4 * c4 + 1][i], a[i]);
            a[i] = fmaf(w.z, v[4 * c4 + 2][i], a[i]);
            a[i] = fmaf(w.w, v[4 * c4 + 3][i], a[i]);
          }
        }
        float* dst = out + static_cast<size_t>(k) * P;
        if (quad && vec_out) {
          *reinterpret_cast<float4*>(dst + pix[0]) =
              make_float4(sigmoid(a[0]), sigmoid(a[1]), sigmoid(a[2]), sigmoid(a[3]));
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (pix[i] < P) dst[pix[i]] = sigmoid(a[i]);
        }
      }
    }
    if (!planar) __syncthreads();        // the tile is restaged next round
  }
}

// ---- entry B ------------------------------------------------------------------

template <int NM>
__global__ void __launch_bounds__(B_THREADS)
    mask_label_kernel(const float* __restrict__ proto, long long sp, long long sc,
                      const float* __restrict__ coef, const float* __restrict__ boxes,
                      const float* __restrict__ scores, const uint8_t* __restrict__ valid,
                      int32_t* __restrict__ label, int K, int Hp, int Wp, int H, int W,
                      float scale_y, float scale_x, float thr, float pad, int halo_cap, int vec4) {
  extern __shared__ __align__(16) float smem[];
  float* coef_s = smem;                                  // K * NM
  float4* box_s = reinterpret_cast<float4*>(coef_s + K * NM);   // K: x1-pad, x2+pad, y1-pad, y2+pad
  float* score_s = reinterpret_cast<float*>(box_s + K);  // K
  int* list_s = reinterpret_cast<int*>(score_s + K);     // K
  float* val_s = reinterpret_cast<float*>(list_s + K);   // K * halo_cap
  __shared__ int n_s;

  const int tid = threadIdx.x;
  const int ty0 = blockIdx.y * B_TH, tx0 = blockIdx.x * B_TW;
  const int ty1 = min(ty0 + B_TH, H) - 1, tx1 = min(tx0 + B_TW, W) - 1;
  int lo_y, hi_y, lo_x, hi_x;
  src_span(scale_y, ty0, ty1, Hp, &lo_y, &hi_y);
  src_span(scale_x, tx0, tx1, Wp, &lo_x, &hi_x);
  const int cols = hi_x - lo_x + 1;
  const int halo = (hi_y - lo_y + 1) * cols;      // <= halo_cap (host-computed)

  // three independent reads in flight at once, before the first barrier:
  // this thread's first halo pixel into registers, the coefficient table
  // (every row; those of invalid rows are copied, never used) and the cull
  float v[NM];
  auto load_pixel = [&](int h) {
    const float* src = proto + static_cast<long long>((lo_y + h / cols) * Wp + lo_x + h % cols) * sp;
    if (vec4) {
#pragma unroll
      for (int c4 = 0; c4 < NM / 4; ++c4) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(src) + c4);
        v[4 * c4] = q.x; v[4 * c4 + 1] = q.y; v[4 * c4 + 2] = q.z; v[4 * c4 + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < NM; ++c) v[c] = __ldg(src + c * sc);
    }
  };
  if (tid < halo) load_pixel(tid);
  for (int i = tid; i < K * NM; i += B_THREADS) coef_s[i] = coef[i];

  // cull: the valid detections whose padded box meets the tile, in order
  if (tid < 32) {
    int n = 0;
    for (int base = 0; base < K; base += 32) {
      const int k = base + tid;
      bool hit = false;
      float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < K && valid[k]) {
        const float4 r = *reinterpret_cast<const float4*>(boxes + 4 * k);
        b = make_float4(__fsub_rn(r.x, pad), __fadd_rn(r.z, pad), __fsub_rn(r.y, pad),
                        __fadd_rn(r.w, pad));
        hit = static_cast<float>(tx1) >= b.x && static_cast<float>(tx0) <= b.y &&
              static_cast<float>(ty1) >= b.z && static_cast<float>(ty0) <= b.w;
      }
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (hit) {
        const int at = n + __popc(m & ((1u << tid) - 1u));
        list_s[at] = k;
        box_s[at] = b;
        score_s[at] = scores[k];
      }
      n += __popc(m);
    }
    if (tid == 0) n_s = n;
  }
  __syncthreads();
  const int n = n_s;
  if (n == 0) {
    for (int q = tid; q < B_TH * B_TW; q += B_THREADS) {
      const int y = ty0 + q / B_TW, x = tx0 + q % B_TW;
      if (y < H && x < W) label[static_cast<size_t>(y) * W + x] = 0;
    }
    return;
  }

  // the low-resolution sigmoid masks of the culled detections over the halo
  for (int h = tid; h < halo; h += B_THREADS) {
    if (h != tid) load_pixel(h);
    for (int j = 0; j < n; ++j) {
      const float4* cj = reinterpret_cast<const float4*>(coef_s + list_s[j] * NM);
      float a = 0.f;
#pragma unroll
      for (int c4 = 0; c4 < NM / 4; ++c4) {
        const float4 w = cj[c4];
        a = fmaf(w.x, v[4 * c4], a);
        a = fmaf(w.y, v[4 * c4 + 1], a);
        a = fmaf(w.z, v[4 * c4 + 2], a);
        a = fmaf(w.w, v[4 * c4 + 3], a);
      }
      val_s[j * halo_cap + h] = sigmoid(a);
    }
  }
  __syncthreads();

  for (int q = tid; q < B_TH * B_TW; q += B_THREADS) {
    const int y = ty0 + q / B_TW, x = tx0 + q % B_TW;
    if (y >= H || x >= W) continue;
    const float sy = src_coord(scale_y, y), sx = src_coord(scale_x, x);
    const int y0 = static_cast<int>(sy), x0 = static_cast<int>(sx);
    const int y1 = y0 < Hp - 1 ? y0 + 1 : y0, x1 = x0 < Wp - 1 ? x0 + 1 : x0;
    const float h1 = __fsub_rn(sy, static_cast<float>(y0)), w1 = __fsub_rn(sx, static_cast<float>(x0));
    const float h0 = __fsub_rn(1.f, h1), w0 = __fsub_rn(1.f, w1);
    const int i00 = (y0 - lo_y) * cols + (x0 - lo_x), i01 = (y0 - lo_y) * cols + (x1 - lo_x);
    const int i10 = (y1 - lo_y) * cols + (x0 - lo_x), i11 = (y1 - lo_y) * cols + (x1 - lo_x);
    const float xf = static_cast<float>(x), yf = static_cast<float>(y);
    int best = -1;
    float best_score = 0.f;
    for (int j = 0; j < n; ++j) {
      const float4 b = box_s[j];
      if (!(xf >= b.x && xf <= b.y && yf >= b.z && yf <= b.w)) continue;
      const float* vj = val_s + j * halo_cap;
      const float top = __fadd_rn(__fmul_rn(w0, vj[i00]), __fmul_rn(w1, vj[i01]));
      const float bot = __fadd_rn(__fmul_rn(w0, vj[i10]), __fmul_rn(w1, vj[i11]));
      const float val = __fadd_rn(__fmul_rn(h0, top), __fmul_rn(h1, bot));
      if (val > thr && (best < 0 || score_s[j] > best_score)) {
        best = list_s[j];
        best_score = score_s[j];
      }
    }
    label[static_cast<size_t>(y) * W + x] = best + 1;
  }
}

// Shared memory a launch needs against the device's opt-in limit per
// block: writes both to report[0], report[1]; returns SMEM_REFUSED above
// the limit, else the cudaError_t of opting the kernel in when it needs
// more than the static 48 KB (0 when it does not).
template <typename Kernel>
int fit_smem(Kernel kernel, int smem, int* report) {
  const int limit = smem_optin();
  report[0] = smem;
  report[1] = limit;
  if (smem > limit) return SMEM_REFUSED;
  if (smem <= SMEM_STATIC_LIMIT) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <int NM>
int launch_mask_combine(const float* proto, long long sp, long long sc, const float* coef,
                        float* out, int P, int K, int planar, int vec, int vec_out, int* report,
                        cudaStream_t stream) {
  const long long bytes = 4LL * K * NM + (planar ? 0 : 4LL * A_TILE_P * (NM + 4));
  const int smem = bytes > 0x7fffffffLL ? 0x7fffffff : static_cast<int>(bytes);
  if (const int e = fit_smem(mask_combine_kernel<NM>, smem, report)) return e;
  const int tiles = (P + A_TILE_P - 1) / A_TILE_P;
  const int grid = tiles < sm_count() ? tiles : sm_count();
  mask_combine_kernel<NM><<<grid, dim3(A_QUADS, A_KSPLIT), smem, stream>>>(
      proto, sp, sc, coef, out, P, K, planar, vec, vec_out);
  return static_cast<int>(cudaGetLastError());
}

int mask_label_halo_cap(int Hp, int Wp, int H, int W) {
  const float sy = static_cast<float>(Hp) / static_cast<float>(H);
  const float sx = static_cast<float>(Wp) / static_cast<float>(W);
  // one row and column of margin, should the device's rounding of a tile's
  // first or last source index differ from the host's
  return (max_span(sy, H, Hp, B_TH) + 1) * (max_span(sx, W, Wp, B_TW) + 1);
}

template <int NM>
int launch_mask_label(const float* proto, long long sp, long long sc, const float* coef,
                      const float* boxes, const float* scores, const uint8_t* valid,
                      int32_t* label, int K, int Hp, int Wp, int H, int W, float thr, float pad,
                      int* report, cudaStream_t stream) {
  // the coefficient table, the boxes, scores and order of up to K culled
  // detections and their low-resolution halo tiles
  const int halo_cap = mask_label_halo_cap(Hp, Wp, H, W);
  const long long bytes = 4LL * K * NM + 16LL * K + 4LL * K + 4LL * K + 4LL * K * halo_cap;
  const int smem = bytes > 0x7fffffffLL ? 0x7fffffff : static_cast<int>(bytes);
  if (const int e = fit_smem(mask_label_kernel<NM>, smem, report)) return e;
  const dim3 grid((W + B_TW - 1) / B_TW, (H + B_TH - 1) / B_TH);
  mask_label_kernel<NM><<<grid, B_THREADS, smem, stream>>>(
      proto, sp, sc, coef, boxes, scores, valid, label, K, Hp, Wp, H, W,
      static_cast<float>(Hp) / static_cast<float>(H), static_cast<float>(Wp) / static_cast<float>(W),
      thr, pad, halo_cap, sc == 1);
  return static_cast<int>(cudaGetLastError());
}

// The two layouts the entries take (see the header note).
bool planar_layout(long long sp) { return sp == 1; }

bool interleaved_layout(const float* proto, long long sp, long long sc) {
  return sc == 1 && sp % 4 == 0 && reinterpret_cast<uintptr_t>(proto) % 16 == 0;
}

}  // namespace

// proto: (Hp * Wp) pixels of nm channels, pixel p channel c at
// proto[p * sp + c * sc], planar (sp == 1) or interleaved (sc == 1, sp a
// multiple of 4, proto 16-byte aligned); coef: contiguous (K, nm); out:
// contiguous (K, P); float32 device buffers. nm must be an instantiated NM
// (16 or 32). Launches on `stream` and returns the launch's cudaError_t (0
// on success), or SMEM_REFUSED (-1) when the launch would need more shared
// memory per block than the device allows, with report[0] the bytes it
// needs and report[1] the device's limit. It does not synchronise and
// allocates nothing.
extern "C" int dyno_mask_combine_f32(const float* proto, long long sp, long long sc,
                                     const float* coef, float* out, int P, int K, int nm,
                                     int* report, void* stream) {
  if (P <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int planar = planar_layout(sp);
  if (!planar && !interleaved_layout(proto, sp, sc)) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = sc % 4 == 0 && reinterpret_cast<uintptr_t>(proto) % 16 == 0;
  const int vec_out = P % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nm) {
    case 16:
      return launch_mask_combine<16>(proto, sp, sc, coef, out, P, K, planar, vec, vec_out, report, s);
    case 32:
      return launch_mask_combine<32>(proto, sp, sc, coef, out, P, K, planar, vec, vec_out, report, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// proto: (Hp, Wp) pixels of nm channels, pixel (y, x) channel c at
// proto[(y * Wp + x) * sp + c * sc], in one of entry A's two layouts;
// coef (K, nm), boxes (K, 4) xyxy (16-byte aligned), scores (K,) float32
// and valid (K,) bool (one byte each), all contiguous; label: contiguous
// (H, W) int32. nm must be 32, the one instance. Returns as entry A does.
extern "C" int dyno_mask_label_f32(const float* proto, long long sp, long long sc,
                                   const float* coef, const float* boxes, const float* scores,
                                   const uint8_t* valid, int32_t* label, int K, int nm, int Hp,
                                   int Wp, int H, int W, float mask_threshold, float box_pad,
                                   int* report, void* stream) {
  if (K <= 0 || Hp <= 0 || Wp <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (!planar_layout(sp) && !interleaved_layout(proto, sp, sc))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(boxes) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nm != 32) return static_cast<int>(cudaErrorInvalidValue);
  return launch_mask_label<32>(proto, sp, sc, coef, boxes, scores, valid, label, K, Hp, Wp, H, W,
                               mask_threshold, box_pad, report, static_cast<cudaStream_t>(stream));
}
