// Hand-written Hopper (sm_90a) kernels of the calibration candidate search.
//
// They replace the int8-scored and fp32-scored Pallas scorers of the JAX
// package:
//
//   B1  ptq4vit_tpu/ops/pallas_search.py  linear_w_hessian_sims_i8
//       (body _kernel_i8_ploop): linear weight-interval search
//   B2  ptq4vit_tpu/ops/pallas_search.py  linear_a_hessian_sims_i8
//       (body _a_kernel_i8_ploop): linear input-interval search
//   B3  ptq4vit_tpu/ops/pallas_search.py  matmul_hessian_sims
//       (body _mm_kernel, F = 1): per-head attention-matmul search
//   B3f ptq4vit_tpu/ops/pallas_search.py  matmul_hessian_sims
//       (body _mm_kernel_folded, F > 1): the same search at the window
//       shapes of Swin; one kernel serves B3 and B3f (their section)
//   B4w, B4a  the fp32-scored (exact) twins of B1 and B2 (their section,
//       at the end)
//
// B1-B3f score P candidate scales Δ_p with the hessian similarity
//     sims[p] = -Σ (g · (raw - out_p))²
// where out_p is an int8 x int8 -> int32 product of quantization levels
// rescaled once in fp32.  Each call runs three kernels:
//
//   levels_kernel       quantizes each operand to int8 levels once (per
//                       candidate for the searched operand) into K-padded
//                       rows, one IEEE division per element;
//   a scored GEMM       the products of every candidate on the int8 tensor
//                       cores (wgmma s8 x s8 -> s32 from shared memory,
//                       fed by TMA through a ring of mbarrier-guarded
//                       slots by a producer warp, the operand no candidate
//                       changes resident in shared memory), the fp32
//                       rescale and the squared errors, summed per warp;
//   a reduction         sums the per-block partials in a fixed order.
//
// What bounds them on this card: B1 and B2 (linear_tc_kernel) take 2 K
// int8 operations per (output, candidate) pair against an epilogue of one
// int32 -> fp32 conversion and five fp32 operations, with K = 768-3072:
// the tensor cores; they reach about a fifth of the int8 peak, since a
// block runs each candidate's products and then its epilogue in turn and
// only the SM's second block fills the gap.  B3 / B3f's matmul1 has K = 32
// or 64, so its epilogue, not its products, bounds it: the B3 kernel
// overlaps one candidate's epilogue with the next one's products inside a
// block and converts the int32 sums without the slow I2F (their section).
// Every one of them ran __dp4a on the CUDA cores at 1-3% of the int8 peak
// in its first design.  B4w and B4a stay on the fp32 CUDA cores by their
// exact-scoring contract.
//
// Quantizing inside the candidate loop would make every output tile
// repeat the same divisions (they bounded the first kernels on the card);
// the pre-pass does each once.
//
// Determinism.  The TPU kernel sums across sequential grid steps; Hopper
// blocks run in no order, so every block (B3: every warp) writes its
// partial sums to scratch and a second kernel sums them in a fixed order
// (in double).  No atomics: the sims are the same from run to run.
//
// Numerics.  The elementwise part is bitwise equal to the plain PyTorch
// version: __fdiv_rn divisions, rintf (round half to even) levels, and the
// TPU kernels' rescale order with __fmul_rn / __fadd_rn, so no FMA
// contraction changes a rounding (the build also passes --fmad=false).
// The int32 accumulate is exact in any order; only the order of the fp32
// sums (and of B3's raw product) differs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int TK = 32;        // K pad unit of the level rows (bytes)
constexpr int NT = 256;       // threads of a B4 block

constexpr int kErrSize = 9004;         // a level buffer past 2^31 words

int cdiv(int a, int b) { return (a + b - 1) / b; }
int kpad(int K) { return cdiv(K, TK) * TK; }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int8_t clamp_level(float r, int lo, int hi) {
  r = fminf(fmaxf(r, (float)lo), (float)hi);
  return (int8_t)__float2int_rn(r);
}

// clip(round(v / d), lo, hi) as an int8 level
__device__ __forceinline__ int8_t qlevel(float v, float d, int lo, int hi) {
  return clamp_level(rintf(__fdiv_rn(v, d)), lo, hi);
}

// ---------------------------------------------------------------------------
// pre-pass: out[((p * Z + z) * rows + r) * Kp + k] = src.level(p, z, r, k)
// for k < K, 0 in the padding.  One thread per 4-byte word of the output:
// the index decode is shared by four levels and a warp writes 128
// consecutive bytes.
// ---------------------------------------------------------------------------

template <class Src>
__global__ void levels_kernel(Src src, int8_t* __restrict__ out, int P,
                              int Z, int rows, int K, int Kp) {
  const int KW = Kp / 4;
  const size_t total = (size_t)P * Z * rows * KW;
  int* out32 = reinterpret_cast<int*>(out);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int kw = (int)(i % KW);
    size_t t = i / KW;
    const int r = (int)(t % rows);
    t /= rows;
    const int z = (int)(t % Z);
    const int p = (int)(t / Z);
    unsigned word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int k = 4 * kw + b;
      const int8_t v = k < K ? src.level(p, z, r, k) : (int8_t)0;
      word |= (unsigned)(uint8_t)v << (8 * b);
    }
    out32[i] = (int)word;
  }
}

struct CopyLevels {  // int8 levels given by the caller, (rows, K)
  const int8_t* x;
  int K;
  __device__ int8_t level(int, int, int r, int k) const {
    return x[(size_t)r * K + k];
  }
};

struct WeightLevels {  // B1: Q(W[n]; Δ_p[v(n)])
  const float* w;
  const float* cands;  // (P, nV)
  int K, nV, crb, qmax;
  __device__ int8_t level(int p, int, int n, int k) const {
    return qlevel(w[(size_t)n * K + k], cands[p * nV + n / crb], -qmax,
                  qmax - 1);
  }
};

struct InputLevels {  // B2: Q(x[m]; Δ_p) signed or positive, or the
                      // fixed negative twin Q(x; a_neg)
  const float* x;
  const float* cands;  // (P,); unused for the negative twin
  float a_neg;
  int K, lo, hi, neg;
  __device__ int8_t level(int p, int, int m, int k) const {
    const float v = x[(size_t)m * K + k];
    return qlevel(v, neg ? a_neg : cands[p], lo, hi);
  }
};

// the candidate planes a pre-pass thread writes its level words for
constexpr int MM_LV_PLANES = 8;

// B3 / B3f operands, A's rows (R, Ci) as they are or B's columns as rows
// (Co, Ci).  kind 0: candidate scale cands[p, g]; 1: fixed scale fixed[g];
// 2: SoS high level; 3: SoS low level (scale a_int).
template <class T>
struct MatmulLevels {
  const T* X;
  const float* cands;  // (P, G)
  const float* fixed;  // (G,)
  float split, a_int;
  int S, G, R, Ci, Co, kind, qmax;
  // the scale of kinds 0, 1 and 3 at (p, g)
  __device__ __forceinline__ float scale(int p, int g) const {
    return kind == 0 ? cands[p * G + g] : (kind == 1 ? fixed[g] : a_int);
  }
  // the level of v under scale d
  __device__ __forceinline__ int8_t quant(float v, float d) const {
    if (kind == 2)
      return clamp_level(
          rintf(__fmul_rn(fminf(fmaxf(v, split), 1.f), (float)(qmax - 1))),
          0, qmax - 1);
    if (kind == 3)
      return qlevel(fminf(fmaxf(v, 0.f), split), d, 0, qmax - 1);
    return qlevel(v, d, -qmax, qmax - 1);
  }
};

// B3 / B3f pre-pass: out[((p * Z + z) * rows + r) * Kp + k] = the level
// of the operand at (z, r, k) under candidate p's scale (np = P planes;
// np = 1: a fixed operand), z = g * S + s, 0 past K.  A thread owns up to
// NW 16-byte words of a level row and MM_LV_PLANES planes (grid.y): it
// reads the values once and writes their levels for each of its planes,
// so the index decode and the reads are shared.  Threads run along A's
// rows' words (WHICH 0: contiguous reads and writes) or along B's columns
// (WHICH 1: contiguous reads of B's rows); NW = 2 there for long rows.
template <class T, int WHICH, int NW>
__global__ void mm_levels_kernel(MatmulLevels<T> src,
                                 int8_t* __restrict__ out, int np, int Kp) {
  constexpr int NV = 16 * NW;
  const int KC = Kp / 16, rows = WHICH == 0 ? src.R : src.Co;
  const int NQ = (KC + NW - 1) / NW;
  const int Z = src.S * src.G;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Z * rows * NQ) return;
  int z, r, q;
  if (WHICH == 0) {                       // (z, r, q), q fastest
    q = i % NQ;
    r = (i / NQ) % rows;
    z = i / (NQ * rows);
  } else {                                // (z, q, r), r fastest
    r = i % rows;
    q = (i / rows) % NQ;
    z = i / (rows * NQ);
  }
  const int g = z / src.S;
  const size_t sg = (size_t)(z - g * src.S) * src.G + g;
  const int c0 = q * NW, nw = min(NW, KC - c0);
  const T* x = WHICH == 0 ? src.X + (sg * src.R + r) * src.Ci
                          : src.X + sg * src.Ci * src.Co + r;
  float v[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int k = 16 * c0 + j;
    v[j] = k < src.Ci && j < 16 * nw
               ? to_f(WHICH == 0 ? x[k] : x[(size_t)k * src.Co])
               : 0.f;
  }
  const int p1 = min(np, (int)(blockIdx.y + 1) * MM_LV_PLANES);
  for (int p = blockIdx.y * MM_LV_PLANES; p < p1; ++p) {
    const float d = src.scale(p, g);
    int4* o = reinterpret_cast<int4*>(
        out + (((size_t)p * Z + z) * rows + r) * Kp + 16 * c0);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (w < nw) {
        unsigned b[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (16 * (c0 + w) + j < src.Ci)
            b[j >> 2] |=
                (unsigned)(uint8_t)src.quant(v[16 * w + j], d)
                << (8 * (j & 3));
        o[w] = make_int4((int)b[0], (int)b[1], (int)b[2], (int)b[3]);
      }
    }
  }
}

template <class T, int WHICH, int NW>
int launch_mm_levels(const MatmulLevels<T>& src, int8_t* out, int np,
                     int Kp, cudaStream_t st) {
  const int nq = (Kp / 16 + NW - 1) / NW;
  const long long threads =
      (long long)src.S * src.G * (WHICH == 0 ? src.R : src.Co) * nq;
  if (threads >= (1LL << 31)) return kErrSize;
  const dim3 grid((unsigned)((threads + 255) / 256),
                  (unsigned)cdiv(np, MM_LV_PLANES));
  mm_levels_kernel<T, WHICH, NW><<<grid, 256, 0, st>>>(src, out, np, Kp);
  return (int)cudaGetLastError();
}

// one word a thread, two along B's level rows past 64 bytes (measured:
// Swin's matmul1 B side 0.53 ms at one word against 0.79 at two; its
// matmul2's K = 144 rows 0.92 at two against 1.34 at one, NVIDIA H100)
template <class T, int WHICH>
int fill_mm_operand(const MatmulLevels<T>& src, int8_t* out, int np,
                    int Kp, cudaStream_t st) {
  if (WHICH == 1 && Kp > 64)
    return launch_mm_levels<T, WHICH, 2>(src, out, np, Kp, st);
  return launch_mm_levels<T, WHICH, 1>(src, out, np, Kp, st);
}

// out[p, g, bin] = -Σ_q partial[g, q, p, bin], summed in a fixed order
__global__ void reduce_partials(const float* __restrict__ partial,
                                float* __restrict__ out, int ngroups,
                                int nper, int P, int nbins) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= P * ngroups * nbins) return;
  const int bin = idx % nbins;
  const int g = (idx / nbins) % ngroups;
  const int p = idx / (nbins * ngroups);
  double s = 0.0;
  for (int q = 0; q < nper; ++q)
    s += (double)partial[(((size_t)g * nper + q) * P + p) * nbins + bin];
  out[idx] = -(float)s;
}

template <class Src>
int fill_levels(const Src& src, int8_t* out, int P, int Z, int rows, int K,
                cudaStream_t st) {
  const size_t words = (size_t)P * Z * rows * (kpad(K) / 4);
  const int blocks = (int)((words + 255) / 256 < 65536 ? (words + 255) / 256
                                                       : 65536);
  levels_kernel<Src><<<blocks, 256, 0, st>>>(src, out, P, Z, rows, K,
                                             kpad(K));
  return (int)cudaGetLastError();
}

// Fills the level buffers of a B3 / B3f call: la (P | 1, Z, R, Kp) and
// la2 (Z, R, Kp) from A, lb (1 | P, Z, Co, Kp) from B transposed.
template <class T, int MODE>
int fill_mm_levels(const void* A, const void* B, const float* cands,
                   const float* fixed_int, float split, float a_int, int S,
                   int G, int R, int Ci, int Co, int P, int cq, int fq,
                   int8_t* la, int8_t* la2, int8_t* lb, cudaStream_t st) {
  const int Kp = kpad(Ci);
  MatmulLevels<T> src;
  src.cands = cands; src.fixed = fixed_int; src.split = split;
  src.a_int = a_int; src.S = S; src.G = G; src.R = R; src.Ci = Ci;
  src.Co = Co;
  // left operand: A rows
  src.X = (const T*)A;
  src.kind = MODE == 0 ? 0 : (MODE == 1 ? 1 : 2);
  src.qmax = MODE == 0 ? cq : fq;
  int err = fill_mm_operand<T, 0>(src, la, MODE == 0 ? P : 1, Kp, st);
  if (err) return err;
  if (MODE == 2) {
    src.kind = 3;
    err = fill_mm_operand<T, 0>(src, la2, 1, Kp, st);
    if (err) return err;
  }
  // right operand: B transposed
  src.X = (const T*)B;
  src.kind = MODE == 0 ? 1 : 0;
  src.qmax = MODE == 0 ? fq : cq;
  return fill_mm_operand<T, 1>(src, lb, MODE == 0 ? 1 : P, Kp, st);
}

// ---------------------------------------------------------------------------
// B1 / B2: the linear scorers on the int8 tensor cores (wgmma)
// ---------------------------------------------------------------------------
//
// One block owns a 64 x 64 output tile and walks all candidates.  The
// operand that no candidate changes -- B1's input levels (the A side),
// B2's weight levels (the B side) -- is the "fixed" tile, 64 rows; the
// other one, the 64-row tile of candidate p's levels, is the candidate
// tile.  One consumer warpgroup computes the tile with wgmma m64n64k32
// (s8 x s8 -> s32) from shared memory; a producer warp, whose lane 0
// starts every TMA copy, feeds it.  The level buffers are read through
// 3-D tensor maps (Kp, rows, candidates) in boxes of 128 K bytes,
// 128-byte swizzled, which is the shared-memory layout wgmma reads
// (K-major, SBO 1024); the maps zero-fill rows past M or N and K past Kp,
// so ragged edges need no masking in the products.  A ring of S slots
// (mbarriers "full" and "empty") carries one K chunk a step: candidate
// p's chunk, and the fixed chunk(s) when the fixed tile is not resident.
// The fixed tile stays resident in shared memory for the whole candidate
// loop where it fits beside a ring of two slots within half an SM's
// shared memory (64 x Kp bytes a tile: K = 768 and 1024 fit; K = 3072 and
// the post-GELU pairs past K = 512 stream it with every chunk); the
// host's plan (ops/search_kernels.py ``linear_plan``) decides and passes
// it in.  Measured at fc1 (K = 768, H100): resident 1-2% faster than
// streamed (B1 kernel 2.31 vs 2.36 ms at 4 images, 16.95 vs 17.28 at 32),
// so L2 serves the fixed chunks about as well; the resident tile stays
// for the L2 traffic it saves.  Two blocks share an SM, so that one
// block's epilogue overlaps the other's products: a block's two phases do
// not overlap.
//
// Epilogue, per candidate and element: the first design's arithmetic with
// __fmul_rn / __fadd_rn in its order, so every squared error is bitwise
// that design's; raw, grad (and B2's ws[n], B1's row-block index, and
// the post-GELU fixed product) are loaded once per tile into the
// accumulator fragment's layout before the candidate loop.  Each warp
// reduces its squared errors with shuffles into its own per-candidate,
// per-bin slot in shared memory: no block-wide barrier per candidate.  At
// the end a named barrier of the consumer warps, then each block writes
// its partials in a fixed order; reduce_partials sums them.
//
// Block order: the blocks that run together share the candidate tile --
// B1 row tiles fastest (they share candidate p's weight columns), B2
// column tiles fastest (they share candidate p's input rows).

constexpr int LQ_ROWS = 64;             // rows of the fixed and candidate tiles
constexpr int LQ_KC = TMA_BOX_K;        // K bytes of one TMA box
constexpr int LQ_TILE = LQ_ROWS * LQ_KC;          // one chunk: 8 KB
constexpr int LQ_CWARPS = 4;            // consumer warps: one warpgroup
constexpr int LQ_THREADS = 32 * LQ_CWARPS + 32;   // + the producer warp
constexpr size_t LQ_SMEM_LIMIT = 232448;

// Dynamic shared memory of one block: 1 KB of alignment slack, the
// resident fixed tile(s), the ring, the per-warp accumulators, the
// mbarriers.  ops/search_kernels.py linear_plan computes the same sum.
size_t lin_smem_bytes(int NL, int NC, int resident, int stages, int pc,
                      int nbl) {
  const size_t slot = (size_t)LQ_TILE * (1 + (resident ? 0 : NL));
  return 1024 + (resident ? (size_t)NL * NC * LQ_TILE : 0)
         + (size_t)stages * slot + sizeof(float) * LQ_CWARPS * pc * nbl
         + 8 * (2 * (size_t)stages + 1);
}

struct LinArgs {
  const float* raw;      // (M, N), bias subtracted
  const float* grad;     // (M, N)
  const float* cands;    // B1 (P, nV); B2 (P,)
  const float* ws;       // B2 (N,)
  float a, a_neg;
  int M, N, P, nV, crb;
  int NC, ks_last;       // K chunks of LQ_KC bytes; 32-byte k-steps in the last
  int resident, stages;
  int p0, pc, nbl;       // candidates [p0, p0 + pc) of this launch; local bins
  int nrt, nct;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// KIND 0 = B1 (fixed x levels on A, candidate weight levels on B; NL = 2
// for the post-GELU twin, two fixed tiles sharing each weight fragment);
// KIND 1 = B2 (candidate input levels on A, fixed weight levels on B; PG:
// a candidate-free pass over the negative levels first).  Accumulator
// element i of a consumer thread: row 16 w4 + lane/4 + 8 ((i >> 1) & 1),
// column 8 (i >> 2) + 2 (lane & 3) + (i & 1) of its warpgroup's 64 x 64
// tile; "ci" numbers its 16 distinct columns.
template <int KIND, int NL, bool PG>
__global__ void __launch_bounds__(LQ_THREADS, 2)
    linear_tc_kernel(const __grid_constant__ CUtensorMap tm_fix0,
                     const __grid_constant__ CUtensorMap tm_fix1,
                     const __grid_constant__ CUtensorMap tm_cand,
                     const __grid_constant__ CUtensorMap tm_cfix,
                     LinArgs a, float* __restrict__ partial) {
  extern __shared__ uint8_t lq_smem[];
  const uint32_t base = (smem_u32(lq_smem) + 1023) & ~1023u;
  uint8_t* gbase = lq_smem + (base - smem_u32(lq_smem));
  const int S = a.stages, NC = a.NC;
  const size_t slot_bytes = (size_t)LQ_TILE * (1 + (a.resident ? 0 : NL));
  const uint32_t fixed = base;
  const uint32_t ring =
      fixed + (a.resident ? (uint32_t)(NL * NC * LQ_TILE) : 0u);
  float* wacc = reinterpret_cast<float*>(gbase + (ring - base) +
                                         (size_t)S * slot_bytes);
  const uint32_t bars =
      smem_u32(wacc) + (uint32_t)(sizeof(float) * LQ_CWARPS * a.pc * a.nbl);
  auto full_bar = [&](int s) { return bars + 8u * s; };
  auto empty_bar = [&](int s) { return bars + 8u * (S + s); };
  const uint32_t fixbar = bars + 8u * (2 * S);

  // block -> tile; the fixed tile's first row, the candidate tile's
  int rt, ct;
  if (KIND == 0) {
    rt = blockIdx.x % a.nrt;
    ct = blockIdx.x / a.nrt;
  } else {
    ct = blockIdx.x % a.nct;
    rt = blockIdx.x / a.nct;
  }
  const int row_base = rt * LQ_ROWS, col_base = ct * LQ_ROWS;  // output
  const int frow0 = KIND == 0 ? row_base : col_base;   // fixed tile rows
  const int crow0 = KIND == 0 ? col_base : row_base;   // candidate tile
  const int npass = a.pc + (PG ? 1 : 0);
  const int nsteps = npass * NC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), LQ_CWARPS);
    }
    mbar_init(fixbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 32 * LQ_CWARPS) {            // the producer warp
    if (threadIdx.x != 32 * LQ_CWARPS) return;
    if (a.resident) {
      mbar_expect_tx(fixbar, NL * NC * LQ_TILE);
      for (int l = 0; l < NL; ++l)
        for (int c = 0; c < NC; ++c)
          tma_load(fixed + (uint32_t)((l * NC + c) * LQ_TILE),
                   l == 0 ? &tm_fix0 : &tm_fix1, c * LQ_KC, frow0, 0, fixbar);
    }
    for (int t = 0; t < nsteps; ++t) {
      const int s = t % S, pass = t / NC, c = t % NC;
      mbar_wait(empty_bar(s), ((t / S) & 1) ^ 1);
      const uint32_t sb = ring + (uint32_t)(s * slot_bytes);
      mbar_expect_tx(full_bar(s), (int)slot_bytes);
      if (PG && pass == 0)
        tma_load(sb, &tm_cfix, c * LQ_KC, crow0, 0, full_bar(s));
      else
        tma_load(sb, &tm_cand, c * LQ_KC, crow0, a.p0 + pass - (PG ? 1 : 0),
                 full_bar(s));
      if (!a.resident)
        for (int l = 0; l < NL; ++l)
          tma_load(sb + (uint32_t)((1 + l) * LQ_TILE),
                   l == 0 ? &tm_fix0 : &tm_fix1, c * LQ_KC, frow0, 0,
                   full_bar(s));
    }
    return;
  }

  // ---- consumers: one warpgroup, warp w4 of it, lane ----
  const int ctid = threadIdx.x, w4 = ctid >> 5, lane = ctid & 31;

  float rv[32], gv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int m = row_base + 16 * w4 + (lane >> 2) + 8 * ((i >> 1) & 1);
    const int n = col_base + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    const bool ok = m < a.M && n < a.N;
    rv[i] = ok ? a.raw[(size_t)m * a.N + n] : 0.f;
    gv[i] = ok ? a.grad[(size_t)m * a.N + n] : 0.f;
  }
  // per column: B2's w_scale, B1's local row-block (bin) index, packed
  // four to a word; the block's first bin is bin0
  float wsv[KIND == 1 ? 16 : 1];
  uint32_t lbp[4] = {0u, 0u, 0u, 0u};
  const int bin0 = KIND == 0 ? col_base / a.crb : 0;
  int lb_lo = 0, lb_hi = 0;
#pragma unroll
  for (int ci = 0; ci < 16; ++ci) {
    const int n = col_base + 8 * (ci >> 1) + 2 * (lane & 3) + (ci & 1);
    if constexpr (KIND == 1)
      wsv[ci] = n < a.N ? a.ws[n] : 0.f;
    else
      lbp[ci >> 2] |= (uint32_t)((min(n, a.N - 1) / a.crb - bin0) & 255)
                      << (8 * (ci & 3));
  }
  if (KIND == 0) {
    lb_lo = min(col_base, a.N - 1) / a.crb - bin0;
    lb_hi = min(col_base + 63, a.N - 1) / a.crb - bin0;
  }
  float* my_acc = wacc + (size_t)w4 * a.pc * a.nbl;
  for (int i = lane; i < a.pc * a.nbl; i += 32) my_acc[i] = 0.f;
  __syncwarp();

  float fixv[PG ? 32 : 1];
  int acc[NL][32];

  if (a.resident) mbar_wait(fixbar, 0);
  int t = 0;
  for (int pass = 0; pass < npass; ++pass) {
#pragma unroll
    for (int l = 0; l < NL; ++l)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[l][i] = 0;
    for (int c = 0; c < NC; ++c, ++t) {
      const int s = t % S;
      mbar_wait(full_bar(s), (t / S) & 1);
      const uint32_t sb = ring + (uint32_t)(s * slot_bytes);
      const uint32_t cand = sb;
      const int ks = c + 1 < NC ? LQ_KC / 32 : a.ks_last;
#pragma unroll
      for (int l = 0; l < NL; ++l) fence_acc(acc[l]);
      wgmma_fence();
      for (int k = 0; k < ks; ++k) {
#pragma unroll
        for (int l = 0; l < NL; ++l) {
          const uint32_t fx =
              (a.resident ? fixed + (uint32_t)((l * NC + c) * LQ_TILE)
                          : sb + (uint32_t)((1 + l) * LQ_TILE)) +
              32u * k;
          const uint64_t dfix = sw128_desc(fx);
          const uint64_t dcand = sw128_desc(cand + 32u * k);
          if (KIND == 0)
            WgmmaS8<64>::mma(acc[l], dfix, dcand, 1);
          else
            WgmmaS8<64>::mma(acc[l], dcand, dfix, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int l = 0; l < NL; ++l) fence_acc(acc[l]);
      if (c > 0) {                     // chunk c - 1's products are done
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_bar((t - 1) % S));
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int l = 0; l < NL; ++l) fence_acc(acc[l]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar((t - 1) % S));
    // the accumulators as fp32, read here on the uniform path only (a read
    // under the bin loop's divergence would serialize the wgmma)
    float accf[NL][32];
#pragma unroll
    for (int l = 0; l < NL; ++l)
#pragma unroll
      for (int i = 0; i < 32; ++i) accf[l][i] = __int2float_rn(acc[l][i]);

    if constexpr (PG) {                // B2 post-GELU: acc_neg · a_neg
      if (pass == 0) {
#pragma unroll
        for (int i = 0; i < 32; ++i) fixv[i] = __fmul_rn(accf[0][i], a.a_neg);
        continue;
      }
    }
    const int pl = pass - (PG ? 1 : 0);    // local candidate
    const int p = a.p0 + pl;
    if constexpr (KIND == 1) {
      const float d = a.cands[p];
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float v = __fmul_rn(accf[0][i], d);
        if constexpr (PG) v = __fadd_rn(v, fixv[i]);
        const float out = __fmul_rn(v, wsv[((i >> 2) << 1) | (i & 1)]);
        const float e = __fmul_rn(gv[i], __fsub_rn(rv[i], out));
        sum = __fadd_rn(sum, __fmul_rn(e, e));
      }
      sum = warp_sum(sum);
      if (lane == 0) my_acc[pl] = sum;
    } else {
      for (int lb = lb_lo; lb <= lb_hi; ++lb) {
        const float d = a.cands[p * a.nV + bin0 + lb];
        const float ad = __fmul_rn(a.a, d);
        const float an = NL == 2 ? __fmul_rn(a.a_neg, d) : 0.f;
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int ci = ((i >> 2) << 1) | (i & 1);
          if (lb_lo != lb_hi &&
              (int)((lbp[ci >> 2] >> (8 * (ci & 3))) & 255u) != lb)
            continue;
          float out = __fmul_rn(accf[0][i], ad);
          if (NL == 2) out = __fadd_rn(out, __fmul_rn(accf[NL - 1][i], an));
          const float e = __fmul_rn(gv[i], __fsub_rn(rv[i], out));
          sum = __fadd_rn(sum, __fmul_rn(e, e));
        }
        sum = warp_sum(sum);
        if (lane == 0) my_acc[pl * a.nbl + lb] = sum;
      }
    }
  }

  // the consumers' per-warp sums -> this block's partials, in a fixed order
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * LQ_CWARPS) : "memory");
  const int nbins = KIND == 0 ? a.nV : 1;
  for (int idx = ctid; idx < a.pc * nbins; idx += 32 * LQ_CWARPS) {
    const int pl = idx / nbins, lb = idx % nbins - bin0;
    float s = 0.f;
    if (lb >= 0 && lb < a.nbl)
      for (int w = 0; w < LQ_CWARPS; ++w)
        s = __fadd_rn(s, wacc[((size_t)w * a.pc + pl) * a.nbl + lb]);
    partial[((size_t)blockIdx.x * a.P + a.p0 + pl) * nbins + idx % nbins] =
        s;
  }
}


// one launch per chunk of pc candidates, then the fixed-order reduction
template <int KIND, int NL, bool PG>
int launch_linear_tc(const CUtensorMap (&maps)[4], LinArgs a, int pc,
                     float* partial, float* out, cudaStream_t st) {
  const int K_NL = KIND == 0 ? NL : 1;
  const size_t smem = lin_smem_bytes(K_NL, a.NC, a.resident, a.stages, pc,
                                     a.nbl);
  if (smem > LQ_SMEM_LIMIT || a.stages < 2) return kErrSmem;
  auto kern = linear_tc_kernel<KIND, NL, PG>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nblocks = a.nrt * a.nct;
  for (int p0 = 0; p0 < a.P; p0 += pc) {
    a.p0 = p0;
    a.pc = a.P - p0 < pc ? a.P - p0 : pc;
    kern<<<nblocks, LQ_THREADS, smem, st>>>(maps[0], maps[1], maps[2],
                                            maps[3], a, partial);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int nbins = KIND == 0 ? a.nV : 1;
  reduce_partials<<<cdiv(a.P * nbins, 128), 128, 0, st>>>(
      partial, out, 1, nblocks, a.P, nbins);
  return (int)cudaGetLastError();
}

LinArgs lin_args(int kind, const float* raw, const float* grad,
                 const float* cands, const float* ws, float a, float a_neg,
                 int M, int K, int N, int P, int nV, int resident,
                 int stages, int nbl) {
  LinArgs r;
  const int Kp = kpad(K);
  r.raw = raw; r.grad = grad; r.cands = cands; r.ws = ws;
  r.a = a; r.a_neg = a_neg;
  r.M = M; r.N = N; r.P = P; r.nV = nV; r.crb = N / nV;
  r.NC = cdiv(Kp, LQ_KC);
  r.ks_last = (Kp - (r.NC - 1) * LQ_KC) / 32;
  r.resident = resident; r.stages = stages;
  r.p0 = 0; r.pc = P; r.nbl = nbl;
  r.nrt = cdiv(M, LQ_ROWS); r.nct = cdiv(N, LQ_ROWS);
  return r;
}

// ---------------------------------------------------------------------------
// B3 / B3f: the attention-matmul scorers on the int8 tensor cores (wgmma)
// ---------------------------------------------------------------------------
//
// They replace the two bodies of ptq4vit_tpu/ops/pallas_search.py
// matmul_hessian_sims: _mm_kernel (B3, ViT's shapes) and _mm_kernel_folded
// (B3f, Swin's window shapes).  For each candidate p and head g
//     sims[p, g] = -Σ_(s, r, c) g²[s, g, r, c] (raw - out_p)²[s, g, r, c]
// with raw = A @ B in fp32 and out_p the int8 x int8 -> int32 product of
// the quantized operands rescaled once in fp32: mode "a" (candidates on
// A), "b" (on B), "b_sos" (on B, the softmax side as SoS hi / lo levels).
// The TPU folds heads into one block-diagonal dot to fill its 128 lanes;
// the card does not need that: one kernel serves both bodies, and B3 /
// B3f differ only in the wrapper that counts their launches.
//
// What bounds them on this card differs by matmul.  matmul1 (q·kᵀ, modes
// a and b) has K = head dim (64 on ViT, 32 on Swin): its products take
// 2 K int8 operations per (output, candidate) pair, its epilogue one
// int32 -> fp32 conversion and five fp32 operations, none of them an FMA
// -- so the epilogue, not the tensor cores, bounds it.  matmul2
// (softmax·v, b_sos) has K = 577 or 144 and two products per output
// against eight epilogue operations: the tensor cores bound it.
//
// Design.  A block owns one 64-row output tile of one (sample or window,
// head) problem and walks all P candidates.  The tile's width W is an s8
// wgmma N fitted to Co (mm_width: 32 for Co <= 32, 48 where it divides Co
// and 64 does not -- Swin's 144 --, else 64; s8 wgmma takes N = 8, 16, 24,
// 32 and then multiples of 16, so 72 is no width); two consumer
// warpgroups split its columns, so an SM runs 16 to 24 consumer warps.
// The levels come from the pre-pass above (mm_levels_kernel: each
// division once, where quantizing in the block would repeat a candidate
// row strip's divisions for every column tile).  A producer warp brings
// them by TMA: the fixed operand's tile(s) once, resident in shared memory
// for the whole candidate loop, and the candidates' K chunks (128 bytes of
// each row) into a ring of mbarrier-guarded slots; rows past R or Co and
// K past Kp zero-fill.  The consumers run wgmma m64n(W/2)k32 s8 x s8 ->
// s32 from shared memory, 128-byte swizzled (linear_tc_kernel's layout).
//
// The epilogue is the floor at K <= 64, so what surrounds it is cut down:
//   - raw = A @ B is computed once per tile in fp32 on the CUDA cores
//     (__fmaf_rn, ascending k; no TF32), and g² loaded once, both into
//     registers in the accumulator fragment's layout;
//   - candidates go in pairs: one wgmma group, one wait, two epilogues and
//     one shuffle tree for both sums; the other warpgroups of the SM cover
//     the wait.  (Overlapping a candidate's products with the previous
//     one's epilogue inside a warpgroup made ptxas serialize every wgmma,
//     C7514, and was slower.)
//   - no accumulator is touched on a divergent path, and no wait loop
//     stands between a wgmma fence and a wgmma (either makes ptxas
//     serialize the wgmma, C7520); past an odd P the pair's second half
//     runs on stale data and is dropped;
//   - k-steps per K chunk are compile-time (the last chunk's 1, 2 or 4), and
//     the ring position, slot and phase advance by counters, not divisions;
//   - where |acc| < 2^22 (K < 256 with int8 levels: every matmul1 and
//     Swin's matmul2) the int32 -> fp32 conversion is an integer add to
//     the bits of 1.5 * 2^23 and an fp32 subtraction, exact and the same
//     value as the slow I2F; ViT's matmul2 (K = 577) keeps I2F;
//   - each warp writes its own per-candidate partial: no block-wide
//     barrier per candidate; 8-column groups past Co and warps whose 16
//     rows all lie past R skip the arithmetic (their partial is 0).
// The rescale keeps the TPU kernel's order with __fmul_rn / __fadd_rn
// (d·f hoisted per candidate, f·d equal to it), so each squared error is
// the plain version's up to the raw product's fp32 summation order.
// Determinism: per-warp partials in a fixed layout, summed by reduce_rows
// in double in a fixed order; no atomics.
//
// Shared memory (ops/search_kernels.py matmul_plan computes the same sum
// and picks the ring's depth): 1 KB of alignment slack, the resident fixed
// tile(s), the ring, the raw product's staging, the mbarriers, within an
// SM's share for mm_min_blocks blocks; ViT's matmul2, whose two resident
// SoS tiles take 80 KB at K = 577, runs one block an SM.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W, PERF.md): 4.4-5.9x the first
// design at ViT-B/384's shapes, 2.1-3.2x at Swin-B/384's; what holds them
// is the SM's issue of the epilogue and of the per-candidate bookkeeping
// (clock64 phases: the candidate loop without products or epilogue took
// a third of the kernel), and at Swin the 16-row tail of each 144-row
// window, whose tiles pay the products for a quarter of the rows.

constexpr int MM_ROWS = 64;        // output rows of a block (wgmma M)
constexpr int MM_RK = 16;          // K chunk of the fp32 raw product
constexpr int MM_MAX_STAGES = 16;  // ring slots, one 128-byte K chunk each
constexpr int MM_FAST_K = 256;     // K below which |acc| < 2^22
constexpr int MM_WGS = 2;          // consumer warpgroups: column halves
constexpr int MM_CWARPS = 4 * MM_WGS;            // per-warp partials
constexpr int MM_THREADS = 32 * MM_CWARPS + 32;  // + the producer warp

// blocks an SM runs (ops/search_kernels.py mm_blocks_per_sm): three at the
// narrow tiles, whose threads need at most 75 registers; two at W = 64,
// which needs about 96; SoS, with two fixed tiles, three at W = 32 and
// one past it (150 registers at W = 64)
__host__ __device__ constexpr int mm_min_blocks(int W, bool sos) {
  return sos ? (W <= 32 ? 3 : 1) : (W <= 48 ? 3 : 2);
}

// the column width of a block's output tile (ops/search_kernels.py
// mm_width)
int mm_width(int Co) {
  return Co <= 32 ? 32 : (Co % 48 == 0 && Co % 64 != 0 ? 48 : 64);
}

size_t mm_smem_bytes(int mode, int Ci, int W, int stages) {
  const size_t nc = cdiv(kpad(Ci), LQ_KC);
  const size_t rows_fix = mode == 0 ? W : MM_ROWS;
  const size_t rows_cand = mode == 0 ? MM_ROWS : W;
  const size_t nl = mode == 2 ? 2 : 1;
  return 1024 + nl * nc * rows_fix * LQ_KC + stages * rows_cand * LQ_KC
         + sizeof(float) * MM_RK * ((MM_ROWS + 4) + (W + 4))
         + 8 * (2 * (size_t)stages + 1);
}

struct MmArgs {
  const void* A;           // (S, G, R, Ci) f32 or bf16
  const void* B;           // (S, G, Ci, Co)
  const void* grad;        // (S, G, R, Co)
  const float* cands;      // (P, G)
  const float* fixed_int;  // (G,)
  float s_hi, s_lo;
  int bf16;
  int S, G, R, Ci, Co, P;
  int cand_on_a;           // mode a: the candidate tile is wgmma's A
  int NC;                  // 128-byte K chunks of a level row
  int stages, nrt, nct;
};

__device__ __forceinline__ float load_f(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// int32 -> fp32, exact: |v| < 2^22 adds v to the bits of 1.5 * 2^23
template <bool FAST>
__device__ __forceinline__ float acc_to_f(int v) {
  if (FAST)
    return __fsub_rn(__int_as_float(v + 0x4B400000), 12582912.f);
  return __int2float_rn(v);
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * MM_CWARPS) : "memory");
}


// The products of one candidate into acc (NL sets: the SoS hi and lo
// tiles share the candidate tile), its NC K chunks from the ring slots
// from slot on (real false: past the last candidate, the same products on
// whatever the ring holds, into a sum that is dropped, so that no wgmma
// stands under a branch).  A chunk is four 32-byte k-steps, the last one
// KL (past Kp the TMA box holds zeros): fixed counts let ptxas chain the
// wgmma.  boff: this warpgroup's rows of the W-row tile (its half of the
// output columns).
template <int WH, int NL, int KL>
__device__ __forceinline__ void mm_products(int (&acc)[NL][WH / 2],
                                            bool real, int slot,
                                            const MmArgs& a, uint32_t fixed,
                                            uint32_t ring, uint32_t tile_f,
                                            uint32_t tile_c, uint32_t boff) {
  const uint32_t coff = a.cand_on_a ? 0u : boff;   // the candidate tile's
  const uint32_t foff = a.cand_on_a ? boff : 0u;   // the fixed tile's
  if (!real) slot = 0;
  auto chunk = [&](int c, int ks) {
    const uint32_t cand = ring + (uint32_t)slot * tile_c + coff;
    if (++slot == a.stages) slot = 0;
#pragma unroll
    for (int k = 0; k < ks; ++k) {
      const uint32_t ca = cand + 32u * k;
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        const uint32_t fa =
            fixed + (uint32_t)(l * a.NC + c) * tile_f + foff + 32u * k;
        WgmmaS8<WH>::mma(acc[l], sw128_desc(a.cand_on_a ? ca : fa),
                         sw128_desc(a.cand_on_a ? fa : ca), (c | k) != 0);
      }
    }
  };
  for (int c = 0; c + 1 < a.NC; ++c) chunk(c, LQ_KC / 32);
  chunk(a.NC - 1, KL);
}

// One candidate's squared errors, summed over this thread's outputs
// (ngrp of its 8-column groups hold output columns; live: its warp has
// rows and columns).  The accumulators are read on the uniform path only,
// and the asm keeps the compiler from sinking those reads into the
// branches below: an accumulator touched on a divergent path makes ptxas
// serialize every wgmma of the kernel (C7520).
template <int NA, int NL, bool FAST>
__device__ __forceinline__ float mm_thread_sum(const int (&acc)[NL][NA],
                                               const float (&raw)[NA],
                                               const float (&g2)[NA],
                                               float scale, float s_hi,
                                               float s_lo, int ngrp,
                                               bool live) {
  float x[NL][NA];
#pragma unroll
  for (int l = 0; l < NL; ++l)
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      x[l][i] = acc_to_f<FAST>(acc[l][i]);
      asm volatile("" : "+f"(x[l][i]));
    }
  // four independent sums (element i & 3): no chain of dependent adds
  // runs the length of the tile
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  auto term = [&](int i) {
    const float out =
        NL == 2 ? __fmul_rn(__fadd_rn(__fmul_rn(x[0][i], s_hi),
                                      __fmul_rn(x[NL - 1][i], s_lo)),
                            scale)
                : __fmul_rn(x[0][i], scale);
    const float diff = __fsub_rn(raw[i], out);
    part[i & 3] =
        __fadd_rn(part[i & 3], __fmul_rn(__fmul_rn(g2[i], diff), diff));
  };
  if (live) {
    if (ngrp == NA / 4) {              // every column: no branch
#pragma unroll
      for (int i = 0; i < NA; ++i) term(i);
    } else {
#pragma unroll
      for (int i = 0; i < NA; ++i)
        if ((i >> 2) < ngrp) term(i);
    }
  }
  return __fadd_rn(__fadd_rn(part[0], part[1]), __fadd_rn(part[2], part[3]));
}

// Two candidates' thread sums summed over the warp at once: lanes 0-15
// end with u's sum, lanes 16-31 with v's (5 shuffles for both).
__device__ __forceinline__ float pair_warp_sum(float u, float v, int lane) {
  const bool hi = lane & 16;
  float s = __fadd_rn(hi ? v : u,
                      __shfl_xor_sync(0xffffffffu, hi ? u : v, 16));
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  return s;
}

// Accumulator element i of a consumer thread: row 16 w4 + lane/4 + 8
// ((i >> 1) & 1), column 8 (i >> 2) + 2 (lane & 3) + (i & 1) of its
// warpgroup's 64 x W/2 half of the block's tile.
template <int W, bool SOS, bool FAST, int KL>
__global__ void __launch_bounds__(MM_THREADS, mm_min_blocks(W, SOS))
    mm_tc_kernel(const __grid_constant__ CUtensorMap tm_cand,
                 const __grid_constant__ CUtensorMap tm_fix0,
                 const __grid_constant__ CUtensorMap tm_fix1, MmArgs a,
                 float* __restrict__ partial) {
  constexpr int NL = SOS ? 2 : 1;    // fixed tiles: the SoS hi and lo
  constexpr int WH = W / MM_WGS;     // columns of a warpgroup
  constexpr int NA = WH / 2;         // accumulators a thread
  extern __shared__ uint8_t mm_smem[];
  const uint32_t base = (smem_u32(mm_smem) + 1023) & ~1023u;
  uint8_t* gbase = mm_smem + (base - smem_u32(mm_smem));
  const int S = a.stages, NC = a.NC;
  const uint32_t tile_f = (a.cand_on_a ? W : MM_ROWS) * LQ_KC;
  const uint32_t tile_c = (a.cand_on_a ? MM_ROWS : W) * LQ_KC;
  const uint32_t fixed = base;
  const uint32_t ring = fixed + (uint32_t)(NL * NC) * tile_f;
  float* As = reinterpret_cast<float*>(gbase + (ring - base) +
                                       (size_t)S * tile_c);
  float* Bs = As + MM_RK * (MM_ROWS + 4);
  const uint32_t bars = smem_u32(Bs + MM_RK * (W + 4));
  const uint32_t fixbar = bars + 8u * (2 * S);

  // block -> (problem, row tile, column tile); column tiles fastest, so
  // the blocks that run together share the problem's levels
  int b = blockIdx.x;
  const int ct = b % a.nct;
  b /= a.nct;
  const int rt = b % a.nrt;
  const int z = b / a.nrt;                  // level index g * S + s
  const int g = z / a.S, s = z % a.S;
  const int Z = a.S * a.G;
  const int row_base = rt * MM_ROWS, col_base = ct * W;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(bars + 8u * i, 1);
      mbar_init(bars + 8u * (S + i), MM_CWARPS);
    }
    mbar_init(fixbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 32 * MM_CWARPS) {            // the producer warp
    if (threadIdx.x != 32 * MM_CWARPS) return;
    const int frow0 = a.cand_on_a ? col_base : row_base;
    const int crow0 = a.cand_on_a ? row_base : col_base;
    mbar_expect_tx(fixbar, (int)(NL * NC * tile_f));
    for (int l = 0; l < NL; ++l)
      for (int c = 0; c < NC; ++c)
        tma_load(fixed + (uint32_t)(l * NC + c) * tile_f,
                 l == 0 ? &tm_fix0 : &tm_fix1, c * LQ_KC, frow0, z, fixbar);
    // the candidates' K chunks, one a slot, in (candidate, chunk) order
    RingPos pos{0, 1u};   // every slot starts free: its first wait passes
    for (int p = 0; p < a.P; ++p)
      for (int c = 0; c < NC; ++c) {
        const uint32_t st = (uint32_t)pos.slot;
        mbar_wait(bars + 8u * (S + st), pos.phase);
        mbar_expect_tx(bars + 8u * st, (int)tile_c);
        tma_load(ring + st * tile_c, &tm_cand, c * LQ_KC, crow0, p * Z + z,
                 bars + 8u * st);
        pos.advance(S);
      }
    return;
  }

  // ---- consumers: warpgroup wg (its half of the columns), warp w4 ----
  // wg through a shuffle: the compiler then knows it is warp-uniform and
  // keeps the wgmma descriptors in uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int w4 = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * w4 + (lane >> 2), c0 = wg * WH + 2 * (lane & 3);
  const int R = a.R, Ci = a.Ci, Co = a.Co;
  const size_t sg = (size_t)s * a.G + g;   // operand index

  // raw = A @ B in fp32 for this tile, one ascending-k chain per output
  float raw[NA], g2[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) raw[i] = 0.f;
  for (int k0 = 0; k0 < Ci; k0 += MM_RK) {
    if (k0 > 0) consumer_sync();          // the last chunk has been read
    for (int idx = threadIdx.x; idx < MM_ROWS * MM_RK;
         idx += 32 * MM_CWARPS) {
      const int r = idx / MM_RK, kk = idx % MM_RK;
      const int m = row_base + r, k = k0 + kk;
      As[kk * (MM_ROWS + 4) + r] =
          m < R && k < Ci ? load_f(a.A, (sg * R + m) * Ci + k, a.bf16) : 0.f;
    }
    for (int idx = threadIdx.x; idx < MM_RK * W; idx += 32 * MM_CWARPS) {
      const int kk = idx / W, c = idx % W;
      const int k = k0 + kk, n = col_base + c;
      Bs[kk * (W + 4) + c] =
          k < Ci && n < Co ? load_f(a.B, (sg * Ci + k) * Co + n, a.bf16)
                           : 0.f;
    }
    consumer_sync();
#pragma unroll 4
    for (int kk = 0; kk < MM_RK; ++kk) {
      const float a0 = As[kk * (MM_ROWS + 4) + r0];
      const float a1 = As[kk * (MM_ROWS + 4) + r0 + 8];
#pragma unroll
      for (int j = 0; j < WH / 8; ++j) {
        const float2 bv =
            *reinterpret_cast<const float2*>(&Bs[kk * (W + 4) + 8 * j + c0]);
        raw[4 * j] = __fmaf_rn(a0, bv.x, raw[4 * j]);
        raw[4 * j + 1] = __fmaf_rn(a0, bv.y, raw[4 * j + 1]);
        raw[4 * j + 2] = __fmaf_rn(a1, bv.x, raw[4 * j + 2]);
        raw[4 * j + 3] = __fmaf_rn(a1, bv.y, raw[4 * j + 3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int m = row_base + r0 + 8 * ((i >> 1) & 1);
    const int n = col_base + 8 * (i >> 2) + c0 + (i & 1);
    const float gv =
        m < R && n < Co ? load_f(a.grad, (sg * R + m) * Co + n, a.bf16) : 0.f;
    g2[i] = __fmul_rn(gv, gv);
  }

  const float f = a.fixed_int[g];
  const int ngrp = max(0, min(WH / 8, (Co - col_base - wg * WH + 7) / 8));
  const bool live = ngrp > 0 && row_base + 16 * w4 < R;
  const int nper = a.S * a.nrt * a.nct * MM_CWARPS;
  float* out = partial + (size_t)g * a.P * nper +
               ((size_t)(s * a.nrt + rt) * a.nct + ct) * MM_CWARPS +
               4 * wg + w4;
  const uint32_t boff = (uint32_t)(wg * WH * LQ_KC);
  const float* cand_d = a.cands + g;        // d of candidate p: [p * G]
  // Candidates go in pairs: both products in one wgmma group, then both
  // epilogues, summed over the warp at once.  A pair's wgmma latency is
  // covered by the SM's other warpgroups; one wait a pair ends every
  // accumulator's use, so ptxas chains the wgmma without serializing.
  // Past an odd P the pair's second sum is taken all the same and dropped.
  RingPos pos{0, 0u};       // the next chunk this warpgroup waits for
  int accA[NL][NA], accB[NL][NA];
#pragma unroll
  for (int l = 0; l < NL; ++l)
#pragma unroll
    for (int i = 0; i < NA; ++i) accA[l][i] = accB[l][i] = 0;
  float dA = cand_d[0];
  mbar_wait(fixbar, 0);
  for (int p = 0; p < a.P; p += 2) {
    const bool two = p + 1 < a.P;
    const int slotA = pos.slot;
    for (int c = 0; c < (two ? 2 : 1) * NC; ++c) {
      mbar_wait(bars + 8u * pos.slot, pos.phase);
      pos.advance(S);
    }
    const int slotB = slotA + NC < S ? slotA + NC : slotA + NC - S;
    const float dB = cand_d[(size_t)min(p + 1, a.P - 1) * a.G];
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      fence_acc(accA[l]);
      fence_acc(accB[l]);
    }
    wgmma_fence();
    mm_products<WH, NL, KL>(accA, true, slotA, a, fixed, ring, tile_f,
                            tile_c, boff);
    mm_products<WH, NL, KL>(accB, two, slotB, a, fixed, ring, tile_f,
                            tile_c, boff);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      fence_acc(accA[l]);
      fence_acc(accB[l]);
    }
    __syncwarp();
    if (lane == 0)                     // the pair's slots are free
      for (int c = 0, st = slotA; c < (two ? 2 : 1) * NC; ++c) {
        mbar_arrive(bars + 8u * (S + st));
        if (++st == S) st = 0;
      }
    const float su = mm_thread_sum<NA, NL, FAST>(
        accA, raw, g2, SOS ? dA : __fmul_rn(dA, f), a.s_hi, a.s_lo, ngrp,
        live);
    const float sv = mm_thread_sum<NA, NL, FAST>(
        accB, raw, g2, SOS ? dB : __fmul_rn(dB, f), a.s_hi, a.s_lo, ngrp,
        live);
    dA = cand_d[(size_t)min(p + 2, a.P - 1) * a.G];
    const float sum = pair_warp_sum(su, sv, lane);
    if (lane == 0) out[(size_t)p * nper] = sum;
    if (lane == 16 && two) out[(size_t)(p + 1) * nper] = sum;
  }
}

// out[p, g] = -Σ_q partial[(g * P + p) * nper + q]: one block an output,
// each thread a strided run of q in double, then a fixed tree
__global__ void reduce_rows(const float* __restrict__ partial,
                            float* __restrict__ out, int G, int P,
                            int nper) {
  __shared__ double red[256];
  const int p = blockIdx.x / G, g = blockIdx.x % G;
  const float* src = partial + ((size_t)g * P + p) * nper;
  double v = 0.0;
  for (int q = threadIdx.x; q < nper; q += 256) v += (double)src[q];
  red[threadIdx.x] = v;
  __syncthreads();
  for (int h = 128; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = -(float)red[0];
}

template <int W, bool SOS, bool FAST, int KL>
int launch_mm_tc(const CUtensorMap (&maps)[3], const MmArgs& a, size_t smem,
                 float* partial, float* out, cudaStream_t st) {
  auto kern = mm_tc_kernel<W, SOS, FAST, KL>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nblocks = a.S * a.G * a.nrt * a.nct;
  kern<<<nblocks, MM_THREADS, smem, st>>>(maps[0], maps[1], maps[2], a,
                                          partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows<<<a.P * a.G, 256, 0, st>>>(partial, out, a.G, a.P,
                                         a.S * a.nrt * a.nct * MM_CWARPS);
  return (int)cudaGetLastError();
}

// the kernel for tile width W: SoS or not, the fast int32 conversion or
// not, and the k-steps of the last K chunk (1, 2 or 4; 3 runs 4, the
// fourth on zeros)
template <int W>
int launch_mm_width(const CUtensorMap (&maps)[3], const MmArgs& a, int sos,
                    int ks_last, size_t smem, float* partial, float* out,
                    cudaStream_t st) {
  const bool fast = a.Ci < MM_FAST_K;
#define PTQ_MM_KL(SOS, FAST)                                                 \
  return ks_last == 1                                                        \
             ? launch_mm_tc<W, SOS, FAST, 1>(maps, a, smem, partial, out, st) \
         : ks_last == 2                                                      \
             ? launch_mm_tc<W, SOS, FAST, 2>(maps, a, smem, partial, out, st) \
             : launch_mm_tc<W, SOS, FAST, 4>(maps, a, smem, partial, out, st)
  if (sos) {
    if (fast) PTQ_MM_KL(true, true);
    PTQ_MM_KL(true, false);
  }
  if (fast) PTQ_MM_KL(false, true);
  PTQ_MM_KL(false, false);
#undef PTQ_MM_KL
}

// ---------------------------------------------------------------------------
// B4w / B4a: the fp32-scored (exact) linear scorers
// ---------------------------------------------------------------------------
//
// They replace
//   B4w ptq4vit_tpu/ops/pallas_search.py  linear_w_hessian_sims
//       (body _kernel_ploop): out_p = x_sim @ Q(W; Δ_p)ᵀ
//   B4a ptq4vit_tpu/ops/pallas_search.py  linear_a_hessian_sims
//       (body _a_kernel_ploop): out_p = Q(x; Δ_p) @ w_simᵀ, Q signed or the
//       post-GELU twin Q⁺(x; Δ_p) + Q⁻(x; a_neg)
// with the same sims as B1 / B2, but every product is of the fp32
// fake-quant values, accumulated in fp32: the reference's own numerics,
// not the int8 levels rescaled once.  So they stay on the CUDA cores: the
// tensor cores have no exact fp32 mode (TF32 keeps 10 mantissa bits).
//
// Any element of Q(v; Δ) is level · Δ in fp32, so the levels come from the
// B1 / B2 pre-pass (one IEEE division per element and candidate) and a
// block multiplies each by its scale with one __fmul_rn (the twin adds
// lneg · a_neg with __fadd_rn) once per block and K chunk: the values of
// quantizing in place, with no division in the candidate loop.
//
// Design.  A block owns a 128 x 128 output tile and a group of candidates:
// the host's plan (ops/search_kernels.py ``fp32_plan``) splits the P
// candidates into groups so that the grid fills both block slots of each
// of the 132 SMs with a short wave tail (fill >= 97% at ViT-B/384's
// shapes; the first design's grid of tiles alone gave fc2 114 blocks for
// 132 SMs at one block an SM).  Each of the 256 threads keeps 8 x 8
// outputs, rows 4 ty + i and 64 + 4 ty + i, columns 4 tx + j and 64 + 4 tx
// + j, and runs every output's K chain in one thread in ascending k with
// __fmaf_rn, so each accumulator is bitwise what the first design (one
// block a tile walking all candidates) computed.  The (candidate, K chunk)
// steps of a block form one stream through a ring of S slots in dynamic
// shared memory, S - 1 steps ahead, across the candidate boundary:
//   - cp.async copies the fixed fp32 operand (B4w x_sim rows, B4a w_sim
//     rows) 4 bytes a thread straight into the k-major layout the FFMA
//     loop reads (conflict-free on both sides), and the raw level bytes
//     (and the twin's negative levels) 16 bytes a thread;
//   - each thread expands the level bytes it copied itself (so no barrier
//     stands between its cp.async.wait_group and the expansion) into one
//     of two k-major fp32 buffers, one step ahead of the products;
//   - one __syncthreads a 32-k chunk; four 16-byte shared loads feed 64
//     __fmaf_rn, the inner loop unrolled 8 k at a time.
// __launch_bounds__(256, 2): two blocks share an SM (128 registers, 12-52
// bytes of spill stores), so one block's barriers and epilogue run under
// the other's products.
//
// Epilogue, per candidate: raw and grad from global memory (16-byte loads
// where the row allows), e = g · (raw - acc), e · e summed per column over
// the thread's rows, then over the 16 thread rows, then over each bin's
// columns in ascending order -- the first design's order, so the sims are
// bitwise its sims -- into partial[(tile, p, bin)]; reduce_partials sums
// the tiles in a fixed order, in double.
//
// What bounds them: 2 P M K N fp32 FLOP a call (1.09e12 for fc1 at 4
// images: 16.25 ms at 67 TFLOP/s).  Measured (NVIDIA H100 80GB HBM3,
// 700.00 W; scripts/torch_search_probe.py b4, 4 images, P = 100): the
// kernel alone takes fc1 30.5 ms (B4w) and 29.9 (B4a), fc2 30.0 and 30.5,
// qkv 22.6 and 22.3 -- 53-55% of the fp32 peak, where the first design
// reached 40-47% (fc1 40.4 / 35.0 ms at one block an SM, 177 registers);
// cuBLAS SGEMM takes 26.3 ms for the same 100 fp32 products at fc1 (62%).
// What holds it there, by elimination (no profiler counters on the card):
// not the grid (fill >= 97%); not the thread tile's shared loads per FMA
// (the 16 x 8 build, a quarter fewer bytes a FMA at one block an SM and
// 231-255 registers, is 2-13% slower); the inner loop's unroll moved it
// most (at 4 x 8 warps, 32 k unrolled ran 7% and 4 k 5% slower than 8 k;
// 16 k within 1%).  What is left is the issue of the loop itself: per k,
// 64 FFMA beside four 16-byte shared loads, which alone take as many of
// the shared memory's 128-byte clocks as the FFMA take fp32 clocks, and
// the ring's copies and expansion.

// The measured choices: an 8 x 8 thread tile, warps of 2 x 16 threads,
// 8 k unrolled, two blocks an SM (PERF.md §6 keeps the times of the 16 x 8
// tile, the 4 x 8 warps and the other unrolls, which lost).
constexpr int FRM = 8;                  // output rows a thread
constexpr int FWR = 2;                  // thread rows a warp spans
constexpr int FWC = 32 / FWR;           // thread columns a warp spans
constexpr int FU = 8;                   // k steps unrolled
constexpr int FBM = 16 * FRM;           // output rows per block
constexpr int FBN = 128;                // output columns per block
constexpr int FKC = 32;                 // K chunk, = TK: level rows hold
                                        // whole chunks
constexpr int F_MAX_STAGES = 4;
constexpr size_t F_RED_BYTES = sizeof(float) * (16 + 1) * FBN;
constexpr int F_BLOCKS_PER_SM = 2;
constexpr size_t F_SMEM_LIMIT = 233472 / F_BLOCKS_PER_SM - 1024;

// rows of the fixed fp32 operand's tile (B4w: x_sim, the output rows;
// B4a: w_sim, the output columns) and of the level operand's
__host__ __device__ constexpr int f_rows(int kind) {
  return kind == 0 ? FBM : FBN;
}
__host__ __device__ constexpr int l_rows(int kind) {
  return kind == 0 ? FBN : FBM;
}
// a k-major fp32 tile of FKC x rows (+ 4 floats a row: conflict-free)
__host__ __device__ constexpr size_t f_tile_bytes(int rows) {
  return sizeof(float) * FKC * (rows + 4);
}
// the raw level bytes a ring slot holds (the twin's negative levels too)
__host__ __device__ constexpr size_t l_raw_bytes(int kind) {
  return (size_t)l_rows(kind) * FKC * (kind == 2 ? 2 : 1);
}

// Dynamic shared memory of one block (ops/search_kernels.py
// fp32_smem_bytes computes the same sum): S ring slots (the fixed tile,
// the raw levels, the twin's negative levels), two expanded level tiles,
// the epilogue's column sums.
size_t fp32_smem_bytes(int kind, int stages) {
  return (size_t)stages * (f_tile_bytes(f_rows(kind)) + l_raw_bytes(kind)) +
         2 * f_tile_bytes(l_rows(kind)) + F_RED_BYTES;
}

// B4w: KIND 0 (x_sim fixed, weight levels per candidate, Δ per row bin);
// B4a: KIND 1 signed, KIND 2 post-GELU twin (input levels per candidate,
// w_sim fixed).
struct Fp32Args {
  const float* fx;      // the fixed operand: B4w x_sim (M, K), B4a w_sim
                        // (N, K)
  const int8_t* lv;     // B4w: (P, N, Kp) weight levels; B4a: (P, M, Kp)
  const int8_t* lneg;   // B4a twin: (M, Kp) negative levels
  const float* cands;   // B4w (P, nV); B4a (P,)
  const float* raw;     // (M, N), bias subtracted
  const float* grad;    // (M, N)
  float a_neg;
  int M, N, K, Kp, P, nV, crb;
  int stages, pc, ngroups;  // ring slots; candidates a group; groups
  int ntm, ntn;             // row and column tiles
};

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's groups are in flight (n < 3)
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

template <int KIND>
__global__ void __launch_bounds__(NT, F_BLOCKS_PER_SM)
    fp32_scored_kernel(Fp32Args a, float* __restrict__ partial) {
  extern __shared__ __align__(16) uint8_t f_smem[];
  constexpr bool TWIN = KIND == 2;
  constexpr int FR = f_rows(KIND), LR = l_rows(KIND);
  constexpr int FLD = FR + 4, LLD = LR + 4;       // k-major row lengths
  constexpr int LDA = FBM + 4, LDB = FBN + 4;     // the A and B sides'
  constexpr size_t FIX_BYTES = f_tile_bytes(FR);
  constexpr size_t LV_BYTES = (size_t)LR * FKC;   // one level operand
  constexpr int LPIECES = LR / 128;   // 16-byte level pieces a thread
  const size_t slot_bytes = FIX_BYTES + l_raw_bytes(KIND);
  const int S = a.stages;
  uint8_t* ring = f_smem;
  float(*Lx)[FKC][LLD] = reinterpret_cast<float(*)[FKC][LLD]>(
      f_smem + (size_t)S * slot_bytes);
  float(*red)[FBN] = reinterpret_cast<float(*)[FBN]>(
      f_smem + (size_t)S * slot_bytes + 2 * f_tile_bytes(LR));
  float* colred = &red[16][0];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this thread's place in the 16 x 16 thread grid: a warp spans FWR
  // thread rows and FWC columns
  const int ty = FWR * (warp / (16 / FWC)) + lane / FWC;
  const int tx = FWC * (warp % (16 / FWC)) + lane % FWC;
  // block -> (tile, candidate group); the blocks that run together share
  // the candidate operand: B4w row tiles fastest, B4a column tiles
  int mt, nt, g;
  if (KIND == 0) {
    mt = blockIdx.x % a.ntm;
    g = (blockIdx.x / a.ntm) % a.ngroups;
    nt = blockIdx.x / (a.ntm * a.ngroups);
  } else {
    nt = blockIdx.x % a.ntn;
    g = (blockIdx.x / a.ntn) % a.ngroups;
    mt = blockIdx.x / (a.ntn * a.ngroups);
  }
  const int m0 = mt * FBM, n0 = nt * FBN;
  const int tile = mt * a.ntn + nt;
  const int p0 = g * a.pc;
  const int npc = min(a.pc, a.P - p0);
  const int M = a.M, N = a.N;
  const int nch = a.Kp / FKC;
  const int nsteps = npc * nch;
  const int nbins = KIND == 0 ? a.nV : 1;

  // the fixed operand's rows and the level operand's
  const int frow0 = KIND == 0 ? m0 : n0, frows = KIND == 0 ? M : N;
  const int lrow0 = KIND == 0 ? n0 : m0, lrows = KIND == 0 ? N : M;
  // this thread's level row (its 16-byte pieces: halves lh of the chunk,
  // piece q at lh = (256 q + tid) / LR), and its scale bin
  const int lr = tid % LR;
  const bool lr_ok = lrow0 + lr < lrows;
  const int lbin = KIND == 0 ? min(lrow0 + lr, N - 1) / a.crb : 0;
  // this thread's fixed-operand copies: rows 32 i + fr, k 8 j + fk
  const int fr = 4 * warp + (lane & 3), fk = lane >> 2;

  auto issue = [&](int t) {
    if (t < nsteps) {
      const int s = t % S, p = p0 + t / nch, k0 = (t % nch) * FKC;
      const uint32_t sb = smem_u32(ring + (size_t)s * slot_bytes);
#pragma unroll
      for (int i = 0; i < FR / 32; ++i) {
        const int row = frow0 + 32 * i + fr;
        const bool rok = row < frows;
        const float* src = a.fx + (size_t)(rok ? row : 0) * a.K;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = k0 + 8 * j + fk;
          const bool ok = rok && k < a.K;
          cp_async4(sb + (uint32_t)(sizeof(float) *
                                    ((8 * j + fk) * FLD + 32 * i + fr)),
                    src + (ok ? k : 0), ok);
        }
      }
      const int8_t* lsrc = a.lv + (size_t)p * lrows * a.Kp;
      const size_t lrow = (size_t)(lr_ok ? lrow0 + lr : 0) * a.Kp + k0;
#pragma unroll
      for (int q = 0; q < LPIECES; ++q) {
        const int lh = (256 * q + tid) / LR;
        const uint32_t ld = sb + (uint32_t)(FIX_BYTES + 16 * (lh * LR + lr));
        cp_async16(ld, lsrc + lrow + 16 * lh, lr_ok);
        if (TWIN)
          cp_async16(ld + (uint32_t)LV_BYTES, a.lneg + lrow + 16 * lh,
                     lr_ok);
      }
    }
    cp_async_commit();   // an empty group past the end keeps the count
  };

  // the levels this thread copied for step t -> Lx[t & 1], k-major, each
  // as level · Δ [+ lneg · a_neg]
  auto expand = [&](int t) {
    const int s = t % S, p = p0 + t / nch;
    const float lsc = a.cands[KIND == 0 ? p * a.nV + lbin : p];
    float(*dst)[LLD] = Lx[t & 1];
#pragma unroll
    for (int q = 0; q < LPIECES; ++q) {
      const int lh = (256 * q + tid) / LR;
      const uint8_t* sb = ring + (size_t)s * slot_bytes + FIX_BYTES +
                          16 * (lh * LR + lr);
      const int4 w = *reinterpret_cast<const int4*>(sb);
      int4 wn = make_int4(0, 0, 0, 0);
      if (TWIN) wn = *reinterpret_cast<const int4*>(sb + LV_BYTES);
      const int wv[4] = {w.x, w.y, w.z, w.w};
      const int wnv[4] = {wn.x, wn.y, wn.z, wn.w};
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int sh = 8 * (i & 3);
        float v = __fmul_rn(__int2float_rn((int8_t)(wv[i >> 2] >> sh)), lsc);
        if (TWIN)
          v = __fadd_rn(v, __fmul_rn(__int2float_rn((int8_t)(wnv[i >> 2] >>
                                                             sh)),
                                     a.a_neg));
        dst[16 * lh + i][lr] = v;
      }
    }
  };

  for (int t = 0; t < S - 1; ++t) issue(t);
  cp_async_wait(S - 2);
  expand(0);
  __syncthreads();

  // output (i, j) of this thread: row 64 (i / 4) + 4 ty + i % 4, column
  // 64 (j / 4) + 4 tx + j % 4 of the tile
  float acc[FRM][8];
  for (int t = 0; t < nsteps; ++t) {
    const int c = t % nch;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < FRM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    issue(t + S - 1);
    {
      uint8_t* fs = ring + (size_t)(t % S) * slot_bytes;
      float(*As)[LDA] = reinterpret_cast<float(*)[LDA]>(
          KIND == 0 ? fs : reinterpret_cast<uint8_t*>(Lx[t & 1]));
      float(*Bs)[LDB] = reinterpret_cast<float(*)[LDB]>(
          KIND == 0 ? reinterpret_cast<uint8_t*>(Lx[t & 1]) : fs);
#pragma unroll 1
      for (int k0 = 0; k0 < FKC; k0 += FU)
#pragma unroll
      for (int u = 0; u < FU; ++u) {
        const int kk = k0 + u;
        float ar[FRM];
#pragma unroll
        for (int h = 0; h < FRM / 4; ++h) {
          const float4 v =
              *reinterpret_cast<const float4*>(&As[kk][64 * h + 4 * ty]);
          ar[4 * h] = v.x; ar[4 * h + 1] = v.y;
          ar[4 * h + 2] = v.z; ar[4 * h + 3] = v.w;
        }
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][4 * tx]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&Bs[kk][64 + 4 * tx]);
        const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < FRM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = __fmaf_rn(ar[i], br[j], acc[i][j]);
      }
    }
    // step t + 1's copies (this thread's) have landed; its levels go to
    // the expanded buffer step t - 1 read, which every thread has left
    cp_async_wait(S - 2);
    if (t + 1 < nsteps) expand(t + 1);
    __syncthreads();
    if (c + 1 < nch) continue;

    // ---- epilogue of candidate p ----
    const int p = p0 + t / nch;
    float colsum[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) colsum[j] = 0.f;
    const bool vec = (N & 3) == 0 &&
                     (((uintptr_t)a.raw | (uintptr_t)a.grad) & 15) == 0;
#pragma unroll
    for (int i = 0; i < FRM; ++i) {
      const int m = m0 + 64 * (i / 4) + 4 * ty + i % 4;
      if (m >= M) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int nb = n0 + 64 * h + 4 * tx;
        const size_t o = (size_t)m * N + nb;
        float rv[4], gv[4];
        if (vec && nb + 4 <= N) {
          const float4 r4 = *reinterpret_cast<const float4*>(a.raw + o);
          const float4 g4 = *reinterpret_cast<const float4*>(a.grad + o);
          rv[0] = r4.x; rv[1] = r4.y; rv[2] = r4.z; rv[3] = r4.w;
          gv[0] = g4.x; gv[1] = g4.y; gv[2] = g4.z; gv[3] = g4.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            rv[j] = nb + j < N ? a.raw[o + j] : 0.f;
            gv[j] = nb + j < N ? a.grad[o + j] : 0.f;
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (nb + j < N) {
            const float e = __fmul_rn(gv[j], __fsub_rn(rv[j],
                                                       acc[i][4 * h + j]));
            colsum[4 * h + j] = __fadd_rn(colsum[4 * h + j], __fmul_rn(e, e));
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      red[ty][64 * (j / 4) + 4 * tx + j % 4] = colsum[j];
    __syncthreads();
    if (tid < FBN) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < 16; ++r) s = __fadd_rn(s, red[r][tid]);
      colred[tid] = s;
    }
    __syncthreads();
    if (tid < nbins) {
      // bin tid's columns of this tile, in ascending order
      const int c0 = KIND == 0 ? max(tid * a.crb - n0, 0) : 0;
      const int c1 = min(KIND == 0 ? (tid + 1) * a.crb - n0 : FBN,
                         min(FBN, N - n0));
      float s = 0.f;
      for (int col = c0; col < c1; ++col) s = __fadd_rn(s, colred[col]);
      partial[((size_t)tile * a.P + p) * nbins + tid] = s;
    }
    // red / colred are rewritten only after the next candidate's last
    // chunk, whose barrier orders those writes after the reads above
  }
  cp_async_wait(0);
}

template <int KIND>
int launch_fp32(const Fp32Args& a, float* partial, float* out,
                cudaStream_t st) {
  const size_t smem = fp32_smem_bytes(KIND, a.stages);
  if (a.stages < 2 || a.stages > F_MAX_STAGES || smem > F_SMEM_LIMIT ||
      a.pc < 1 || a.ngroups != cdiv(a.P, a.pc))
    return kErrSmem;
  auto kern = fp32_scored_kernel<KIND>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = a.ntm * a.ntn;
  kern<<<ntiles * a.ngroups, NT, smem, st>>>(a, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nbins = KIND == 0 ? a.nV : 1;
  const int total = a.P * nbins;
  reduce_partials<<<cdiv(total, 128), 128, 0, st>>>(partial, out, 1, ntiles,
                                                    a.P, nbins);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K rounded up to the level buffers' row length.
int ptq_k_pad(int K) { return kpad(K); }

// B1 / B2: blocks (and partial sums per candidate and bin) of a call.
int ptq_linear_num_partials(int M, int N) {
  return cdiv(M, LQ_ROWS) * cdiv(N, LQ_ROWS);
}

// B1 / B2: dynamic shared memory of a block under a plan (nl fixed tiles
// of K columns, resident or streamed, stages ring slots, pc candidates a
// launch, nbl row-block bins a block).
int ptq_linear_smem_bytes(int nl, int K, int resident, int stages, int pc,
                          int nbl) {
  return (int)lin_smem_bytes(nl, cdiv(kpad(K), LQ_KC), resident, stages, pc,
                             nbl);
}

// B1.  x_lv, xn_lv (M, K) int8 (xn_lv NULL unless post-GELU twin);
// w (N, K) f32; cands (P, nV); raw, grad (M, N) f32 -> out (P, nV).
// Plan (ops/search_kernels.py linear_plan): resident, stages, pc, nbl.
// Scratch: lx, lxn (M, Kp) int8 (lxn NULL unless twin), lw (P, N, Kp);
// partial ptq_linear_num_partials(M, N) * P * nV floats.
int ptq_linear_w_sims(const int8_t* x_lv, const int8_t* xn_lv, const float* w,
                      const float* cands, const float* raw, const float* grad,
                      float a, float a_neg, int M, int K, int N, int P, int nV,
                      int qmax, int resident, int stages, int pc, int nbl,
                      int8_t* lx, int8_t* lxn, int8_t* lw, float* partial,
                      float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int Kp = kpad(K), crb = N / nV;
  CopyLevels cx{x_lv, K};
  int err = fill_levels(cx, lx, 1, 1, M, K, st);
  if (err) return err;
  if (xn_lv != nullptr) {
    CopyLevels cn{xn_lv, K};
    err = fill_levels(cn, lxn, 1, 1, M, K, st);
    if (err) return err;
  }
  WeightLevels wl{w, cands, K, nV, crb, qmax};
  err = fill_levels(wl, lw, P, 1, N, K, st);
  if (err) return err;
  CUtensorMap maps[4];
  if ((err = level_map(&maps[0], lx, Kp, M, 1, LQ_ROWS))) return err;
  if ((err = level_map(&maps[1], xn_lv != nullptr ? lxn : lx, Kp, M, 1,
                       LQ_ROWS)))
    return err;
  if ((err = level_map(&maps[2], lw, Kp, N, P, LQ_ROWS))) return err;
  maps[3] = maps[2];
  const LinArgs la = lin_args(0, raw, grad, cands, nullptr, a, a_neg, M, K,
                              N, P, nV, resident, stages, nbl);
  if (xn_lv != nullptr)
    return launch_linear_tc<0, 2, false>(maps, la, pc, partial, out, st);
  return launch_linear_tc<0, 1, false>(maps, la, pc, partial, out, st);
}

// B2.  x (M, K) f32; w_lv (N, K) int8; w_scale (N,); cands (P,);
// raw, grad (M, N) f32 -> out (P,).  Plan as B1 (nbl 1).
// Scratch: lx (P, M, Kp) int8, lneg (M, Kp) (NULL unless post-GELU),
// lw (N, Kp); partial ptq_linear_num_partials(M, N) * P floats.
int ptq_linear_a_sims(const float* x, const int8_t* w_lv, const float* w_scale,
                      const float* cands, const float* raw, const float* grad,
                      float a_neg, int M, int K, int N, int P, int qmax,
                      int postgelu, int resident, int stages, int pc,
                      int8_t* lx, int8_t* lneg, int8_t* lw, float* partial,
                      float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int Kp = kpad(K);
  InputLevels il{x, cands, a_neg, K, postgelu ? 0 : -qmax, qmax - 1, 0};
  int err = fill_levels(il, lx, P, 1, M, K, st);
  if (err) return err;
  if (postgelu) {
    InputLevels nl{x, cands, a_neg, K, -qmax, 0, 1};
    err = fill_levels(nl, lneg, 1, 1, M, K, st);
    if (err) return err;
  }
  CopyLevels cw{w_lv, K};
  err = fill_levels(cw, lw, 1, 1, N, K, st);
  if (err) return err;
  CUtensorMap maps[4];
  if ((err = level_map(&maps[0], lw, Kp, N, 1, LQ_ROWS))) return err;
  maps[1] = maps[0];
  if ((err = level_map(&maps[2], lx, Kp, M, P, LQ_ROWS))) return err;
  if (postgelu) {
    if ((err = level_map(&maps[3], lneg, Kp, M, 1, LQ_ROWS))) return err;
  } else {
    maps[3] = maps[2];
  }
  const LinArgs la = lin_args(1, raw, grad, cands, w_scale, 0.f, a_neg, M,
                              K, N, P, 1, resident, stages, 1);
  if (postgelu)
    return launch_linear_tc<1, 1, true>(maps, la, pc, partial, out, st);
  return launch_linear_tc<1, 1, false>(maps, la, pc, partial, out, st);
}

// B4w / B4a: blocks of a call's tiles (and partial sums per candidate and
// bin; the grid is this times the candidate groups).
int ptq_fp32_num_partials(int M, int N) { return cdiv(M, FBM) * cdiv(N, FBN); }

// B4w / B4a: dynamic shared memory of a block under a plan (kind 0 B4w,
// 1 B4a signed, 2 B4a post-GELU; stages ring slots).
int ptq_fp32_smem_bytes(int kind, int stages) {
  return (int)fp32_smem_bytes(kind, stages);
}

// B4w.  x_sim (M, K) f32; w (N, K) f32; cands (P, nV); raw, grad (M, N)
// f32 -> out (P, nV).  Plan (ops/search_kernels.py fp32_plan): stages
// ring slots, pc candidates a group.  Scratch: lw (P, N, Kp) int8;
// partial ptq_fp32_num_partials(M, N) * P * nV floats.
int ptq_linear_w_sims_f32(const float* x_sim, const float* w,
                          const float* cands, const float* raw,
                          const float* grad, int M, int K, int N, int P,
                          int nV, int qmax, int stages, int pc, int8_t* lw,
                          float* partial, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int crb = N / nV;
  WeightLevels wl{w, cands, K, nV, crb, qmax};
  int err = fill_levels(wl, lw, P, 1, N, K, st);
  if (err) return err;
  Fp32Args a{x_sim, lw, nullptr, cands, raw, grad, 0.f,
             M, N, K, kpad(K), P, nV, crb,
             stages, pc, cdiv(P, pc), cdiv(M, FBM), cdiv(N, FBN)};
  return launch_fp32<0>(a, partial, out, st);
}

// B4a.  x (M, K) f32 raw; w_sim (N, K) f32; cands (P,); raw, grad (M, N)
// f32 -> out (P,).  Plan as B4w.  Scratch: lx (P, M, Kp) int8, lneg
// (M, Kp) (NULL unless post-GELU); partial ptq_fp32_num_partials(M, N) * P
// floats.
int ptq_linear_a_sims_f32(const float* x, const float* w_sim,
                          const float* cands, const float* raw,
                          const float* grad, float a_neg, int M, int K,
                          int N, int P, int qmax, int postgelu, int stages,
                          int pc, int8_t* lx, int8_t* lneg, float* partial,
                          float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  InputLevels il{x, cands, a_neg, K, postgelu ? 0 : -qmax, qmax - 1, 0};
  int err = fill_levels(il, lx, P, 1, M, K, st);
  if (err) return err;
  if (postgelu) {
    InputLevels nl{x, cands, a_neg, K, -qmax, 0, 1};
    err = fill_levels(nl, lneg, 1, 1, M, K, st);
    if (err) return err;
  }
  Fp32Args a{w_sim, lx, lneg, cands, raw, grad, a_neg,
             M, N, K, kpad(K), P, 1, N,
             stages, pc, cdiv(P, pc), cdiv(M, FBM), cdiv(N, FBN)};
  return postgelu ? launch_fp32<2>(a, partial, out, st)
                  : launch_fp32<1>(a, partial, out, st);
}

// B3 / B3f: the column width of a block's output tile; the per-warp
// partial sums of a call per head and candidate (the wrapper sizes the
// partial scratch as this times G * P floats); a block's dynamic shared
// memory with a ring of `stages` slots (mode 0 "a", 1 "b", 2 "b_sos").
int ptq_mm_width(int Co) { return mm_width(Co); }

int ptq_mm_num_partials(int S, int R, int Co) {
  return S * cdiv(R, MM_ROWS) * cdiv(Co, mm_width(Co)) * MM_CWARPS;
}

int ptq_mm_smem_bytes(int mode, int Ci, int Co, int stages) {
  return (int)mm_smem_bytes(mode, Ci, mm_width(Co), stages);
}

// B3 and B3f.  A (S, G, R, Ci), B (S, G, Ci, Co), grad (S, G, R, Co), all
// f32 (bf16 = 0) or all bf16 (bf16 = 1); cands (P, G); fixed_int (G,);
// mode 0 "a", 1 "b", 2 "b_sos" -> out (P, G).  Plan
// (ops/search_kernels.py matmul_plan): stages ring slots.
// Scratch (Z = G * S): la (P, Z, R, Kp) in mode 0, else (Z, R, Kp);
// la2 (Z, R, Kp) in mode 2, else NULL; lb (Z, Co, Kp) in mode 0, else
// (P, Z, Co, Kp); partial ptq_mm_num_partials(S, R, Co) * G * P floats.
int ptq_matmul_sims(const void* A, const void* B, const void* grad, int bf16,
                    const float* cands, const float* fixed_int, float split,
                    float a_int, float s_hi, float s_lo, int S, int G, int R,
                    int Ci, int Co, int P, int mode, int cand_qmax,
                    int fixed_qmax, int stages, int8_t* la, int8_t* la2,
                    int8_t* lb, float* partial, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int W = mm_width(Co), Z = S * G, Kp = kpad(Ci);
  const size_t smem = mm_smem_bytes(mode, Ci, W, stages);
  if (stages < 2 * cdiv(Kp, LQ_KC) || stages > MM_MAX_STAGES ||
      smem > LQ_SMEM_LIMIT)
    return kErrSmem;     // two candidates' chunks must fit the ring
  int err;
#define PTQ_FILL(T, MODE)                                                    \
  err = fill_mm_levels<T, MODE>(A, B, cands, fixed_int, split, a_int, S, G, \
                                R, Ci, Co, P, cand_qmax, fixed_qmax, la,    \
                                la2, lb, st)
  if (bf16) {
    if (mode == 0) PTQ_FILL(__nv_bfloat16, 0);
    else if (mode == 1) PTQ_FILL(__nv_bfloat16, 1);
    else PTQ_FILL(__nv_bfloat16, 2);
  } else {
    if (mode == 0) PTQ_FILL(float, 0);
    else if (mode == 1) PTQ_FILL(float, 1);
    else PTQ_FILL(float, 2);
  }
#undef PTQ_FILL
  if (err) return err;
  // maps: the candidate levels (planes p * Z + z), the fixed tile(s)
  CUtensorMap maps[3];
  if (mode == 0) {
    if ((err = level_map(&maps[0], la, Kp, R, P * Z, MM_ROWS))) return err;
    if ((err = level_map(&maps[1], lb, Kp, Co, Z, W))) return err;
    maps[2] = maps[1];
  } else {
    if ((err = level_map(&maps[0], lb, Kp, Co, P * Z, W))) return err;
    if ((err = level_map(&maps[1], la, Kp, R, Z, MM_ROWS))) return err;
    if (mode == 2) {
      if ((err = level_map(&maps[2], la2, Kp, R, Z, MM_ROWS))) return err;
    } else {
      maps[2] = maps[1];
    }
  }
  MmArgs a;
  a.A = A; a.B = B; a.grad = grad; a.cands = cands; a.fixed_int = fixed_int;
  a.s_hi = s_hi; a.s_lo = s_lo; a.bf16 = bf16;
  a.S = S; a.G = G; a.R = R; a.Ci = Ci; a.Co = Co; a.P = P;
  a.cand_on_a = mode == 0;
  a.NC = cdiv(Kp, LQ_KC);
  a.stages = stages; a.nrt = cdiv(R, MM_ROWS); a.nct = cdiv(Co, W);
  const int sos = mode == 2, ks_last = (Kp - (a.NC - 1) * LQ_KC) / 32;
  if (W == 32)
    return launch_mm_width<32>(maps, a, sos, ks_last, smem, partial, out,
                               st);
  if (W == 48)
    return launch_mm_width<48>(maps, a, sos, ks_last, smem, partial, out,
                               st);
  return launch_mm_width<64>(maps, a, sos, ks_last, smem, partial, out, st);
}

}  // extern "C"
