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
//       shapes of Swin (see the B3f section below)
//   B4w, B4a  the fp32-scored (exact) twins of B1 and B2 (see their
//       section at the end)
//
// B1-B3f score P candidate scales Δ_p with the hessian similarity
//     sims[p] = -Σ (g · (raw - out_p))²
// where out_p is an int8 x int8 -> int32 product of quantization levels
// rescaled once in fp32.  Each call runs three kernels:
//
//   levels_kernel       quantizes each operand to int8 levels once (per
//                       candidate for the searched operand) into K-padded
//                       rows, one IEEE division per element;
//   a scored GEMM       the products of every candidate, the fp32 rescale
//                       and the squared errors, summed per block;
//   reduce_partials     sums the per-block partials in a fixed order.
//
// B1 and B2 (linear_tc_kernel, section at the end) run their products on
// the int8 tensor cores: wgmma m64n64k32 s8 x s8 -> s32 from shared
// memory, fed by TMA through a ring of mbarrier-guarded slots by a
// producer warp, with the operand no candidate changes resident in shared
// memory where it fits, two blocks an SM.  Their work is 2 P M K N int8
// operations a call (1.09e12 for fc1 at 4 images: 0.55 ms at 1,979 TOPS);
// they reach about a fifth of that rate.  What holds them there: a block
// runs each candidate's products and then its epilogue -- one int32 ->
// fp32 conversion (a quarter-rate instruction) and five fp32 operations
// per output -- in turn, and only the SM's second block fills the gap
// (one warpgroup a block measured 15% faster than two sharing one ring:
// those ran their epilogues in lockstep); each candidate's 64-row tile
// comes from L2 once per block; and the level pre-pass (an IEEE division
// per level) is 13-36% of a call.  Their first design ran __dp4a on
// the CUDA cores at 2-3% of the int8 peak, re-streamed the fixed operand
// for every candidate and reduced every candidate across the block, and
// B1's block order streamed the per-candidate weight levels once per row
// tile.
//
// B3 (scored_gemm_kernel) keeps that first design: a block owns a 64 x 64
// output tile of one (head, sample), keeps raw and grad of its tile in
// registers and loops over all P candidates: 16-byte loads of the level
// tiles into shared memory, __dp4a products with an exact int32
// accumulate, the fp32 rescale and the squared error, summed per column.
// Quantizing inside the candidate loop would make every row tile repeat
// the same divisions (they bounded the kernels on the card); the pre-pass
// does each once.  B3 and B3f on the tensor cores are later work; B4w and
// B4a stay on the fp32 CUDA cores by their exact-scoring contract (their
// section, at the end).
//
// Determinism.  The TPU kernel sums across sequential grid steps; Hopper
// blocks run in no order, so every block writes its partial sums to a
// (blocks, P, bins) scratch buffer and reduce_partials sums them in a fixed
// order (in double).  No atomics: the sims are the same from run to run.
//
// Numerics.  The elementwise part is bitwise equal to the plain PyTorch
// version: __fdiv_rn divisions, rintf (round half to even) levels, and the
// TPU kernels' rescale order with __fmul_rn / __fadd_rn, so no FMA
// contraction changes a rounding (the build also passes --fmad=false).
// The int32 accumulate is exact in any order; only the order of the final
// fp32 sums differs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;        // output rows per block
constexpr int TN = 64;        // output columns per block
constexpr int TK = 32;        // K bytes per shared-memory chunk (K pad unit)
constexpr int TKW = TK / 4;   // K words per chunk
constexpr int NT = 256;       // 16 x 16 threads, 4 x 4 outputs each

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

// B3 operands.  z = g * S + s indexes (head, sample); which = 0: A rows
// (R, Ci) as they are, 1: B transposed to (Co, Ci).
// kind 0: candidate scale cands[p, g]; 1: fixed scale fixed[g];
// 2: SoS high level; 3: SoS low level.
template <class T>
struct MatmulLevels {
  const T* X;
  const float* cands;  // (P, G)
  const float* fixed;  // (G,)
  float split, a_int;
  int S, G, R, Ci, Co, which, kind, qmax;
  __device__ int8_t level(int p, int z, int r, int k) const {
    const int g = z / S;
    const size_t sg = (size_t)(z % S) * G + g;
    const float v = which == 0 ? to_f(X[(sg * R + r) * Ci + k])
                               : to_f(X[(sg * Ci + k) * Co + r]);
    if (kind == 0) return qlevel(v, cands[p * G + g], -qmax, qmax - 1);
    if (kind == 1) return qlevel(v, fixed[g], -qmax, qmax - 1);
    if (kind == 2)
      return clamp_level(
          rintf(__fmul_rn(fminf(fmaxf(v, split), 1.f), (float)(qmax - 1))),
          0, qmax - 1);
    return clamp_level(rintf(__fdiv_rn(fminf(fmaxf(v, 0.f), split), a_int)),
                       0, qmax - 1);
  }
};

// ---------------------------------------------------------------------------
// B3: scored GEMM over pre-quantized levels
// ---------------------------------------------------------------------------

// Level buffers, K-padded rows of Kp bytes.  Element strides per candidate
// (0: the operand is fixed) and per z (0: shared by every z).
struct Levels {
  const int8_t* L0;
  const int8_t* L1;    // second left operand (SoS), or null
  const int8_t* R;
  long long L0p, Rp, Lz, Rz;  // L1 is fixed: no candidate stride
  int Kp;
};

// Defaults every epilogue may override.
struct OpBase {
  static constexpr bool kRawProduct = false;  // raw = A @ B in the block
  __device__ void bind(int) {}
  __device__ float rawA(int, int) const { return 0.f; }
  __device__ float rawB(int, int) const { return 0.f; }
  __device__ float raw(int, int) const { return 0.f; }
  __device__ float gprep(float g) const { return g; }
};

// B3 / B3f squared error of one output.  MODE 0 ("a"): candidates on A;
// 1 ("b"): on B; 2 ("b_sos"): on B with the softmax side as SoS hi/lo
// levels.  d = cands[p, g], f = fixed_int[g].
template <int MODE>
__device__ __forceinline__ float mm_term(int acc0, int acc1, float d,
                                         float f, float s_hi, float s_lo,
                                         float r, float g2) {
  float out;
  if (MODE == 0) {
    out = __fmul_rn(__int2float_rn(acc0), __fmul_rn(d, f));
  } else if (MODE == 1) {
    out = __fmul_rn(__int2float_rn(acc0), __fmul_rn(f, d));
  } else {
    out = __fmul_rn(__fadd_rn(__fmul_rn(__int2float_rn(acc0), s_hi),
                              __fmul_rn(__int2float_rn(acc1), s_lo)),
                    d);
  }
  const float diff = __fsub_rn(r, out);
  return __fmul_rn(__fmul_rn(g2, diff), diff);
}

// B3 epilogue; raw = A @ B in fp32.
template <class T, int MODE>
struct MatmulOp : OpBase {
  static constexpr int NL = MODE == 2 ? 2 : 1;
  static constexpr bool kRawProduct = true;
  const T* A;
  const T* B;
  const T* Gr;
  const float* cands;      // (P, G)
  const float* fixed_int;  // (G,)
  float s_hi, s_lo;
  int S, Gh;
  int M, N, K, P, nbins;
  int g;
  const T* Ab;
  const T* Bb;
  const T* Gb;

  __device__ void bind(int z) {
    g = z / S;
    const size_t sg = (size_t)(z % S) * Gh + g;
    Ab = A + sg * M * K;
    Bb = B + sg * K * N;
    Gb = Gr + sg * M * N;
  }
  __device__ float rawA(int m, int k) const {
    return to_f(Ab[(size_t)m * K + k]);
  }
  __device__ float rawB(int k, int n) const {
    return to_f(Bb[(size_t)k * N + n]);
  }
  __device__ float grad(int m, int n) const {
    return to_f(Gb[(size_t)m * N + n]);
  }
  __device__ float gprep(float v) const { return __fmul_rn(v, v); }
  __device__ float term(int p, int, int acc0, int acc1, float, float r,
                        float g2) const {
    return mm_term<MODE>(acc0, acc1, cands[p * Gh + g], fixed_int[g], s_hi,
                         s_lo, r, g2);
  }
  __device__ int bin(int) const { return 0; }
};

__device__ __forceinline__ void store_words(int* dst, int4 v) {
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// acc[l] = L_l tile @ R tileᵀ over all of Kp for candidate p.  Threads
// 0-127 load the left tile(s), 128-255 the right tile, 16 bytes each.
template <int NL>
__device__ __forceinline__ void dot_tiles(const Levels& lev, int p, int z,
                                          int M, int N, int m0, int n0,
                                          int (*Ls)[TM][TKW + 1],
                                          int (*Rs)[TKW + 1],
                                          int (&acc)[NL][4][4]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nl = NL;
  const int8_t* lb[2];
  lb[0] = lev.L0 + (size_t)p * lev.L0p + (size_t)z * lev.Lz;
  lb[1] = NL > 1 ? lev.L1 + (size_t)z * lev.Lz : lb[0];
  const int8_t* rb = lev.R + (size_t)p * lev.Rp + (size_t)z * lev.Rz;
#pragma unroll
  for (int l = 0; l < NL; ++l)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[l][i][j] = 0;

  const int row = (tid & 127) >> 1, half = tid & 1;
  const int4 zero = make_int4(0, 0, 0, 0);
  for (int k0 = 0; k0 < lev.Kp; k0 += TK) {
    if (tid < 128) {
      const int m = m0 + row;
      for (int l = 0; l < nl; ++l) {
        const int4 v = m < M ? *reinterpret_cast<const int4*>(
                                   lb[l] + (size_t)m * lev.Kp + k0 + half * 16)
                             : zero;
        store_words(&Ls[l][row][half * 4], v);
      }
    } else {
      const int n = n0 + row;
      const int4 v = n < N ? *reinterpret_cast<const int4*>(
                                 rb + (size_t)n * lev.Kp + k0 + half * 16)
                           : zero;
      store_words(&Rs[row][half * 4], v);
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < TKW; ++kw) {
      int bw[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bw[j] = Rs[tx + 16 * j][kw];
      for (int l = 0; l < nl; ++l) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int aw = Ls[l][ty + 16 * i][kw];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[l][i][j] = __dp4a(aw, bw[j], acc[l][i][j]);
        }
      }
    }
    __syncthreads();
  }
}

template <class Op>
__global__ void __launch_bounds__(NT)
    scored_gemm_kernel(Op op, Levels lev, float* __restrict__ partial) {
  Op o = op;
  const int z = blockIdx.z;
  o.bind(z);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
  const int nb = gridDim.x * gridDim.y;
  const int b = blockIdx.y * gridDim.x + blockIdx.x;

  __shared__ int Ls[Op::NL][TM][TKW + 1];
  __shared__ int Rs[TN][TKW + 1];
  __shared__ float red[16][TN];
  __shared__ float colred[TN];

  float rawv[4][4], gv[4][4];
  if (Op::kRawProduct) {
    // raw = A @ B in fp32 for this tile, computed once per call
    __shared__ float As[TM][TK + 1];
    __shared__ float Bs[TK][TN + 1];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) rawv[i][j] = 0.f;
    for (int k0 = 0; k0 < o.K; k0 += TK) {
      for (int idx = tid; idx < TM * TK; idx += NT) {
        const int mm = idx / TK, kk = idx % TK, m = m0 + mm, k = k0 + kk;
        As[mm][kk] = (m < o.M && k < o.K) ? o.rawA(m, k) : 0.f;
      }
      for (int idx = tid; idx < TK * TN; idx += NT) {
        const int kk = idx / TN, nn = idx % TN, k = k0 + kk, n = n0 + nn;
        Bs[kk][nn] = (n < o.N && k < o.K) ? o.rawB(k, n) : 0.f;
      }
      __syncthreads();
      for (int kk = 0; kk < TK; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[ty + 16 * i][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            rawv[i][j] = __fmaf_rn(av[i], bv[j], rawv[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      const bool ok = m < o.M && n < o.N;
      if (!Op::kRawProduct) rawv[i][j] = ok ? o.raw(m, n) : 0.f;
      gv[i][j] = ok ? o.gprep(o.grad(m, n)) : 0.f;
    }
  }

  int acc[Op::NL][4][4];
  for (int p = 0; p < o.P; ++p) {
    dot_tiles<Op::NL>(lev, p, z, o.M, o.N, m0, n0, Ls, Rs, acc);
    float colsum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
        if (m < o.M && n < o.N)
          colsum[j] = __fadd_rn(
              colsum[j], o.term(p, n, acc[0][i][j],
                                Op::NL > 1 ? acc[Op::NL - 1][i][j] : 0,
                                0.f, rawv[i][j], gv[i][j]));
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) red[ty][tx + 16 * j] = colsum[j];
    __syncthreads();
    if (tid < TN) {
      float s = 0.f;
      for (int r = 0; r < 16; ++r) s = __fadd_rn(s, red[r][tid]);
      colred[tid] = s;
    }
    __syncthreads();
    if (tid < o.nbins) {
      float s = 0.f;
      for (int c = 0; c < TN; ++c) {
        const int n = n0 + c;
        if (n < o.N && o.bin(n) == tid) s = __fadd_rn(s, colred[c]);
      }
      partial[(((size_t)z * nb + b) * o.P + p) * o.nbins + tid] = s;
    }
    // red/colred are rewritten only after the next dot_tiles, whose
    // __syncthreads orders those writes after the reads above
  }
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

int cdiv(int a, int b) { return (a + b - 1) / b; }
int kpad(int K) { return cdiv(K, TK) * TK; }

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

template <class Op>
int launch(const Op& op, const Levels& lev, int M, int N, int Z, int ngroups,
           int P, int nbins, float* partial, float* out, cudaStream_t st) {
  dim3 grid(cdiv(N, TN), cdiv(M, TM), Z);
  scored_gemm_kernel<Op><<<grid, NT, 0, st>>>(op, lev, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nper = (int)(grid.x * grid.y) * (Z / ngroups);
  const int total = P * ngroups * nbins;
  reduce_partials<<<cdiv(total, 128), 128, 0, st>>>(partial, out, ngroups,
                                                   nper, P, nbins);
  return (int)cudaGetLastError();
}

// Fills the level buffers of a B3 / B3f call: la (P | 1, Z, R, Kp) and
// la2 (Z, R, Kp) from A, lb (1 | P, Z, Co, Kp) from B transposed.
template <class T, int MODE>
int fill_mm_levels(const void* A, const void* B, const float* cands,
                   const float* fixed_int, float split, float a_int, int S,
                   int G, int R, int Ci, int Co, int P, int cq, int fq,
                   int8_t* la, int8_t* la2, int8_t* lb, cudaStream_t st) {
  const int Z = G * S;
  MatmulLevels<T> src;
  src.cands = cands; src.fixed = fixed_int; src.split = split;
  src.a_int = a_int; src.S = S; src.G = G; src.R = R; src.Ci = Ci;
  src.Co = Co;
  // left operand: A rows
  src.X = (const T*)A; src.which = 0;
  src.kind = MODE == 0 ? 0 : (MODE == 1 ? 1 : 2);
  src.qmax = MODE == 0 ? cq : fq;
  int err = fill_levels(src, la, MODE == 0 ? P : 1, Z, R, Ci, st);
  if (err) return err;
  if (MODE == 2) {
    src.kind = 3;
    err = fill_levels(src, la2, 1, Z, R, Ci, st);
    if (err) return err;
  }
  // right operand: B transposed
  src.X = (const T*)B; src.which = 1;
  src.kind = MODE == 0 ? 1 : 0;
  src.qmax = MODE == 0 ? fq : cq;
  return fill_levels(src, lb, MODE == 0 ? 1 : P, Z, Co, Ci, st);
}

template <class T, int MODE>
int launch_mm(const void* A, const void* B, const void* grad,
              const float* cands, const float* fixed_int, float split,
              float a_int, float s_hi, float s_lo, int S, int G, int R,
              int Ci, int Co, int P, int cq, int fq, int8_t* la, int8_t* la2,
              int8_t* lb, float* partial, float* out, cudaStream_t st) {
  const int Z = G * S, Kp = kpad(Ci);
  int err = fill_mm_levels<T, MODE>(A, B, cands, fixed_int, split, a_int, S,
                                    G, R, Ci, Co, P, cq, fq, la, la2, lb, st);
  if (err) return err;

  Levels lev;
  lev.L0 = la; lev.L1 = la2; lev.R = lb; lev.Kp = Kp;
  lev.Lz = (long long)R * Kp;
  lev.Rz = (long long)Co * Kp;
  lev.L0p = MODE == 0 ? (long long)Z * R * Kp : 0;
  lev.Rp = MODE == 0 ? 0 : (long long)Z * Co * Kp;

  MatmulOp<T, MODE> op;
  op.A = (const T*)A; op.B = (const T*)B; op.Gr = (const T*)grad;
  op.cands = cands; op.fixed_int = fixed_int; op.s_hi = s_hi; op.s_lo = s_lo;
  op.S = S; op.Gh = G; op.M = R; op.N = Co; op.K = Ci; op.P = P;
  op.nbins = 1; op.g = 0; op.Ab = op.A; op.Bb = op.B; op.Gb = op.Gr;
  return launch(op, lev, R, Co, Z, G, P, 1, partial, out, st);
}

// ---------------------------------------------------------------------------
// B3f: the per-head matmul scorer at window shapes
// ---------------------------------------------------------------------------
//
// The TPU folds F heads into one block-diagonal dense-K dot because its
// lanes pad Ci / Co below 128.  The card pads differently: B3's 64 x 64
// output tile is mostly padding at Swin's window shapes (R = 144 rows and
// Co = 32 columns fill 38% of three tiles; R = Co = 144 fill 56% of nine),
// and B3 pays a block-wide reduction per candidate for every small tile.
// So B3f does not fold heads.  A block owns whole (window, head) problems
// -- a chunk of consecutive windows of one head, taken one after the other
// -- with an output tile fitted to R x Co: 16 x 16 threads, each with
// mi <= 9 rows and NJ columns (R = 144 -> 144 rows in one tile; Co = 32
// -> 32 columns, Co = 144 -> three 48-column tiles).  Per problem the block
// computes raw = A @ B and g² of its tile into registers and loads the
// fixed operand's levels into shared memory once; then, for each
// candidate, it streams only the candidate operand's level tile
// (double-buffered, one __syncthreads per candidate), takes the __dp4a
// products over all of K from 16-byte shared-memory loads, and adds the
// squared errors to a per-warp, per-candidate accumulator in shared
// memory (a shuffle reduction inside the warp, no block-wide reduction per
// candidate).  The chunk length is picked so that a call has about 1024
// blocks; the grid is one-dimensional (no S·G on grid.z).  Every block
// writes, per candidate, one partial in a fixed order, and
// reduce_partials sums them in double: no atomics, the same sims from run
// to run.  The levels come from the same pre-pass as B3's, and the rescale
// is B3's mm_term, bit for bit.

constexpr int FMI = 9;    // rows per thread at most: tiles of <= 144 rows
constexpr int FTK = 16;   // K chunk of the fp32 raw product
constexpr int NWARP = NT / 32;

struct FoldGeom {
  int S, G, R, Ci, Co, P;
  int Kp, KWS;        // level row bytes; shared-memory row stride in words
                      // (K words + 4: 16-byte aligned, no bank conflicts)
  int mi, nj;         // rows, columns per thread
  int TMr, TNr;       // tile rows (16 mi), tile columns (16 nj)
  int nrt, nct;       // row and column tiles per problem
  int SB, nchunk;     // windows per block, window chunks per head
  int nper;           // partials per head
  int nblocks;
  int nLbuf, nRbuf;   // level tiles held per side
  size_t smem;
};

FoldGeom fold_geom(int S, int G, int R, int Ci, int Co, int P, int mode) {
  FoldGeom q;
  q.S = S; q.G = G; q.R = R; q.Ci = Ci; q.Co = Co; q.P = P;
  q.Kp = kpad(Ci);
  q.KWS = q.Kp / 4 + 4;
  q.nrt = cdiv(R, 16 * FMI);
  q.mi = cdiv(R, 16 * q.nrt);
  q.nct = cdiv(Co, 48);
  q.nj = cdiv(Co, 16 * q.nct) <= 2 ? 2 : 3;
  q.TMr = 16 * q.mi;
  q.TNr = 16 * q.nj;
  const long long tiles = (long long)S * G * q.nrt * q.nct;
  q.SB = tiles / 1024 > 1 ? (int)(tiles / 1024) : 1;   // ~1024 blocks
  q.nchunk = cdiv(S, q.SB);
  q.nper = q.nchunk * q.nrt * q.nct;
  q.nblocks = G * q.nper;
  q.nLbuf = mode == 0 ? 2 : (mode == 2 ? 2 : 1);
  q.nRbuf = mode == 0 ? 1 : 2;
  q.smem = sizeof(int) * (size_t)(q.nLbuf * q.TMr + q.nRbuf * q.TNr) * q.KWS
           + sizeof(float) * ((size_t)q.TMr * (FTK + 1)
                              + (size_t)FTK * (q.TNr + 1)
                              + (size_t)NWARP * P);
  return q;
}

template <class T>
struct FoldArgs {
  const T* A;
  const T* B;
  const T* Gr;
  const float* cands;      // (P, G)
  const float* fixed_int;  // (G,)
  float s_hi, s_lo;
  const int8_t* la;        // levels, as B3 (z = g * S + s)
  const int8_t* la2;
  const int8_t* lb;
  FoldGeom q;
};

// rows [r0, r0 + nrows) of a (rows, Kp) level matrix into shared memory
// (row stride KWS words); rows at or past nvalid are zero
__device__ __forceinline__ void load_level_rows(int* dst, const int8_t* src,
                                                int r0, int nrows,
                                                int nvalid, int Kp,
                                                int KWS) {
  const int per_row = Kp / 16;
  const int4 zero = make_int4(0, 0, 0, 0);
  for (int idx = threadIdx.x; idx < nrows * per_row; idx += NT) {
    const int r = idx / per_row, c = idx % per_row;
    *reinterpret_cast<int4*>(dst + r * KWS + c * 4) =
        r0 + r < nvalid ? *reinterpret_cast<const int4*>(
                              src + (size_t)(r0 + r) * Kp + c * 16)
                        : zero;
  }
}

__device__ __forceinline__ int dp4a4(int4 a, int4 b, int c) {
  c = __dp4a(a.x, b.x, c);
  c = __dp4a(a.y, b.y, c);
  c = __dp4a(a.z, b.z, c);
  return __dp4a(a.w, b.w, c);
}

template <class T, int MODE, int NJ>
__global__ void __launch_bounds__(NT)
    folded_mm_kernel(FoldArgs<T> a, float* __restrict__ partial) {
  constexpr int NL = MODE == 2 ? 2 : 1;
  extern __shared__ int4 smem4[];
  const FoldGeom& q = a.q;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lane = tid & 31, warp = tid >> 5;
  const int KWS = q.KWS, KW = q.Kp / 4, R = q.R, Co = q.Co, Ci = q.Ci;
  const int P = q.P, mi = q.mi;
  int* Lbuf = reinterpret_cast<int*>(smem4);          // nLbuf x TMr x KWS
  int* Rbuf = Lbuf + q.nLbuf * q.TMr * KWS;           // nRbuf x TNr x KWS
  float* As = reinterpret_cast<float*>(Rbuf + q.nRbuf * q.TNr * KWS);
  float* Bs = As + q.TMr * (FTK + 1);                 // FTK x (TNr + 1)
  float* wacc = Bs + FTK * (q.TNr + 1);               // NWARP x P

  // block -> (head, window chunk, row tile, column tile)
  int b = blockIdx.x;
  const int ct = b % q.nct;
  b /= q.nct;
  const int rt = b % q.nrt;
  b /= q.nrt;
  const int chunk = b % q.nchunk;
  const int g = b / q.nchunk;
  const int m0 = rt * q.TMr, n0 = ct * q.TNr;
  const int slot = (chunk * q.nrt + rt) * q.nct + ct;
  const int s_lo = chunk * q.SB;
  const int s_hi = s_lo + q.SB < q.S ? s_lo + q.SB : q.S;
  const int Z = q.G * q.S;
  const size_t Lz = (size_t)R * q.Kp, Rz = (size_t)Co * q.Kp;
  const float fix = a.fixed_int[g];

  for (int i = tid; i < NWARP * P; i += NT) wacc[i] = 0.f;
  for (int s = s_lo; s < s_hi; ++s) {
    const size_t sg = (size_t)s * q.G + g;            // operand index
    const size_t z = (size_t)g * q.S + s;             // level index
    const T* Ab = a.A + sg * R * Ci;
    const T* Bb = a.B + sg * Ci * Co;
    const T* Gb = a.Gr + sg * R * Co;

    // raw = A @ B in fp32 for this tile (B3's order), and g²
    float rawv[FMI][NJ], g2v[FMI][NJ];
#pragma unroll
    for (int i = 0; i < FMI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) rawv[i][j] = 0.f;
    for (int k0 = 0; k0 < Ci; k0 += FTK) {
      for (int idx = tid; idx < q.TMr * FTK; idx += NT) {
        const int mm = idx / FTK, kk = idx % FTK;
        const int m = m0 + mm, k = k0 + kk;
        As[mm * (FTK + 1) + kk] =
            (m < R && k < Ci) ? to_f(Ab[(size_t)m * Ci + k]) : 0.f;
      }
      for (int idx = tid; idx < FTK * q.TNr; idx += NT) {
        const int kk = idx / q.TNr, nn = idx % q.TNr;
        const int k = k0 + kk, n = n0 + nn;
        Bs[kk * (q.TNr + 1) + nn] =
            (k < Ci && n < Co) ? to_f(Bb[(size_t)k * Co + n]) : 0.f;
      }
      __syncthreads();
      for (int kk = 0; kk < FTK; ++kk) {
        float bv[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) bv[j] = Bs[kk * (q.TNr + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < FMI; ++i) {
          if (i < mi) {
            const float av = As[(ty + 16 * i) * (FTK + 1) + kk];
#pragma unroll
            for (int j = 0; j < NJ; ++j)
              rawv[i][j] = __fmaf_rn(av, bv[j], rawv[i][j]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < FMI; ++i) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
        float gv = 0.f;
        if (i < mi && m < R && n < Co) gv = to_f(Gb[(size_t)m * Co + n]);
        g2v[i][j] = __fmul_rn(gv, gv);
      }
    }

    // the fixed operand's levels, once per problem; candidate 0's tile
    if (MODE == 0) {
      load_level_rows(Rbuf, a.lb + z * Rz, n0, q.TNr, Co, q.Kp, KWS);
      load_level_rows(Lbuf, a.la + z * Lz, m0, q.TMr, R, q.Kp, KWS);
    } else {
      load_level_rows(Lbuf, a.la + z * Lz, m0, q.TMr, R, q.Kp, KWS);
      if (MODE == 2)
        load_level_rows(Lbuf + q.TMr * KWS, a.la2 + z * Lz, m0, q.TMr, R,
                        q.Kp, KWS);
      load_level_rows(Rbuf, a.lb + z * Rz, n0, q.TNr, Co, q.Kp, KWS);
    }
    __syncthreads();

    for (int p = 0; p < P; ++p) {
      const int cur = p & 1;
      if (p + 1 < P) {     // prefetch the next candidate's tile
        const size_t off = (size_t)(p + 1) * Z + z;
        if (MODE == 0)
          load_level_rows(Lbuf + (1 - cur) * q.TMr * KWS, a.la + off * Lz,
                          m0, q.TMr, R, q.Kp, KWS);
        else
          load_level_rows(Rbuf + (1 - cur) * q.TNr * KWS, a.lb + off * Rz,
                          n0, q.TNr, Co, q.Kp, KWS);
      }
      const int* Lc = MODE == 0 ? Lbuf + cur * q.TMr * KWS : Lbuf;
      const int* Rc = MODE == 0 ? Rbuf : Rbuf + cur * q.TNr * KWS;
      int acc[NL][FMI][NJ];
#pragma unroll
      for (int l = 0; l < NL; ++l)
#pragma unroll
        for (int i = 0; i < FMI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[l][i][j] = 0;
      for (int kw = 0; kw < KW; kw += 4) {
        int4 bw[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          bw[j] = *reinterpret_cast<const int4*>(
              Rc + (tx + 16 * j) * KWS + kw);
#pragma unroll
        for (int l = 0; l < NL; ++l) {
#pragma unroll
          for (int i = 0; i < FMI; ++i) {
            if (i < mi) {
              const int4 aw = *reinterpret_cast<const int4*>(
                  Lc + (l * q.TMr + ty + 16 * i) * KWS + kw);
#pragma unroll
              for (int j = 0; j < NJ; ++j)
                acc[l][i][j] = dp4a4(aw, bw[j], acc[l][i][j]);
            }
          }
        }
      }
      const float d = a.cands[p * q.G + g];
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < FMI; ++i) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
          if (i < mi && m < R && n < Co)
            sum = __fadd_rn(sum, mm_term<MODE>(acc[0][i][j],
                                               acc[NL - 1][i][j], d, fix,
                                               a.s_hi, a.s_lo, rawv[i][j],
                                               g2v[i][j]));
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
      if (lane == 0) wacc[warp * P + p] = __fadd_rn(wacc[warp * P + p], sum);
      __syncthreads();     // the next tile may now overwrite this one
    }
  }
  for (int p = tid; p < P; p += NT) {
    float s = 0.f;
    for (int w = 0; w < NWARP; ++w) s = __fadd_rn(s, wacc[w * P + p]);
    partial[((size_t)g * q.nper + slot) * P + p] = s;
  }
}

template <class T, int MODE, int NJ>
int launch_folded(const FoldArgs<T>& a, float* partial, float* out,
                  cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      folded_mm_kernel<T, MODE, NJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.q.smem);
  if (err != cudaSuccess) return (int)err;
  folded_mm_kernel<T, MODE, NJ><<<a.q.nblocks, NT, a.q.smem, st>>>(a,
                                                                 partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = a.q.P * a.q.G;
  reduce_partials<<<cdiv(total, 128), 128, 0, st>>>(partial, out, a.q.G,
                                                   a.q.nper, a.q.P, 1);
  return (int)cudaGetLastError();
}

template <class T, int MODE>
int launch_mm_folded(const void* A, const void* B, const void* grad,
                     const float* cands, const float* fixed_int, float split,
                     float a_int, float s_hi, float s_lo, int S, int G,
                     int R, int Ci, int Co, int P, int cq, int fq,
                     int8_t* la, int8_t* la2, int8_t* lb, float* partial,
                     float* out, cudaStream_t st) {
  int err = fill_mm_levels<T, MODE>(A, B, cands, fixed_int, split, a_int, S,
                                    G, R, Ci, Co, P, cq, fq, la, la2, lb, st);
  if (err) return err;
  FoldArgs<T> a;
  a.A = (const T*)A; a.B = (const T*)B; a.Gr = (const T*)grad;
  a.cands = cands; a.fixed_int = fixed_int; a.s_hi = s_hi; a.s_lo = s_lo;
  a.la = la; a.la2 = la2; a.lb = lb;
  a.q = fold_geom(S, G, R, Ci, Co, P, MODE);
  if (a.q.nj == 2) return launch_folded<T, MODE, 2>(a, partial, out, st);
  return launch_folded<T, MODE, 3>(a, partial, out, st);
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
// Epilogue, per candidate and element: the parent's arithmetic with
// __fmul_rn / __fadd_rn in its order, so every squared error is bitwise
// the dp4a kernel's; raw, grad (and B2's ws[n], B1's row-block index, and
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
constexpr int LQ_KC = 128;              // K bytes of one TMA box
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one box (K bytes [k, k + 128), rows [row, row + box rows), candidate p)
// of a level buffer into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int k, int row, int p,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"((uint64_t)map), "r"(k), "r"(row), "r"(p), "r"(bar)
      : "memory");
}

// wgmma descriptor of a K-major tile, 128-byte swizzle: rows 128 bytes
// apart, 8-row groups 1024 bytes apart (SBO), LBO unused (1)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
__device__ __forceinline__ void fence_acc(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d += A(64 x 32) B(64 x 32)ᵀ, s8 x s8 -> s32
__device__ __forceinline__ void wgmma_s8_m64n64k32(int (&d)[32], uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

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
            wgmma_s8_m64n64k32(acc[l], dfix, dcand);
          else
            wgmma_s8_m64n64k32(acc[l], dcand, dfix);
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

// cuTensorMapEncodeTiled from libcuda, which the CUDA runtime has already
// loaded (no link against it)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h != nullptr)
      fn = (EncodeTiledFn)dlsym(h, "cuTensorMapEncodeTiled");
  }
  return fn;
}

constexpr int kErrNoLibcuda = 9001;     // returned when libcuda is missing
constexpr int kErrTensorMap = 9002;    // cuTensorMapEncodeTiled refused
constexpr int kErrSmem = 9003;         // the plan exceeds shared memory

// the (Kp, rows, planes) int8 level buffer at p in boxes of 128 x box_rows
int level_map(CUtensorMap* map, const int8_t* p, int Kp, int rows,
              int planes, int box_rows) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return kErrNoLibcuda;
  const cuuint64_t dims[3] = {(cuuint64_t)Kp, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)Kp, (cuuint64_t)rows * Kp};
  const cuuint32_t box[3] = {(cuuint32_t)LQ_KC, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, (void*)p,
                         dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
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

// Number of 64 x 64 output tiles of an M x N product (the wrapper sizes
// the partial-sum scratch as tiles * Z * P * bins floats).
int ptq_num_tiles(int M, int N) { return cdiv(M, TM) * cdiv(N, TN); }

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

// B3f: the partial-sum count per candidate (the wrapper sizes the
// partial scratch as this times P floats).
int ptq_fold_num_partials(int S, int G, int R, int Ci, int Co, int P,
                          int mode) {
  return G * fold_geom(S, G, R, Ci, Co, P, mode).nper;
}

// B3.  A (S, G, R, Ci), B (S, G, Ci, Co), grad (S, G, R, Co), all f32
// (bf16 = 0) or all bf16 (bf16 = 1); cands (P, G); fixed_int (G,);
// mode 0 "a", 1 "b", 2 "b_sos" -> out (P, G).
// Scratch (Z = G * S): la (P, Z, R, Kp) in mode 0, else (Z, R, Kp);
// la2 (Z, R, Kp) in mode 2, else NULL; lb (Z, Co, Kp) in mode 0, else
// (P, Z, Co, Kp).
int ptq_matmul_sims(const void* A, const void* B, const void* grad, int bf16,
                    const float* cands, const float* fixed_int, float split,
                    float a_int, float s_hi, float s_lo, int S, int G, int R,
                    int Ci, int Co, int P, int mode, int cand_qmax,
                    int fixed_qmax, int8_t* la, int8_t* la2, int8_t* lb,
                    float* partial, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define PTQ_MM(T, MODE)                                                      \
  return launch_mm<T, MODE>(A, B, grad, cands, fixed_int, split, a_int,     \
                            s_hi, s_lo, S, G, R, Ci, Co, P, cand_qmax,      \
                            fixed_qmax, la, la2, lb, partial, out, st)
  if (bf16) {
    if (mode == 0) PTQ_MM(__nv_bfloat16, 0);
    if (mode == 1) PTQ_MM(__nv_bfloat16, 1);
    PTQ_MM(__nv_bfloat16, 2);
  }
  if (mode == 0) PTQ_MM(float, 0);
  if (mode == 1) PTQ_MM(float, 1);
  PTQ_MM(float, 2);
#undef PTQ_MM
}

// B3f.  Arguments, scratch and result as B3; partial holds
// ptq_fold_num_partials(...) * P floats.  A shape whose block needs more
// shared memory than the card has fails with the launch's CUDA error.
int ptq_matmul_sims_folded(const void* A, const void* B, const void* grad,
                           int bf16, const float* cands,
                           const float* fixed_int, float split, float a_int,
                           float s_hi, float s_lo, int S, int G, int R,
                           int Ci, int Co, int P, int mode, int cand_qmax,
                           int fixed_qmax, int8_t* la, int8_t* la2,
                           int8_t* lb, float* partial, float* out,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define PTQ_MMF(T, MODE)                                                     \
  return launch_mm_folded<T, MODE>(A, B, grad, cands, fixed_int, split,     \
                                   a_int, s_hi, s_lo, S, G, R, Ci, Co, P,   \
                                   cand_qmax, fixed_qmax, la, la2, lb,      \
                                   partial, out, st)
  if (bf16) {
    if (mode == 0) PTQ_MMF(__nv_bfloat16, 0);
    if (mode == 1) PTQ_MMF(__nv_bfloat16, 1);
    PTQ_MMF(__nv_bfloat16, 2);
  }
  if (mode == 0) PTQ_MMF(float, 0);
  if (mode == 1) PTQ_MMF(float, 1);
  PTQ_MMF(float, 2);
#undef PTQ_MMF
}

}  // extern "C"
