// Hand-written Hopper (sm_90a) kernels of the calibration candidate search.
//
// They replace the three int8-scored Pallas scorers of the JAX package:
//
//   B1  ptq4vit_tpu/ops/pallas_search.py  linear_w_hessian_sims_i8
//       (body _kernel_i8_ploop): linear weight-interval search
//   B2  ptq4vit_tpu/ops/pallas_search.py  linear_a_hessian_sims_i8
//       (body _a_kernel_i8_ploop): linear input-interval search
//   B3  ptq4vit_tpu/ops/pallas_search.py  matmul_hessian_sims
//       (body _mm_kernel, F = 1): per-head attention-matmul search
//
// All three score P candidate scales Δ_p with the hessian similarity
//     sims[p] = -Σ (g · (raw - out_p))²
// where out_p is an int8 x int8 -> int32 product of quantization levels
// rescaled once in fp32.  Each call runs three kernels:
//
//   levels_kernel       quantizes each operand to int8 levels once (per
//                       candidate for the searched operand) into K-padded
//                       rows, one IEEE division per element;
//   scored_gemm_kernel  a block owns a 64 x 64 output tile (B3: of one
//                       (head, sample)), keeps raw and grad of its tile in
//                       registers for the whole call, and loops over all P
//                       candidates inside the block: 16-byte loads of the
//                       level tiles into shared memory, __dp4a products
//                       with an exact int32 accumulate, the fp32 rescale
//                       and the squared error, summed per column;
//   reduce_partials     sums the per-block partials in a fixed order.
//
// What bounds them on the card: the int8 multiply-adds, about
// P · M · K · N per call (100 x 4616 x 768 x 3072 for fc1 at 8 images), and
// the level tiles streamed from L2 / HBM once per candidate and block row.
// Quantizing inside the candidate loop would make every row tile repeat
// the same divisions (they bounded the kernels on the card); the pre-pass
// does each once.  Tensor-core MMA, TMA and pipelining are later work.
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

#include <cuda_runtime.h>
#include <cuda_bf16.h>
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
// for k < K, 0 in the padding
// ---------------------------------------------------------------------------

template <class Src>
__global__ void levels_kernel(Src src, int8_t* __restrict__ out, int P,
                              int Z, int rows, int K, int Kp) {
  const size_t total = (size_t)P * Z * rows * Kp;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int k = (int)(i % Kp);
    size_t t = i / Kp;
    const int r = (int)(t % rows);
    t /= rows;
    const int z = (int)(t % Z);
    const int p = (int)(t / Z);
    out[i] = k < K ? src.level(p, z, r, k) : (int8_t)0;
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
// scored GEMM over pre-quantized levels
// ---------------------------------------------------------------------------

// Level buffers, K-padded rows of Kp bytes.  Element strides per candidate
// (0: the operand is fixed) and per z (0: shared by every z).
struct Levels {
  const int8_t* L0;
  const int8_t* L1;    // second left operand (twin / SoS), or null
  const int8_t* Lfix;  // candidate-free left operand (B2 twin), or null
  const int8_t* R;
  long long L0p, Rp, Lz, Rz;  // L1 and Lfix are fixed: no candidate stride
  int Kp;
};

// Defaults every epilogue may override.
struct OpBase {
  static constexpr bool kFixedPass = false;   // candidate-free 2nd product
  static constexpr bool kRawProduct = false;  // raw = A @ B in the block
  __device__ void bind(int) {}
  __device__ float fixed_value(int) const { return 0.f; }
  __device__ float rawA(int, int) const { return 0.f; }
  __device__ float rawB(int, int) const { return 0.f; }
  __device__ float raw(int, int) const { return 0.f; }
  __device__ float gprep(float g) const { return g; }
};

// B1: out = acc·(a·Δ) [+ acc_neg·(a_neg·Δ)], Δ = cands[p, v(n)]
template <int NL_>
struct LinearW : OpBase {
  static constexpr int NL = NL_;
  const float* cands;  // (P, nV)
  const float* rawp;
  const float* gradp;
  float a, a_neg;
  int M, N, K, P, nbins, crb;

  __device__ float raw(int m, int n) const { return rawp[(size_t)m * N + n]; }
  __device__ float grad(int m, int n) const {
    return gradp[(size_t)m * N + n];
  }
  __device__ float term(int p, int n, int acc0, int acc1, float, float r,
                        float g) const {
    const float d = cands[p * nbins + n / crb];
    float out = __fmul_rn(__int2float_rn(acc0), __fmul_rn(a, d));
    if (NL == 2)
      out = __fadd_rn(out, __fmul_rn(__int2float_rn(acc1),
                                     __fmul_rn(a_neg, d)));
    const float e = __fmul_rn(g, __fsub_rn(r, out));
    return __fmul_rn(e, e);
  }
  __device__ int bin(int n) const { return n / crb; }
};

// B2: out = (acc·Δ [+ acc_neg·a_neg]) · w_scale[n]
template <bool PG>
struct LinearA : OpBase {
  static constexpr int NL = 1;
  static constexpr bool kFixedPass = PG;
  const float* ws;
  const float* cands;  // (P,)
  const float* rawp;
  const float* gradp;
  float a_neg;
  int M, N, K, P, nbins;

  __device__ float fixed_value(int acc) const {
    return __fmul_rn(__int2float_rn(acc), a_neg);
  }
  __device__ float raw(int m, int n) const { return rawp[(size_t)m * N + n]; }
  __device__ float grad(int m, int n) const {
    return gradp[(size_t)m * N + n];
  }
  __device__ float term(int p, int n, int acc0, int, float fix, float r,
                        float g) const {
    float acc = __fmul_rn(__int2float_rn(acc0), cands[p]);
    if (PG) acc = __fadd_rn(acc, fix);
    const float out = __fmul_rn(acc, ws[n]);
    const float e = __fmul_rn(g, __fsub_rn(r, out));
    return __fmul_rn(e, e);
  }
  __device__ int bin(int) const { return 0; }
};

// B3 epilogue.  MODE 0 ("a"): candidates on A; 1 ("b"): on B; 2 ("b_sos"):
// on B with the softmax side as SoS hi/lo levels.  raw = A @ B in fp32.
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
    const float d = cands[p * Gh + g];
    float out;
    if (MODE == 0) {
      out = __fmul_rn(__int2float_rn(acc0), __fmul_rn(d, fixed_int[g]));
    } else if (MODE == 1) {
      out = __fmul_rn(__int2float_rn(acc0), __fmul_rn(fixed_int[g], d));
    } else {
      out = __fmul_rn(__fadd_rn(__fmul_rn(__int2float_rn(acc0), s_hi),
                                __fmul_rn(__int2float_rn(acc1), s_lo)),
                      d);
    }
    const float diff = __fsub_rn(r, out);
    return __fmul_rn(__fmul_rn(g2, diff), diff);
  }
  __device__ int bin(int) const { return 0; }
};

__device__ __forceinline__ void store_words(int* dst, int4 v) {
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// acc[l] = L_l tile @ R tileᵀ over all of Kp for candidate p (or the
// candidate-free left operand when fixed_pass).  Threads 0-127 load the
// left tile(s), 128-255 the right tile, 16 bytes each.
template <int NL>
__device__ __forceinline__ void dot_tiles(const Levels& lev, int p, int z,
                                          bool fixed_pass, int M, int N,
                                          int m0, int n0,
                                          int (*Ls)[TM][TKW + 1],
                                          int (*Rs)[TKW + 1],
                                          int (&acc)[NL][4][4]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nl = fixed_pass ? 1 : NL;
  const int8_t* lb[2];
  if (fixed_pass) {
    lb[0] = lev.Lfix + (size_t)z * lev.Lz;
    lb[1] = lb[0];
  } else {
    lb[0] = lev.L0 + (size_t)p * lev.L0p + (size_t)z * lev.Lz;
    lb[1] = NL > 1 ? lev.L1 + (size_t)z * lev.Lz : lb[0];
  }
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

  float rawv[4][4], gv[4][4], fixv[4][4];
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
      fixv[i][j] = 0.f;
    }
  }

  int acc[Op::NL][4][4];
  if (Op::kFixedPass) {
    dot_tiles<Op::NL>(lev, 0, z, true, o.M, o.N, m0, n0, Ls, Rs, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) fixv[i][j] = o.fixed_value(acc[0][i][j]);
  }

  for (int p = 0; p < o.P; ++p) {
    dot_tiles<Op::NL>(lev, p, z, false, o.M, o.N, m0, n0, Ls, Rs, acc);
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
                                fixv[i][j], rawv[i][j], gv[i][j]));
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
  const size_t total = (size_t)P * Z * rows * kpad(K);
  const int blocks = (int)((total + 255) / 256 < 65536 ? (total + 255) / 256
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

template <class T, int MODE>
int launch_mm(const void* A, const void* B, const void* grad,
              const float* cands, const float* fixed_int, float split,
              float a_int, float s_hi, float s_lo, int S, int G, int R,
              int Ci, int Co, int P, int cq, int fq, int8_t* la, int8_t* la2,
              int8_t* lb, float* partial, float* out, cudaStream_t st) {
  const int Z = G * S, Kp = kpad(Ci);
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
  err = fill_levels(src, lb, MODE == 0 ? 1 : P, Z, Co, Ci, st);
  if (err) return err;

  Levels lev;
  lev.L0 = la; lev.L1 = la2; lev.Lfix = nullptr; lev.R = lb; lev.Kp = Kp;
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

}  // namespace

extern "C" {

// Number of 64 x 64 output tiles of an M x N product (the wrapper sizes
// the partial-sum scratch as tiles * Z * P * bins floats).
int ptq_num_tiles(int M, int N) { return cdiv(M, TM) * cdiv(N, TN); }

// K rounded up to the level buffers' row length.
int ptq_k_pad(int K) { return kpad(K); }

// B1.  x_lv, xn_lv (M, K) int8 (xn_lv NULL unless post-GELU twin);
// w (N, K) f32; cands (P, nV); raw, grad (M, N) f32 -> out (P, nV).
// Scratch: lx, lxn (M, Kp) int8 (lxn NULL unless twin), lw (P, N, Kp).
int ptq_linear_w_sims(const int8_t* x_lv, const int8_t* xn_lv, const float* w,
                      const float* cands, const float* raw, const float* grad,
                      float a, float a_neg, int M, int K, int N, int P, int nV,
                      int qmax, int8_t* lx, int8_t* lxn, int8_t* lw,
                      float* partial, float* out, void* stream) {
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
  Levels lev;
  lev.L0 = lx; lev.L1 = lxn; lev.Lfix = nullptr; lev.R = lw; lev.Kp = Kp;
  lev.L0p = 0; lev.Rp = (long long)N * Kp; lev.Lz = 0;
  lev.Rz = 0;
  if (xn_lv != nullptr) {
    LinearW<2> op;
    op.cands = cands; op.rawp = raw; op.gradp = grad; op.a = a;
    op.a_neg = a_neg; op.M = M; op.N = N; op.K = K; op.P = P; op.nbins = nV;
    op.crb = crb;
    return launch(op, lev, M, N, 1, 1, P, nV, partial, out, st);
  }
  LinearW<1> op;
  op.cands = cands; op.rawp = raw; op.gradp = grad; op.a = a;
  op.a_neg = a_neg; op.M = M; op.N = N; op.K = K; op.P = P; op.nbins = nV;
  op.crb = crb;
  return launch(op, lev, M, N, 1, 1, P, nV, partial, out, st);
}

// B2.  x (M, K) f32; w_lv (N, K) int8; w_scale (N,); cands (P,);
// raw, grad (M, N) f32 -> out (P,).
// Scratch: lx (P, M, Kp) int8, lneg (M, Kp) (NULL unless post-GELU),
// lw (N, Kp).
int ptq_linear_a_sims(const float* x, const int8_t* w_lv, const float* w_scale,
                      const float* cands, const float* raw, const float* grad,
                      float a_neg, int M, int K, int N, int P, int qmax,
                      int postgelu, int8_t* lx, int8_t* lneg, int8_t* lw,
                      float* partial, float* out, void* stream) {
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
  Levels lev;
  lev.L0 = lx; lev.L1 = nullptr; lev.Lfix = lneg; lev.R = lw; lev.Kp = Kp;
  lev.L0p = (long long)M * Kp; lev.Rp = 0; lev.Lz = 0;
  lev.Rz = 0;
  if (postgelu) {
    LinearA<true> op;
    op.ws = w_scale; op.cands = cands; op.rawp = raw; op.gradp = grad;
    op.a_neg = a_neg; op.M = M; op.N = N; op.K = K; op.P = P; op.nbins = 1;
    return launch(op, lev, M, N, 1, 1, P, 1, partial, out, st);
  }
  LinearA<false> op;
  op.ws = w_scale; op.cands = cands; op.rawp = raw; op.gradp = grad;
  op.a_neg = a_neg; op.M = M; op.N = N; op.K = K; op.P = P; op.nbins = 1;
  return launch(op, lev, M, N, 1, 1, P, 1, partial, out, st);
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

}  // extern "C"
