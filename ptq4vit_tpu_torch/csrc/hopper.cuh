// Hopper (sm_90a) building blocks shared by the port's kernel libraries
// (search_kernels.cu, serve_kernels.cu): shared-memory addresses,
// mbarriers, TMA tile loads and their tensor maps, and s8 wgmma from
// 128-byte-swizzled shared memory.  ops/build.py rebuilds a library when
// this header changes.
//
// The layout they agree on: a tile of R rows x 128 K bytes, K-major, as
// TMA writes it with CU_TENSOR_MAP_SWIZZLE_128B into a 1024-byte aligned
// buffer -- row r at byte 128 r, its 16-byte unit u stored at unit
// u ^ (r % 8) -- which is what a wgmma descriptor with 128-byte swizzle
// (sw128_desc) reads, for either operand.

#pragma once

#include <cuda.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

// error codes of the C entry points beside CUDA's own
constexpr int kErrNoLibcuda = 9001;     // returned when libcuda is missing
constexpr int kErrTensorMap = 9002;    // cuTensorMapEncodeTiled refused
constexpr int kErrSmem = 9003;         // the plan exceeds shared memory

constexpr int TMA_BOX_K = 128;         // K bytes of one TMA box (a row's
                                       // 128-byte swizzle span)

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
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= A(64 x 32) B(N x 32)ᵀ, s8 x s8 -> s32, both from shared memory;
// scale_d = 0 ignores d's old value.  s8 wgmma takes N = 8, 16, 24,
// 32 and then multiples of 16 up to 256.
template <int N>
struct WgmmaS8;

template <>
struct WgmmaS8<16> {
  static __device__ __forceinline__ void mma(int (&d)[8], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}"
        ", %8, %9, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaS8<24> {
  static __device__ __forceinline__ void mma(int (&d)[12], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %14, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}"
        ", %12, %13, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaS8<32> {
  static __device__ __forceinline__ void mma(int (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15}"
        ", %16, %17, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaS8<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}"
        ", %32, %33, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaS8<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}"
        ", %64, %65, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
          "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// The ring's position: the next slot and its mbarrier phase.
struct RingPos {
  int slot;
  uint32_t phase;
  __device__ __forceinline__ void advance(int S) {
    if (++slot == S) {
      slot = 0;
      phase ^= 1u;
    }
  }
};

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

// the (Kp, rows, planes) int8 level buffer at p in boxes of 128 x box_rows
int level_map(CUtensorMap* map, const int8_t* p, int Kp, int rows,
              int planes, int box_rows) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return kErrNoLibcuda;
  const cuuint64_t dims[3] = {(cuuint64_t)Kp, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)Kp, (cuuint64_t)rows * Kp};
  const cuuint32_t box[3] = {(cuuint32_t)TMA_BOX_K, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, (void*)p,
                         dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

}  // namespace
