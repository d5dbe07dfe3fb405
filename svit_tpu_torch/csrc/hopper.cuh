// Hopper (sm_90a) primitives shared by the hand-written kernels: mbarriers,
// TMA loads and stores through tensor maps (2-D and 5-D boxes with zero
// fill and traversal strides), 1-D bulk copies, proxy fences,
// named barriers, wgmma descriptors and the wgmma products themselves (A
// from shared memory or from registers, B from shared memory, f32
// accumulators), and the host-side encoding of tensor maps through libcuda's
// cuTensorMapEncodeTiled, found through the runtime (no -lcuda).
//
// Operand layouts the descriptors describe (bf16; "row" = an M or N index,
// 16-byte units "chunks"):
//  * 64-byte swizzle (TMA CU_TENSOR_MAP_SWIZZLE_64B): a tile of R rows by 32
//    columns is R rows of 64 bytes, the chunk index XOR ((row >> 1) & 3);
//    a wider tile is several such column boxes, R * 64 bytes apart.  K-major
//    (K along the row): SBO 512 bytes (8 rows), +32 bytes per k16 step
//    inside a box.  MN-major (N along the row, K down the rows): LBO the
//    box stride (32 columns of N), SBO 512 bytes (8 rows of K), +1024
//    bytes per k16 step.
//  * 128-byte swizzle (K1): boxes of 64 columns, SBO 1024 bytes.
//  * no swizzle ("interleave", the rel-pos one-hot and bias tiles): chunk c
//    of every row r at c * R * 16 + r * 16, so 8 consecutive rows of one
//    chunk are one 128-byte core matrix.  The K-direction core-matrix step
//    is LBO and the M/N-direction step SBO, for both majors.
#pragma once

#include <cuda.h>

#include "common.cuh"

enum { ERR_PLAN = -1, ERR_ENTRY = -2, ERR_TMAP = -3 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// make the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the phase of parity ``parity`` has completed.  The spin is one
// asm block (the compiler sees no divergent loop, which would serialise the
// wgmma groups in flight); a phase that never completes (a fault in the
// pipeline) traps after 2^22 tries instead of hanging the card.  A waiter
// must never run two phases ahead of a barrier: it would take an old phase
// of the same parity for its own.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u32 n;\n"
      "mov.u32 n, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.lt.u32 p, n, 4194304;\n"
      "@p bra WAIT;\n"
      "trap;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// The ops below that one thread issues take a predicate instead of sitting
// in an ``if``: every thread of the warpgroup executes the instruction, so
// the compiler sees no divergent path beside the wgmma groups in flight
// (which it would serialise).
__device__ __forceinline__ void mbar_expect_tx_if(bool pred, uint64_t* bar,
                                                  uint32_t bytes) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes), "r"((int)pred)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_if(bool pred, uint64_t* bar) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(smem_u32(bar)),
      "r"((int)pred)
      : "memory");
}

__device__ __forceinline__ void tma_load_if(bool pred, void* dst,
                                            const CUtensorMap* map,
                                            uint64_t* bar, int col, int row) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"
      "@p cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n}\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "r"((int)pred)
      : "memory");
}

__device__ __forceinline__ void tma_store_if(bool pred, const CUtensorMap* map,
                                             const void* src, int col,
                                             int row) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %4, 0;\n"
      "@p cp.async.bulk.tensor.2d.global.shared::cta.bulk_group "
      "[%0, {%2, %3}], [%1];\n}\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(col), "r"(row), "r"((int)pred)
      : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row)
      : "memory");
}

// a box of a 5-D map (innermost first: channel, w, h, t, batch of a grid;
// or a head's column, head, part, row, batch), from signed coordinates:
// every element outside the tensor lands as zero.  With traversal strides
// the box takes every s-th element of its extent along that dimension.
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c, int w, int h,
                                            int t, int b) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c), "r"(w),
      "r"(h), "r"(t), "r"(b)
      : "memory");
}

// shared -> global through a tensor map: the box is clipped at the tensor's
// edges (rows past M, columns past the output's width)
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(col), "r"(row)
      : "memory");
}

// shared -> global through a 5-D map: the box is clipped at the tensor's
// edges (columns past a head's width, rows past the batch entry's last)
__device__ __forceinline__ void tma_store_5d(const CUtensorMap* map,
                                             const void* src, int c, int w,
                                             int h, int t, int b) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5, %6}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c), "r"(w), "r"(h), "r"(t), "r"(b)
      : "memory");
}

// ``bytes`` (a multiple of 16) contiguous bytes, global -> shared, completing
// on ``bar``; both addresses 16-byte aligned
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ``bytes`` (a multiple of 16) contiguous bytes, shared -> global, in the
// bulk group (bulk_commit, bulk_wait)
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          reinterpret_cast<uint64_t>(dst)),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the committed stores have read their shared-memory source
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// generic-proxy writes to shared memory, then the async proxy (TMA, wgmma)
// reads them
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barriers: 1 for the whole block, 2 + wg for one warpgroup
template <int ID, int THREADS>
__device__ __forceinline__ void bar_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(THREADS) : "memory");
}

__device__ __forceinline__ void wg_sync(int wg) {
  if (wg == 0)
    bar_sync<2, 128>();
  else
    bar_sync<3, 128>();
}

// a wgmma shared-memory descriptor: start address, leading and stride byte
// offsets, layout (0 none, 1 128-byte, 2 64-byte swizzle)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return ((uint64_t)((addr & 0x3FFFF) >> 4)) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)layout << 62);
}

// K-major, 128-byte swizzle, 8-row groups 1024 B apart (K1's operands)
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return make_desc(smem_u32(p), 16, 1024, 1);
}

// K-major, 64-byte swizzle: rows of 64 bytes, 8-row groups 512 B apart
__device__ __forceinline__ uint64_t desc_sw64_k(uint32_t addr) {
  return make_desc(addr, 16, 512, 2);
}

// MN-major, 64-byte swizzle: 32-column boxes ``box`` bytes apart, 8-row
// (K) groups 512 B apart
__device__ __forceinline__ uint64_t desc_sw64_mn(uint32_t addr, uint32_t box) {
  return make_desc(addr, box, 512, 2);
}

// no swizzle: core matrices ``kstep`` bytes apart along K and ``mnstep``
// along M/N
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t kstep,
                                               uint32_t mnstep) {
  return make_desc(addr, kstep, mnstep, 0);
}

// keep the compiler from moving accumulator reads and writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

// The products: wgmma.mma_async m64nNk16, bf16 inputs, f32 accumulators in
// the m64nN fragment (warp w of the warpgroup holds rows 16 w + lane / 4
// and + 8; d[4 j + 2 h + e] is row + 8 h, column 8 j + 2 (lane % 4) + e).
// ``accumulate`` 0 overwrites d.  The overload is chosen by d's size.
// wgmma_ss: d (64 x N) (+)= A (64 x 16) . B (N x 16)^T, both from shared
// memory, both K-major (N 64 and 128).
// wgmma_rs: d (64 x N) (+)= A (64 x 16) . B (16 x N), A from registers in
// mma.sync's A-fragment order, B from shared memory MN-major (transposed:
// N along the stored row; N 16 to 128).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[24], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[48], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// a libcuda function, found through the runtime (no -lcuda); null if absent
static inline void* driver_fn(const char* name) {
  void* f = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  cudaError_t e = cudaGetDriverEntryPointByVersion(name, &f, 12000,
                                                   cudaEnableDefault, &q);
#else
  cudaError_t e = cudaGetDriverEntryPoint(name, &f, cudaEnableDefault, &q);
#endif
  return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? f : nullptr;
}

typedef CUresult (*CtxGetCurrent)(CUcontext*);
typedef CUresult (*CtxSetCurrent)(CUcontext);
typedef CUresult (*PrimaryCtxRetain)(CUcontext*, CUdevice);

// The encoder is a driver call: it wants a context current on the calling
// thread.  The runtime makes the device's primary context current at the
// thread's first call that needs one, which a thread may not have made yet:
// autograd's backward thread, where a backward that starts with one of these
// kernels (K3's) runs it first.  Then the current device's primary context
// is made current here (no runtime call, so nothing that a stream capture
// would refuse).
static inline bool context_current() {
  static CtxGetCurrent get = nullptr;
  static CtxSetCurrent set = nullptr;
  static PrimaryCtxRetain retain = nullptr;
  if (!get || !set || !retain) {
    set = reinterpret_cast<CtxSetCurrent>(driver_fn("cuCtxSetCurrent"));
    retain = reinterpret_cast<PrimaryCtxRetain>(
        driver_fn("cuDevicePrimaryCtxRetain"));
    get = reinterpret_cast<CtxGetCurrent>(driver_fn("cuCtxGetCurrent"));
    if (!get || !set || !retain) return false;
  }
  CUcontext ctx = nullptr;
  if (get(&ctx) == CUDA_SUCCESS && ctx) return true;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return false;
  // the primary context torch holds; the retain adds a reference it keeps
  return retain(&ctx, dev) == CUDA_SUCCESS && set(ctx) == CUDA_SUCCESS;
}

// libcuda's cuTensorMapEncodeTiled, with a context current on this thread;
// null if either cannot be had
static inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) fn = reinterpret_cast<EncodeTiled>(driver_fn("cuTensorMapEncodeTiled"));
  return fn && context_current() ? fn : nullptr;
}

// a bf16 tensor of ``rank`` (2 or 3) dimensions, innermost first (``dims``:
// columns, rows[, batch]), rows contiguous, in boxes of box_cols x box_rows
// (x 1): loads are zero-filled and stores clipped past its edges.  The
// swizzle is ``swizzle_bytes`` (128, 64 or 0).
static inline int encode_map(CUtensorMap* map, const void* ptr, int rank,
                             const long (&dims)[3], int box_cols, int box_rows,
                             int swizzle_bytes) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return ERR_ENTRY;
  cuuint64_t d[3], strides[2];
  cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) d[i] = (cuuint64_t)dims[i];
  strides[0] = (cuuint64_t)dims[0] * sizeof(bf16);
  strides[1] = strides[0] * (cuuint64_t)dims[1];
  const CUtensorMapSwizzle sw = swizzle_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_NONE;
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
                  const_cast<void*>(ptr), d, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TMAP;
}

// a packed 5-D tensor of bf16 (``elem`` 2) or uint8 (``elem`` 1),
// innermost first (``dims``; a channels-last grid [B, T, H, W, C] is C, W,
// H, T, B), swizzled by ``swizzle_bytes`` (0 or 64).  ``box`` is the extent
// a load traverses along each dimension and ``step`` the traversal stride
// (1 to 8): a load lands ceil(box / step) elements per dimension, and
// elements outside the tensor (negative coordinates included) land as zero.
static inline int encode_map_5d(CUtensorMap* map, const void* ptr,
                                const long (&dims)[5], const int (&box)[5],
                                const int (&step)[5], int elem = 2,
                                int swizzle_bytes = 0) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return ERR_ENTRY;
  cuuint64_t d[5], strides[4];
  cuuint32_t bx[5], el[5];
  for (int i = 0; i < 5; ++i) {
    d[i] = (cuuint64_t)dims[i];
    bx[i] = (cuuint32_t)box[i];
    el[i] = (cuuint32_t)step[i];
  }
  strides[0] = d[0] * elem;
  for (int i = 1; i < 4; ++i) strides[i] = strides[i - 1] * d[i];
  CUresult r = fn(map,
                  elem == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  5,
                  const_cast<void*>(ptr), d, strides, bx, el,
                  CU_TENSOR_MAP_INTERLEAVE_NONE,
                  swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                      : CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TMAP;
}
