// Warp-level tensor-core product shared by the port's CUDA kernels.
#pragma once

#include <stdint.h>

// D += A B for one m16n8k16 tile: A 16x16 bf16 (row major, 4 registers of
// two halves), B 16x8 bf16 (column major, 2 registers), D 16x8 f32.  The
// fragment layouts are those of the PTX ISA for mma.m16n8k16: with
// g = lane / 4 and t = lane % 4, a[0..3] hold A rows g, g+8, g, g+8 at
// columns 2t (+8 for a[2], a[3]); b[0..1] hold B rows 2t and 2t+8 at
// column g; d[0..3] hold D rows g, g, g+8, g+8 at columns 2t, 2t+1.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// D += A B for one m16n8k32 tile of signed bytes: A 16x32 s8 (row major, 4
// registers of four bytes), B 32x8 s8 (column major, 2 registers), D 16x8
// s32.  Layouts of the PTX ISA for mma.m16n8k32 with 8-bit operands: a[0..3]
// hold A rows g, g+8, g, g+8 at columns 4t .. 4t+3 (+16 for a[2], a[3]);
// b[0..1] hold B rows 4t .. 4t+3 and 16+4t .. 16+4t+3 at column g; d as above.
__device__ __forceinline__ void mma_s8_16832(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
