// Per-ray BVH8 traversal body, shared by the CUDA kernel (traverse.cu) and
// a host build (traverse_host.cpp) that the CPU tests compile with g++:
// under nvcc the functions are __device__, under g++ plain inline.
//
// It computes what shimmer_tpu/ops/pallas/traverse.py::_traverse_kernel
// computes for one ray: the closest hit (t, tri) over the BVH8 rows, with
// tri = -1 on a miss, and an early exit at the first accepted hit for an
// any-hit ray.  Table layout (shimmer_tpu/ops/bvh8.py): one 128-float row
// per node.  Internal rows hold the 8 child boxes SoA in cols 0:48
// ([lox*8 | loy*8 | loz*8 | hix*8 | hiy*8 | hiz*8]) and per-slot valid
// flags in cols 88:96; leaf rows hold up to 8 triangles SoA in cols 0:72
// ([p0x*8 | p0y*8 | ... | p2z*8]) and their BVH-sorted ids as exact floats
// in cols 72:80.  meta[r] = leaf_count | child_base << 4, and the children
// of a node occupy rows child_base + slot.
//
// The stack holds `child_base << 8 | pending slot bits` entries; a visit
// peels the lowest pending bit of the top entry (the reference kernel's
// order).  All arithmetic is plain IEEE float32 in the same operand order
// as shapes/triangle.py::intersect_triangle: the caller re-intersects the
// winning triangle in torch and must reproduce this hit decision, so the
// CUDA build uses -fmad=false (no FMA contraction) and the host build
// -ffp-contract=off.
#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define SHIMMER_HD __device__ __forceinline__
#define SHIMMER_LDG(p) __ldg(p)
#else
#define SHIMMER_HD inline
#define SHIMMER_LDG(p) (*(p))
#endif

namespace shimmer {

constexpr int kRowWidth = 128;
constexpr int kMaxStack = 64;   // the wrapper checks stack_depth + 8 <= this
constexpr int kColIds = 72;
constexpr int kColValid = 88;

struct RayResult {
  float t;
  int tri;
  int steps;
};

// a*b - c*d with the reference's correction term (ops/math.py).  Without
// FMA contraction the correction evaluates exactly as in eager torch.
SHIMMER_HD float difference_of_products(float a, float b, float c, float d) {
  float cd = c * d;
  float diff = a * b - cd;
  float err = -c * d + cd;
  return diff + err;
}

SHIMMER_HD void permute_to_max_z(int kz, float x, float y, float z,
                                 float& ox, float& oy, float& oz) {
  if (kz == 0) {
    ox = y; oy = z; oz = x;
  } else if (kz == 1) {
    ox = z; oy = x; oz = y;
  } else {
    ox = x; oy = y; oz = z;
  }
}

SHIMMER_HD float fmin_(float a, float b) { return a < b ? a : b; }
SHIMMER_HD float fmax_(float a, float b) { return a > b ? a : b; }

SHIMMER_HD int lowest_bit_index(int lsb) {
  // lsb is a single bit in 0..7
  return ((lsb & 0xAA) != 0 ? 1 : 0) + ((lsb & 0xCC) != 0 ? 2 : 0) +
         ((lsb & 0xF0) != 0 ? 4 : 0);
}

SHIMMER_HD RayResult traverse_ray(const float* __restrict__ rows,
                                  const int* __restrict__ meta, int n_rows,
                                  float ox, float oy, float oz, float dx,
                                  float dy, float dz, float t_max,
                                  bool any_hit) {
  RayResult res;
  res.t = INFINITY;
  res.tri = -1;
  res.steps = 0;
  // Dead lanes (t_max <= 0, including -inf and NaN) do not traverse.
  if (!(t_max > 0.0f)) return res;

  // Loop invariants: guarded 1/d for the slab test, and the watertight
  // permutation (|d|-max axis, ties to the lower axis) and shear.
  const float ix = 1.0f / (dx == 0.0f ? 1e-30f : dx);
  const float iy = 1.0f / (dy == 0.0f ? 1e-30f : dy);
  const float iz = 1.0f / (dz == 0.0f ? 1e-30f : dz);
  const float adx = dx < 0.0f ? -dx : dx;
  const float ady = dy < 0.0f ? -dy : dy;
  const float adz = dz < 0.0f ? -dz : dz;
  const bool is0 = (adx >= ady) && (adx >= adz);
  const bool is1 = !is0 && (ady >= adz);
  const int kz = is0 ? 0 : (is1 ? 1 : 2);
  float pdx, pdy, pdz;
  permute_to_max_z(kz, dx, dy, dz, pdx, pdy, pdz);
  const bool dz_ok = pdz != 0.0f;
  const float pdz_safe = dz_ok ? pdz : 1.0f;
  const float sx = -pdx / pdz_safe;
  const float sy = -pdy / pdz_safe;
  const float sz = 1.0f / pdz_safe;

  int stack[kMaxStack];
  int sp = 0;
  stack[sp++] = 1;  // root row 0, slot bit 0
  float t_best = t_max;
  int tri_best = -1;
  int steps = 0;

  while (sp > 0) {
    const int e = stack[sp - 1];
    const int bits = e & 255;
    const int lsb = bits & (-bits);
    const int rest = e - lsb;
    if ((rest & 255) == 0) {
      --sp;
    } else {
      stack[sp - 1] = rest;
    }
    int r = (e >> 8) + lowest_bit_index(lsb);
    r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
    ++steps;
    const int m = SHIMMER_LDG(meta + r);
    const int cnt = m & 15;
    const float* row = rows + (size_t)r * kRowWidth;

    if (cnt == 0) {
      // Internal node: slab-test the 8 child boxes.
      int hit_bits = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float t0x = (SHIMMER_LDG(row + 0 + k) - ox) * ix;
        const float t0y = (SHIMMER_LDG(row + 8 + k) - oy) * iy;
        const float t0z = (SHIMMER_LDG(row + 16 + k) - oz) * iz;
        const float t1x = (SHIMMER_LDG(row + 24 + k) - ox) * ix;
        const float t1y = (SHIMMER_LDG(row + 32 + k) - oy) * iy;
        const float t1z = (SHIMMER_LDG(row + 40 + k) - oz) * iz;
        const float tn = fmax_(fmax_(fmin_(t0x, t1x), fmin_(t0y, t1y)),
                               fmin_(t0z, t1z));
        const float tf = fmin_(fmin_(fmax_(t0x, t1x), fmax_(t0y, t1y)),
                               fmax_(t0z, t1z));
        const bool valid = SHIMMER_LDG(row + kColValid + k) > 0.0f;
        if (valid && tn <= tf * 1.0001f && tf > 0.0f && tn < t_best) {
          hit_bits |= 1 << k;
        }
      }
      if (hit_bits != 0 && sp < kMaxStack) {
        stack[sp++] = ((m >> 4) << 8) | hit_bits;
      }
    } else {
      // Leaf: watertight test of its triangles; the lowest slot wins
      // among equal t.
      float t_leaf = INFINITY;
      int k_leaf = -1;
      for (int k = 0; k < cnt && k < 8; ++k) {
        float q0x, q0y, q0z, q1x, q1y, q1z, q2x, q2y, q2z;
        permute_to_max_z(kz, SHIMMER_LDG(row + 0 + k) - ox,
                         SHIMMER_LDG(row + 8 + k) - oy,
                         SHIMMER_LDG(row + 16 + k) - oz, q0x, q0y, q0z);
        permute_to_max_z(kz, SHIMMER_LDG(row + 24 + k) - ox,
                         SHIMMER_LDG(row + 32 + k) - oy,
                         SHIMMER_LDG(row + 40 + k) - oz, q1x, q1y, q1z);
        permute_to_max_z(kz, SHIMMER_LDG(row + 48 + k) - ox,
                         SHIMMER_LDG(row + 56 + k) - oy,
                         SHIMMER_LDG(row + 64 + k) - oz, q2x, q2y, q2z);
        const float x0 = q0x + sx * q0z;
        const float y0 = q0y + sy * q0z;
        const float x1 = q1x + sx * q1z;
        const float y1 = q1y + sy * q1z;
        const float x2 = q2x + sx * q2z;
        const float y2 = q2y + sy * q2z;
        const float e0 = difference_of_products(x1, y2, y1, x2);
        const float e1 = difference_of_products(x2, y0, y2, x0);
        const float e2 = difference_of_products(x0, y1, y0, x1);
        const bool same_sign = (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f) ||
                               (e0 <= 0.0f && e1 <= 0.0f && e2 <= 0.0f);
        const float det = e0 + e1 + e2;
        const bool det_ok = det != 0.0f;
        const float ts = e0 * (q0z * sz) + e1 * (q1z * sz) + e2 * (q2z * sz);
        const bool t_ok =
            det < 0.0f ? (ts <= 1e-7f * det && ts > t_best * det)
                       : (ts >= 1e-7f * det && ts < t_best * det);
        if (same_sign && det_ok && t_ok && dz_ok) {
          const float inv_det = 1.0f / det;
          const float t = ts * inv_det;
          if (t < t_leaf) {
            t_leaf = t;
            k_leaf = k;
          }
        }
      }
      if (t_leaf < t_best) {
        t_best = t_leaf;
        tri_best = (int)SHIMMER_LDG(row + kColIds + k_leaf);
        if (any_hit) break;
      }
    }
  }
  res.t = tri_best >= 0 ? t_best : INFINITY;
  res.tri = tri_best;
  res.steps = steps;
  return res;
}

}  // namespace shimmer
