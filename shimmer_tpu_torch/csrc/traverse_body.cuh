// Per-ray BVH8 traversal: the node tests shared by both kernels and the v1
// body.  Shared by the CUDA kernels (traverse.cu) and a host build (traverse_host.cpp) that the CPU tests compile with g++:
// under nvcc the functions are __device__, under g++ plain inline.
//
// The v1 body computes what shimmer_tpu/ops/pallas/traverse.py::
// _traverse_kernel computes for one ray: the closest hit (t, tri) over the
// BVH8 rows, with tri = -1 on a miss, and an early exit at the first
// accepted hit for an any-hit ray.  Two template parameters select the
// reference's leaf variants:
//   kLeaf   = kLeafWatertight: pbrt's translate-permute-shear test (default)
//           = kLeafMT: Moller-Trumbore on pack-time edges, leaf rows hold
//             (p0, e1, e2) (traverse.py:228-253, SHIMMER_LEAF_MT=1)
//   kWinner = kWinnerSlot: among equal t in a leaf the lowest slot wins
//           = kWinnerMinId: the lowest triangle id wins (traverse.py:
//             295-298, SHIMMER_WINID_MIN=1)
//
// Table layout (shimmer_tpu_torch/ops/bvh8.py): one 128-float row per
// node.  Internal rows hold the 8 child boxes SoA in cols 0:48
// ([lox*8 | loy*8 | loz*8 | hix*8 | hiy*8 | hiz*8]) and per-slot valid
// flags in cols 88:96; leaf rows hold up to 8 triangles SoA in cols 0:72
// ([p0x*8 | p0y*8 | ... | p2z*8], or p0, e1, e2 for MT) and their
// BVH-sorted ids as exact floats in cols 72:80.  meta[r] = leaf_count |
// child_base << 4, and the children of a node occupy rows child_base + slot.
//
// The v1 stack holds `child_base << 8 | pending slot bits` entries; a visit
// peels the lowest pending bit of the top entry (the reference kernel's
// order).  All arithmetic is plain IEEE float32 in the same operand order
// as shapes/triangle.py (intersect_triangle, intersect_triangle_mt): the
// caller re-intersects the winning triangle in torch and the plain torch
// version must reproduce this hit decision, so the CUDA build uses
// -fmad=false (no FMA contraction) and the host build -ffp-contract=off.
//
// On the H100 the v1 body is bound by its chain of dependent row reads
// (each visit picks the next row; from L2 for the 39 MB bench table, often
// from HBM for the 152 MB 1.3M-triangle one) and by divergence between the
// rays of a warp, not by arithmetic: one 512-byte row per visit resolves 8
// boxes or 8 triangles, so the chain is as short as an 8-wide tree allows.
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

constexpr int kLeafWatertight = 0;
constexpr int kLeafMT = 1;
constexpr int kWinnerSlot = 0;
constexpr int kWinnerMinId = 1;

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

SHIMMER_HD int clamp_row(int r, int n_rows) {
  return r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
}

// The table entries a traversal reads, for the bound of its launch: when
// `touched` (2 * n_rows bytes) is not null, a visit of row r stores 1 at
// touched[r] and every read of meta[r] stores 1 at touched[n_rows + r].
// All stores write the same value, so threads may race on them.
SHIMMER_HD void touch_row(uint8_t* touched, int n_rows, int r) {
  if (touched != nullptr) {
    touched[r] = 1;
    touched[n_rows + r] = 1;
  }
}

SHIMMER_HD void touch_meta(uint8_t* touched, int n_rows, int r) {
  if (touched != nullptr) touched[n_rows + r] = 1;
}

// A ray and its loop invariants: guarded 1/d for the slab test, and the
// watertight permutation (|d|-max axis, ties to the lower axis) and shear.
struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float ix, iy, iz;
  int kz;
  float sx, sy, sz;
  bool dz_ok;
};

SHIMMER_HD Ray make_ray(float ox, float oy, float oz, float dx, float dy,
                        float dz) {
  Ray ray;
  ray.ox = ox; ray.oy = oy; ray.oz = oz;
  ray.dx = dx; ray.dy = dy; ray.dz = dz;
  ray.ix = 1.0f / (dx == 0.0f ? 1e-30f : dx);
  ray.iy = 1.0f / (dy == 0.0f ? 1e-30f : dy);
  ray.iz = 1.0f / (dz == 0.0f ? 1e-30f : dz);
  const float adx = dx < 0.0f ? -dx : dx;
  const float ady = dy < 0.0f ? -dy : dy;
  const float adz = dz < 0.0f ? -dz : dz;
  const bool is0 = (adx >= ady) && (adx >= adz);
  const bool is1 = !is0 && (ady >= adz);
  ray.kz = is0 ? 0 : (is1 ? 1 : 2);
  float pdx, pdy, pdz;
  permute_to_max_z(ray.kz, dx, dy, dz, pdx, pdy, pdz);
  ray.dz_ok = pdz != 0.0f;
  const float pdz_safe = ray.dz_ok ? pdz : 1.0f;
  ray.sx = -pdx / pdz_safe;
  ray.sy = -pdy / pdz_safe;
  ray.sz = 1.0f / pdz_safe;
  return ray;
}

// Slab test of an internal row's 8 child boxes against (0, t_best):
// returns the hit slot bits and each slot's entry distance in tn[].
SHIMMER_HD int slab_test8(const float* __restrict__ row, const Ray& ray,
                          float t_best, float* tn) {
  int hit_bits = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float t0x = (SHIMMER_LDG(row + 0 + k) - ray.ox) * ray.ix;
    const float t0y = (SHIMMER_LDG(row + 8 + k) - ray.oy) * ray.iy;
    const float t0z = (SHIMMER_LDG(row + 16 + k) - ray.oz) * ray.iz;
    const float t1x = (SHIMMER_LDG(row + 24 + k) - ray.ox) * ray.ix;
    const float t1y = (SHIMMER_LDG(row + 32 + k) - ray.oy) * ray.iy;
    const float t1z = (SHIMMER_LDG(row + 40 + k) - ray.oz) * ray.iz;
    const float tnk = fmax_(fmax_(fmin_(t0x, t1x), fmin_(t0y, t1y)),
                            fmin_(t0z, t1z));
    const float tfk = fmin_(fmin_(fmax_(t0x, t1x), fmax_(t0y, t1y)),
                            fmax_(t0z, t1z));
    const bool valid = SHIMMER_LDG(row + kColValid + k) > 0.0f;
    tn[k] = tnk;
    if (valid && tnk <= tfk * 1.0001f && tfk > 0.0f && tnk < t_best) {
      hit_bits |= 1 << k;
    }
  }
  return hit_bits;
}

// The reference's closing test on the scaled distance (both leaf forms).
SHIMMER_HD bool t_in_range(float ts, float det, float t_best) {
  return det < 0.0f ? (ts <= 1e-7f * det && ts > t_best * det)
                    : (ts >= 1e-7f * det && ts < t_best * det);
}

// Slot k of a leaf row against (0, t_best); on a hit, t is its distance.
template <int kLeaf>
SHIMMER_HD bool leaf_hit(const float* __restrict__ row, int k, const Ray& ray,
                         float t_best, float& t) {
  if (kLeaf == kLeafMT) {
    // traverse.py:234-253: leaf lanes hold (p0, e1, e2).
    const float p0x = SHIMMER_LDG(row + 0 + k);
    const float p0y = SHIMMER_LDG(row + 8 + k);
    const float p0z = SHIMMER_LDG(row + 16 + k);
    const float e1x = SHIMMER_LDG(row + 24 + k);
    const float e1y = SHIMMER_LDG(row + 32 + k);
    const float e1z = SHIMMER_LDG(row + 40 + k);
    const float e2x = SHIMMER_LDG(row + 48 + k);
    const float e2y = SHIMMER_LDG(row + 56 + k);
    const float e2z = SHIMMER_LDG(row + 64 + k);
    const float pvx = ray.dy * e2z - ray.dz * e2y;
    const float pvy = ray.dz * e2x - ray.dx * e2z;
    const float pvz = ray.dx * e2y - ray.dy * e2x;
    const float det = e1x * pvx + e1y * pvy + e1z * pvz;
    const float tvx = ray.ox - p0x;
    const float tvy = ray.oy - p0y;
    const float tvz = ray.oz - p0z;
    const float u_s = tvx * pvx + tvy * pvy + tvz * pvz;
    const float qvx = tvy * e1z - tvz * e1y;
    const float qvy = tvz * e1x - tvx * e1z;
    const float qvz = tvx * e1y - tvy * e1x;
    const float v_s = ray.dx * qvx + ray.dy * qvy + ray.dz * qvz;
    const float ts = e2x * qvx + e2y * qvy + e2z * qvz;
    const float w_s = det - u_s - v_s;
    const bool same_sign = (u_s >= 0.0f && v_s >= 0.0f && w_s >= 0.0f) ||
                           (u_s <= 0.0f && v_s <= 0.0f && w_s <= 0.0f);
    if (!(same_sign && det != 0.0f && t_in_range(ts, det, t_best))) {
      return false;
    }
    const float inv_det = 1.0f / det;
    t = ts * inv_det;
    return true;
  } else {
    float q0x, q0y, q0z, q1x, q1y, q1z, q2x, q2y, q2z;
    permute_to_max_z(ray.kz, SHIMMER_LDG(row + 0 + k) - ray.ox,
                     SHIMMER_LDG(row + 8 + k) - ray.oy,
                     SHIMMER_LDG(row + 16 + k) - ray.oz, q0x, q0y, q0z);
    permute_to_max_z(ray.kz, SHIMMER_LDG(row + 24 + k) - ray.ox,
                     SHIMMER_LDG(row + 32 + k) - ray.oy,
                     SHIMMER_LDG(row + 40 + k) - ray.oz, q1x, q1y, q1z);
    permute_to_max_z(ray.kz, SHIMMER_LDG(row + 48 + k) - ray.ox,
                     SHIMMER_LDG(row + 56 + k) - ray.oy,
                     SHIMMER_LDG(row + 64 + k) - ray.oz, q2x, q2y, q2z);
    const float x0 = q0x + ray.sx * q0z;
    const float y0 = q0y + ray.sy * q0z;
    const float x1 = q1x + ray.sx * q1z;
    const float y1 = q1y + ray.sy * q1z;
    const float x2 = q2x + ray.sx * q2z;
    const float y2 = q2y + ray.sy * q2z;
    const float e0 = difference_of_products(x1, y2, y1, x2);
    const float e1 = difference_of_products(x2, y0, y2, x0);
    const float e2 = difference_of_products(x0, y1, y0, x1);
    const bool same_sign = (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f) ||
                           (e0 <= 0.0f && e1 <= 0.0f && e2 <= 0.0f);
    const float det = e0 + e1 + e2;
    const float ts = e0 * (q0z * ray.sz) + e1 * (q1z * ray.sz) +
                     e2 * (q2z * ray.sz);
    if (!(same_sign && det != 0.0f && t_in_range(ts, det, t_best) &&
          ray.dz_ok)) {
      return false;
    }
    const float inv_det = 1.0f / det;
    t = ts * inv_det;
    return true;
  }
}

// The up to 8 triangles of a leaf row: updates (t_best, tri_best) and
// returns true when the leaf holds a closer hit.
template <int kLeaf, int kWinner>
SHIMMER_HD bool leaf_test8(const float* __restrict__ row, int cnt,
                           const Ray& ray, float& t_best, int& tri_best) {
  float t_leaf = INFINITY;
  float id_leaf = 0.0f;
  int k_leaf = -1;
  for (int k = 0; k < cnt && k < 8; ++k) {
    float t;
    if (!leaf_hit<kLeaf>(row, k, ray, t_best, t)) continue;
    if (kWinner == kWinnerMinId) {
      const float id = SHIMMER_LDG(row + kColIds + k);
      if (t < t_leaf || (t == t_leaf && id < id_leaf)) {
        t_leaf = t;
        id_leaf = id;
        k_leaf = k;
      }
    } else if (t < t_leaf) {
      t_leaf = t;
      k_leaf = k;
    }
  }
  if (!(t_leaf < t_best)) return false;
  t_best = t_leaf;
  tri_best = (int)SHIMMER_LDG(row + kColIds + k_leaf);
  return true;
}

template <int kLeaf, int kWinner>
SHIMMER_HD RayResult traverse_ray(const float* __restrict__ rows,
                                  const int* __restrict__ meta, int n_rows,
                                  float ox, float oy, float oz, float dx,
                                  float dy, float dz, float t_max,
                                  bool any_hit, uint8_t* touched) {
  RayResult res;
  res.t = INFINITY;
  res.tri = -1;
  res.steps = 0;
  // Dead lanes (t_max <= 0, including -inf and NaN) do not traverse.
  if (!(t_max > 0.0f)) return res;
  const Ray ray = make_ray(ox, oy, oz, dx, dy, dz);

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
    const int r = clamp_row((e >> 8) + lowest_bit_index(lsb), n_rows);
    ++steps;
    touch_row(touched, n_rows, r);
    const int m = SHIMMER_LDG(meta + r);
    const int cnt = m & 15;
    const float* row = rows + (size_t)r * kRowWidth;

    if (cnt == 0) {
      float tn[8];
      const int hit_bits = slab_test8(row, ray, t_best, tn);
      if (hit_bits != 0 && sp < kMaxStack) {
        stack[sp++] = ((m >> 4) << 8) | hit_bits;
      }
    } else if (leaf_test8<kLeaf, kWinner>(row, cnt, ray, t_best, tri_best) &&
               any_hit) {
      break;
    }
  }
  res.t = tri_best >= 0 ? t_best : INFINITY;
  res.tri = tri_best;
  res.steps = steps;
  return res;
}

}  // namespace shimmer
