// Per-ray BVH8 traversal: the node tests shared by both kernels and the v1
// body.  Shared by the CUDA kernels (traverse.cu) and a host build
// (traverse_host.cpp) that the CPU tests compile with g++: under nvcc the
// functions are __device__, under g++ plain inline.
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
// The v1 body is V1Ray (16-byte row reads, near-first order with pruned
// pops), set out with its stack bound where it is defined; the scalar
// slab_test8 and leaf_test8 serve v2 (traverse_v2_body.cuh).  All
// arithmetic is plain IEEE float32 in the same operand order as
// shapes/triangle.py (intersect_triangle, intersect_triangle_mt): the
// caller re-intersects the winning triangle in torch and the plain torch
// version must reproduce this hit decision, so the CUDA build uses
// -fmad=false (no FMA contraction) and the host build -ffp-contract=off.
// The order of the visits changes which rows are read and when t_best
// tightens, not the closest t.
//
// On the H100 a v1 body is bound by its chain of dependent row reads (each
// visit picks the next row; from L2 for the 39 MB bench table, often from
// HBM for the 152 MB 1.3M-triangle one) and by how a warp's rays spread
// over rows and lifetimes, not by arithmetic: one 512-byte row per visit
// resolves 8 boxes or 8 triangles, so the chain is as short as an 8-wide
// tree allows.
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

// Slab test of one box against (0, t_best), with the reference's 1.0001
// slack on the exit distance; tn receives the entry distance.
SHIMMER_HD bool slab_hit(float lox, float loy, float loz, float hix,
                         float hiy, float hiz, const Ray& ray, float t_best,
                         float& tn) {
  const float t0x = (lox - ray.ox) * ray.ix;
  const float t0y = (loy - ray.oy) * ray.iy;
  const float t0z = (loz - ray.oz) * ray.iz;
  const float t1x = (hix - ray.ox) * ray.ix;
  const float t1y = (hiy - ray.oy) * ray.iy;
  const float t1z = (hiz - ray.oz) * ray.iz;
  tn = fmax_(fmax_(fmin_(t0x, t1x), fmin_(t0y, t1y)), fmin_(t0z, t1z));
  const float tf =
      fmin_(fmin_(fmax_(t0x, t1x), fmax_(t0y, t1y)), fmax_(t0z, t1z));
  return tn <= tf * 1.0001f && tf > 0.0f && tn < t_best;
}

// Slab test of an internal row's 8 child boxes against (0, t_best):
// returns the hit slot bits and each slot's entry distance in tn[].
SHIMMER_HD int slab_test8(const float* __restrict__ row, const Ray& ray,
                          float t_best, float* tn) {
  int hit_bits = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const bool hit = slab_hit(
        SHIMMER_LDG(row + 0 + k), SHIMMER_LDG(row + 8 + k),
        SHIMMER_LDG(row + 16 + k), SHIMMER_LDG(row + 24 + k),
        SHIMMER_LDG(row + 32 + k), SHIMMER_LDG(row + 40 + k), ray, t_best,
        tn[k]);
    const bool valid = SHIMMER_LDG(row + kColValid + k) > 0.0f;
    if (valid && hit) hit_bits |= 1 << k;
  }
  return hit_bits;
}

// The reference's closing test on the scaled distance (both leaf forms).
SHIMMER_HD bool t_in_range(float ts, float det, float t_best) {
  return det < 0.0f ? (ts <= 1e-7f * det && ts > t_best * det)
                    : (ts >= 1e-7f * det && ts < t_best * det);
}

// pbrt's watertight test of triangle (p0, p1, p2) against (0, t_best):
// translate to the ray origin, permute the |d|-max axis to z, shear; on a
// hit, t is its distance.
SHIMMER_HD bool watertight_hit(float p0x, float p0y, float p0z, float p1x,
                               float p1y, float p1z, float p2x, float p2y,
                               float p2z, const Ray& ray, float t_best,
                               float& t) {
  float q0x, q0y, q0z, q1x, q1y, q1z, q2x, q2y, q2z;
  permute_to_max_z(ray.kz, p0x - ray.ox, p0y - ray.oy, p0z - ray.oz, q0x, q0y,
                   q0z);
  permute_to_max_z(ray.kz, p1x - ray.ox, p1y - ray.oy, p1z - ray.oz, q1x, q1y,
                   q1z);
  permute_to_max_z(ray.kz, p2x - ray.ox, p2y - ray.oy, p2z - ray.oz, q2x, q2y,
                   q2z);
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
  const float ts =
      e0 * (q0z * ray.sz) + e1 * (q1z * ray.sz) + e2 * (q2z * ray.sz);
  if (!(same_sign && det != 0.0f && t_in_range(ts, det, t_best) &&
        ray.dz_ok)) {
    return false;
  }
  const float inv_det = 1.0f / det;
  t = ts * inv_det;
  return true;
}

// Moller-Trumbore test of the triangle (p0, p0 + e1, p0 + e2) against
// (0, t_best) (traverse.py:234-253: MT leaf lanes hold p0, e1, e2); on a
// hit, t is its distance.
SHIMMER_HD bool mt_hit(float p0x, float p0y, float p0z, float e1x, float e1y,
                       float e1z, float e2x, float e2y, float e2z,
                       const Ray& ray, float t_best, float& t) {
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
}

// Slot k of a leaf row against (0, t_best); on a hit, t is its distance.
template <int kLeaf>
SHIMMER_HD bool leaf_hit(const float* __restrict__ row, int k, const Ray& ray,
                         float t_best, float& t) {
  if (kLeaf == kLeafMT) {
    return mt_hit(
        SHIMMER_LDG(row + 0 + k), SHIMMER_LDG(row + 8 + k),
        SHIMMER_LDG(row + 16 + k), SHIMMER_LDG(row + 24 + k),
        SHIMMER_LDG(row + 32 + k), SHIMMER_LDG(row + 40 + k),
        SHIMMER_LDG(row + 48 + k), SHIMMER_LDG(row + 56 + k),
        SHIMMER_LDG(row + 64 + k), ray, t_best, t);
  } else {
    return watertight_hit(
        SHIMMER_LDG(row + 0 + k), SHIMMER_LDG(row + 8 + k),
        SHIMMER_LDG(row + 16 + k), SHIMMER_LDG(row + 24 + k),
        SHIMMER_LDG(row + 32 + k), SHIMMER_LDG(row + 40 + k),
        SHIMMER_LDG(row + 48 + k), SHIMMER_LDG(row + 56 + k),
        SHIMMER_LDG(row + 64 + k), ray, t_best, t);
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

// ---------------------------------------------------------------------------
// The v1 body, redesigned for Hopper (each step timed in PERF.md):
//   * 16-byte row reads: a row's box groups, valid flags and triangle groups
//     are read with load4 and tested with the same arithmetic as
//     slab_test8 and leaf_test8, which v2 keeps;
//   * near-first order: descend into the nearest hit child, push the other
//     hit children as one entry of slots in ascending entry distance, and
//     drop an entry on pop once its nearest child enters at or beyond
//     t_best;
//   * the stack is a local array of kMaxStack entries, pushed without a
//     guard (the bound is proved above V1Ray).
// V1Ray is a state machine (start, then step until it returns false), so
// that the host build can read the stack depth between visits.

// Four consecutive floats of a 16-byte aligned row: one 16-byte read-only
// load on the device.
SHIMMER_HD void load4(const float* __restrict__ p, float* out) {
#if defined(__CUDACC__)
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
#else
  for (int j = 0; j < 4; ++j) out[j] = p[j];
#endif
}

// slab_test8 with 16-byte reads: 12 loads for the six box groups and 2 for
// the valid flags, then the same slab_hit per slot.
SHIMMER_HD int slab_test8_vec(const float* __restrict__ row, const Ray& ray,
                              float t_best, float* tn) {
  float b[6][8];
  float valid[8];
#pragma unroll
  for (int g = 0; g < 6; ++g) {
    load4(row + 8 * g, b[g]);
    load4(row + 8 * g + 4, b[g] + 4);
  }
  load4(row + kColValid, valid);
  load4(row + kColValid + 4, valid + 4);
  int hit_bits = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const bool hit = slab_hit(b[0][k], b[1][k], b[2][k], b[3][k], b[4][k],
                              b[5][k], ray, t_best, tn[k]);
    if (valid[k] > 0.0f && hit) hit_bits |= 1 << k;
  }
  return hit_bits;
}

// leaf_test8 with 16-byte reads: per quad of slots that holds a triangle,
// 9 loads (one per coordinate group; 18 for a full leaf), then the same
// leaf test per slot in ascending slot order, so the winner is the one
// leaf_test8 picks.
template <int kLeaf, int kWinner>
SHIMMER_HD bool leaf_test8_vec(const float* __restrict__ row, int cnt,
                               const Ray& ray, float& t_best, int& tri_best) {
  float t_leaf = INFINITY;
  float id_leaf = 0.0f;
  int k_leaf = -1;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (4 * q >= cnt) break;
    float v[9][4];
#pragma unroll
    for (int g = 0; g < 9; ++g) load4(row + 8 * g + 4 * q, v[g]);
    float ids[4];
    if (kWinner == kWinnerMinId) load4(row + kColIds + 4 * q, ids);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * q + j;
      if (k >= cnt) break;
      float t;
      const bool hit =
          kLeaf == kLeafMT
              ? mt_hit(v[0][j], v[1][j], v[2][j], v[3][j], v[4][j], v[5][j],
                       v[6][j], v[7][j], v[8][j], ray, t_best, t)
              : watertight_hit(v[0][j], v[1][j], v[2][j], v[3][j], v[4][j],
                               v[5][j], v[6][j], v[7][j], v[8][j], ray,
                               t_best, t);
      if (!hit) continue;
      if (kWinner == kWinnerMinId) {
        if (t < t_leaf || (t == t_leaf && ids[j] < id_leaf)) {
          t_leaf = t;
          id_leaf = ids[j];
          k_leaf = k;
        }
      } else if (t < t_leaf) {
        t_leaf = t;
        k_leaf = k;
      }
    }
  }
  if (!(t_leaf < t_best)) return false;
  t_best = t_leaf;
  tri_best = (int)SHIMMER_LDG(row + kColIds + k_leaf);
  return true;
}

// The hit children of an internal row in ascending entry distance (ties to
// the lower slot): returns their slots, 3 bits each, nearest in the low
// bits; n receives their count and tn1 the second-nearest entry distance.
SHIMMER_HD int near_order(int hits, const float* tn, int& n, float& tn1) {
  int order = 0;
  n = 0;
  tn1 = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (!((hits >> k) & 1)) continue;
    int rank = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (((hits >> j) & 1) && (tn[j] < tn[k] || (tn[j] == tn[k] && j < k))) {
        ++rank;
      }
    }
    order |= k << (3 * rank);
    if (rank == 1) tn1 = tn[k];
    ++n;
  }
  return order;
}

// One stack entry: the pending hit children of an internal row.
struct NearEntry {
  int head;      // child_base << 4 | number of pending slots
  int slots;     // the pending slots, 3 bits each, nearest in the low bits
  float t_near;  // entry distance of the nearest slot when it was pushed
};

// The stack bound.  An entry is pushed at the visit of an internal node at
// level l and holds hit children at level l + 1; it stays until its last
// child is taken or it is dropped.  Invariant: the entries come from
// strictly increasing levels, all below the level of the row visited next.
// It holds at the start (empty stack, the root next); a push at level l
// finds only entries from levels below l and is followed by a visit at
// level l + 1; a pop takes its row from the top entry, so the next row lies
// one level below every remaining entry.  So the stack holds at most
// (deepest internal level + 1) entries, and the BVH8 build sets stack_depth
// = deepest internal level + 2, which the wrapper holds to kMaxStack - 8:
// a stack of kMaxStack entries never overflows, and step pushes without a
// guard.
template <int kLeaf, int kWinner>
struct V1Ray {
  Ray ray;
  float t_best;
  int tri_best;
  int steps;
  int sp;    // entries on the stack
  int next;  // the row the next step visits
  bool any_hit;

  // Sets up one ray; false for a dead lane (t_max <= 0, -inf or NaN),
  // which takes no step.
  SHIMMER_HD bool start(float ox, float oy, float oz, float dx, float dy,
                        float dz, float t_max, bool any_hit_) {
    t_best = t_max;
    tri_best = -1;
    steps = 0;
    sp = 0;
    next = 0;  // the root row
    any_hit = any_hit_;
    if (!(t_max > 0.0f)) return false;
    ray = make_ray(ox, oy, oz, dx, dy, dz);
    return true;
  }

  // The next row to visit from the stack, or -1 when it is empty.
  SHIMMER_HD int pop(NearEntry* stack, int n_rows) {
    while (sp > 0) {
      NearEntry& e = stack[sp - 1];
      // Every pending child of this entry enters at or beyond t_best: the
      // slab test would reject each of them now.
      if (!(e.t_near < t_best)) {
        --sp;
        continue;
      }
      const int row = (e.head >> 4) + (e.slots & 7);
      if ((e.head & 15) == 1) {
        --sp;
      } else {
        e.head -= 1;
        e.slots >>= 3;
      }
      return clamp_row(row, n_rows);
    }
    return -1;
  }

  // Visits one row; false once the ray is done (the stack is empty, or an
  // any-hit ray found a hit).  `stack` holds kMaxStack entries.
  SHIMMER_HD bool step(const float* __restrict__ rows,
                       const int* __restrict__ meta, int n_rows,
                       NearEntry* stack, uint8_t* touched) {
    const int r = next;
    ++steps;
    touch_row(touched, n_rows, r);
    const int m = SHIMMER_LDG(meta + r);
    const int cnt = m & 15;
    const float* row = rows + (size_t)r * kRowWidth;
    if (cnt == 0) {
      float tn[8];
      const int hits = slab_test8_vec(row, ray, t_best, tn);
      if (hits != 0) {
        const int base = m >> 4;
        int n;
        float tn1;
        const int order = near_order(hits, tn, n, tn1);
        if (n > 1) stack[sp++] = NearEntry{(base << 4) | (n - 1), order >> 3, tn1};
        next = clamp_row(base + (order & 7), n_rows);
        return true;
      }
    } else if (leaf_test8_vec<kLeaf, kWinner>(row, cnt, ray, t_best, tri_best) &&
               any_hit) {
      return false;
    }
    next = pop(stack, n_rows);
    return next >= 0;
  }

  SHIMMER_HD RayResult result() const {
    RayResult res;
    res.t = tri_best >= 0 ? t_best : INFINITY;
    res.tri = tri_best;
    res.steps = steps;
    return res;
  }
};

// Calls f.template run<kLeaf, kWinner>() for a v1 template (the kernel,
// traverse.cu, and the host build share it); false for a combination the
// kernel does not offer.
template <typename F>
bool dispatch_v1(int leaf, int winner, F& f) {
  if (winner != kWinnerSlot && winner != kWinnerMinId) return false;
  if (leaf == kLeafMT) {
    if (winner == kWinnerMinId) {
      f.template run<kLeafMT, kWinnerMinId>();
    } else {
      f.template run<kLeafMT, kWinnerSlot>();
    }
  } else if (leaf == kLeafWatertight) {
    if (winner == kWinnerMinId) {
      f.template run<kLeafWatertight, kWinnerMinId>();
    } else {
      f.template run<kLeafWatertight, kWinnerSlot>();
    }
  } else {
    return false;
  }
  return true;
}

}  // namespace shimmer
