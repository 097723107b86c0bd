// Test-only host build of the traversal kernel's per-ray body.
//
// The CPU tests compile this file with g++ (-ffp-contract=off, no FMA) and
// call it through ctypes, so the kernel's own traversal logic
// (traverse_body.cuh) is checked against the plain torch version on a
// machine without a GPU.  The render path never loads it.

#include "traverse_body.cuh"

extern "C" void shimmer_traverse_host(const float* rows, const int* meta,
                                      int n_rows, const float* o,
                                      const float* d, const float* t_max,
                                      const uint8_t* any_hit, float* t_out,
                                      int* tri_out, int* steps_out, int n) {
  for (int i = 0; i < n; ++i) {
    const shimmer::RayResult r = shimmer::traverse_ray(
        rows, meta, n_rows, o[3 * i + 0], o[3 * i + 1], o[3 * i + 2],
        d[3 * i + 0], d[3 * i + 1], d[3 * i + 2], t_max[i], any_hit[i] != 0);
    t_out[i] = r.t;
    tri_out[i] = r.tri;
    steps_out[i] = r.steps;
  }
}

extern "C" int shimmer_traverse_max_stack() { return shimmer::kMaxStack; }
