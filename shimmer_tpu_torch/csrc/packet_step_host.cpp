// Test-only host build of the packet-step kernels' bodies
// (packet_step_body.cuh), and of the split form of the packet slab chase.
//
// The CPU tests compile this file with g++ (-ffp-contract=off) and call it
// through ctypes, so the kernels' own per-lane and per-packet steps are
// checked against the plain torch versions (ops/packet_step.py) on a
// machine without a GPU.  No entry point of the port loads it.  Arguments
// as packet_step.cu's entry points, less the stream; the lanes of a packet
// run one after another where the kernels run them side by side, and the
// packet's OR of hit bits is taken over all of them.  Each returns 0, or
// -1 for arguments the kernels do not take.

#include <vector>

#include "packet_step_body.cuh"

using namespace shimmer;
using namespace shimmer::packet;

namespace {

template <int kBody, bool kTransposed>
void chase_all(const float* table, int n_rows, const int* nxt,
               const float* rays, int steps, float* out) {
  int side_stack[kSideStack] = {0};
  for (int lane = 0; lane < kLanes; ++lane) {
    out[lane] = slab_chase_lane<kBody, kTransposed>(table, n_rows, nxt, rays,
                                                    lane, steps, side_stack);
  }
}

template <int kBody>
void chase_layout(bool transposed, const float* table, int n_rows,
                  const int* nxt, const float* rays, int steps, float* out) {
  if (transposed) {
    chase_all<kBody, true>(table, n_rows, nxt, rays, steps, out);
  } else {
    chase_all<kBody, false>(table, n_rows, nxt, rays, steps, out);
  }
}

// The split form of a slab or chain body, as the kernels compute it: the
// walk (from nxt staged as byte offsets, or from nxt) counting its visits
// of each row, the visited rows listed, then each slab-pass chunk of items
// summed per lane as count * hits in integers, and the total written as
// float.
template <int kBody, bool kTransposed>
void chase_split(const float* table, int n_rows, const int* nxt,
                 const float* rays, int steps, bool staged, float* out) {
  int side_stack[kSideStack] = {0};
  std::vector<int> visits(n_rows, 0), stage(n_rows);
  if (staged) stage_chain(nxt, n_rows, stage.data(), 0, 1);
  const int last =
      staged ? chase_walk<kBody, true>(nxt, stage.data(), n_rows, steps, visits.data(),
                                       side_stack)
             : chase_walk<kBody, false>(nxt, stage.data(), n_rows, steps, visits.data(),
                                        side_stack);
  if (kBody == kBodyEmpty || kBody == kBodyChase) {
    for (int lane = 0; lane < kLanes; ++lane) {
      out[lane] = kBody == kBodyChase ? static_cast<float>(last) : 0.0f;
    }
    return;
  }
  std::vector<int> rows, counts;
  for (int r = 0; r < n_rows; ++r) {
    if (visits[r] > 0) {
      rows.push_back(r);
      counts.push_back(visits[r]);
    }
  }
  const int items = kBody == kBodySlabFixed ? steps : static_cast<int>(rows.size());
  const int chunk = slab_chunk(slab_items(kBody, n_rows, steps));
  for (int lane = 0; lane < kLanes; ++lane) {
    int acc = 0;
    for (int first = 0; first < items; first += chunk) {
      const int end = first + chunk < items ? first + chunk : items;
      acc += items_hits<kBody, kTransposed>(table, n_rows, rows.data(), counts.data(), rays,
                                            lane, first, end);
    }
    out[lane] = static_cast<float>(acc);
  }
}

template <int kBody>
void split_layout(bool transposed, const float* table, int n_rows,
                  const int* nxt, const float* rays, int steps, bool staged,
                  float* out) {
  if (transposed) {
    chase_split<kBody, true>(table, n_rows, nxt, rays, steps, staged, out);
  } else {
    chase_split<kBody, false>(table, n_rows, nxt, rays, steps, staged, out);
  }
}

}  // namespace

// The split form of kernel A (slab, slab_stack, slab_fixed, empty, chase);
// staged: the walk reads nxt staged as byte offsets.  Any R: the kernel's
// limit on R (the visit counts in shared memory) is the wrapper's.
extern "C" int shimmer_packet_slab_chase_split_host(int body, int transposed,
                                                    const float* table,
                                                    int n_rows, const int* nxt,
                                                    const float* rays,
                                                    int steps, int staged,
                                                    float* out) {
  if (n_rows <= 0 || steps < 0 || steps > kChaseMaxSteps) return -1;
  const bool t = transposed != 0;
  const bool sg = staged != 0;
  switch (body) {
    case kBodySlab: split_layout<kBodySlab>(t, table, n_rows, nxt, rays, steps, sg, out); break;
    case kBodySlabStack: split_layout<kBodySlabStack>(t, table, n_rows, nxt, rays, steps, sg, out); break;
    case kBodyEmpty: split_layout<kBodyEmpty>(t, table, n_rows, nxt, rays, steps, sg, out); break;
    case kBodySlabFixed: split_layout<kBodySlabFixed>(t, table, n_rows, nxt, rays, steps, sg, out); break;
    case kBodyChase: split_layout<kBodyChase>(t, table, n_rows, nxt, rays, steps, sg, out); break;
    default: return -1;
  }
  return 0;
}

extern "C" int shimmer_packet_slab_chase_host(int body, int transposed,
                                              const float* table, int n_rows,
                                              const int* nxt,
                                              const float* rays, int steps,
                                              float* out) {
  if (n_rows <= 0 || steps < 0) return -1;
  const bool t = transposed != 0;
  switch (body) {
    case kBodySlab: chase_layout<kBodySlab>(t, table, n_rows, nxt, rays, steps, out); break;
    case kBodySlabStack: chase_layout<kBodySlabStack>(t, table, n_rows, nxt, rays, steps, out); break;
    case kBodyEmpty: chase_layout<kBodyEmpty>(t, table, n_rows, nxt, rays, steps, out); break;
    case kBodySlabFixed: chase_layout<kBodySlabFixed>(t, table, n_rows, nxt, rays, steps, out); break;
    case kBodyIntSum: chase_layout<kBodyIntSum>(t, table, n_rows, nxt, rays, steps, out); break;
    case kBodyChase: chase_layout<kBodyChase>(t, table, n_rows, nxt, rays, steps, out); break;
    case kBodyAcc: chase_layout<kBodyAcc>(t, table, n_rows, nxt, rays, steps, out); break;
    case kBodyAccScaled: chase_layout<kBodyAccScaled>(t, table, n_rows, nxt, rays, steps, out); break;
    default: return -1;
  }
  return 0;
}

extern "C" int shimmer_step_attrib_host(int variant, const float* rows,
                                        const int* meta, int n_rows,
                                        const float* rays, int programs,
                                        int packets, int steps, int stack_size,
                                        int* stack, float* out) {
  if (variant < 0 || variant >= kNumAttrib || n_rows <= 0 || programs < 0 ||
      packets < 1 || packets > kAttribMaxPackets || steps < 0 || stack_size < 1 ||
      stack_size > kAttribMaxStack) {
    return -1;
  }
  std::vector<Ray> ray(kLanes);
  std::vector<bool> want_any(kLanes);
  std::vector<float> t_best(kLanes), tri(kLanes), active(kLanes);
  for (int g = 0; g < programs; ++g) {
    for (int k = 0; k < packets; ++k) stack[k * stack_size] = 1;
    // Packets share nothing but their own stack rows, so each runs its
    // program's steps in turn.
    for (int k = 0; k < packets; ++k) {
      const int p = g * packets + k;
      int* st = stack + k * stack_size;
      for (int l = 0; l < kLanes; ++l) {
        bool w;
        ray[l] = attrib_ray(rays + (size_t)p * kAttribRayRows * kLanes, l, w);
        want_any[l] = w;
        t_best[l] = kAttribTInit;
        tri[l] = -1.0f;
        active[l] = 1.0f;
      }
      for (int i = 0; i < steps; ++i) {
        int r, cnt, m = 0, sp = 0;
        bool internal;
        if (variant == kAttribNoScalar) {
          r = static_cast<int>(static_cast<long long>(i) * (k + 3) % n_rows);
          cnt = r & 3;
          internal = (meta[r] & 15) == 0;
        } else {
          const AttribPop pop = attrib_pop(st, stack_size, i, n_rows);
          st[pop.sp] = pop.written;
          r = pop.r;
          sp = pop.sp;
          m = meta[r];
          cnt = m & 15;
          internal = cnt == 0;
        }
        int node = r;
        if (variant == kAttribNoRoll) {
          node = r & ~7;
          internal = (meta[node] & 15) == 0;
        }
        const float* row = rows + (size_t)node * kNodeWidth;
        int bits = kAttribConstBits;
        if (variant == kAttribFull || variant == kAttribNoRoll ||
            variant == kAttribNoLeaf) {
          bits = 0;
          for (int l = 0; l < kLanes; ++l) {
            bits |= attrib_internal_mask(row, internal, ray[l], t_best[l],
                                         active[l]);
          }
        }
        if (variant != kAttribNoScalar && bits != 0) {
          st[attrib_push_slot(sp, stack_size)] = attrib_push_word(m, bits);
        }
        if (variant != kAttribNoLeaf) {
          for (int l = 0; l < kLanes; ++l) {
            float tb = t_best[l], tr = tri[l], ac = active[l];
            attrib_leaf(row, internal, cnt, ray[l], want_any[l], tb, tr, ac);
            t_best[l] = tb;
            tri[l] = tr;
            active[l] = ac;
          }
        }
      }
      float* o = out + (size_t)p * kAttribOutRows * kLanes;
      for (int l = 0; l < kLanes; ++l) {
        o[l] = t_best[l];
        o[kLanes + l] = tri[l];
      }
      for (int c = 2 * kLanes; c < kAttribOutRows * kLanes; ++c) o[c] = 0.0f;
    }
  }
  return 0;
}

// Every program computes the same block: the host build computes it once
// and copies it.
extern "C" int shimmer_step_ablate_host(int variant, const int* meta,
                                        const float* tab, const int* tab_i,
                                        int n_rows, int programs, int steps,
                                        float* out) {
  if (variant < 0 || variant >= kNumAblate || n_rows < 2 ||
      (n_rows & (n_rows - 1)) != 0 || programs < 0 || steps < 0) {
    return -1;
  }
  std::vector<float> acc(8 * kLanes, 0.0f);
  int r = 1;
  for (int i = 0; i < steps; ++i) {
    const float* row = tab + (size_t)r * kNodeWidth;
    const int* wrow = tab_i + (size_t)r * kNodeWidth;
    if (variant == kAblateScalar) {
      for (float& a : acc) a = a + 1.0f;
      r = chase_next(meta, r, n_rows);
    } else if (variant == kAblateFetch32) {
      for (int l = 0; l < kLanes; ++l) {
        for (int j = 0; j < 8; ++j) acc[j * kLanes + l] = acc[j * kLanes + l] + row[j];
      }
      r = chase_next(meta, r, n_rows);
    } else {
      const bool slab = variant != kAblateCond || (r & 1) == 0;
      int bits = 0;
      for (int l = 0; l < kLanes; ++l) {
        float a[8];
        for (int j = 0; j < 8; ++j) a[j] = acc[j * kLanes + l];
        if (slab) {
          const int mask = ablate_slab(wrow, ablate_ox(l), a);
          if (variant == kAblateFetchBf) {
            for (int j = 0; j < 8; ++j) a[j] = a[j] + ((mask >> j) & 1 ? 1.0f : 0.0f);
          }
          bits |= mask;
        } else {
          bits = ablate_leaf(row, a);
        }
        for (int j = 0; j < 8; ++j) acc[j * kLanes + l] = a[j];
      }
      r = variant == kAblateFetchBf
              ? chase_next(meta, r, n_rows)
              : chase_next(meta, (r + bits) & (n_rows - 1), n_rows);
    }
  }
  for (int g = 0; g < programs; ++g) {
    for (int j = 0; j < 8; ++j) {
      for (int l = 0; l < kLanes; ++l) {
        out[((size_t)g * 8 + j) * kLanes + l] =
            acc[j * kLanes + l] + static_cast<float>(r);
      }
    }
  }
  return 0;
}

extern "C" int shimmer_step_attrib_max_packets() { return kAttribMaxPackets; }

extern "C" int shimmer_step_attrib_max_stack() { return kAttribMaxStack; }
