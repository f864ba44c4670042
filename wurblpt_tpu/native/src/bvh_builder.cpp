// Binned-SAH BVH builder producing a threaded (hit-link / miss-link) flat tree.
//
// Host-side native equivalent of the reference's SAH builder + flattener
// (/root/reference/libwurblpt/bvh.hpp:93-246), redesigned for the lockstep wavefront
// traversal in wurblpt_tpu/accel/traverse.py: nodes are emitted in DFS
// pre-order so that "advance on AABB hit" is simply `node + 1`, and each node
// carries a `miss_next` link (next pre-order node whose subtree does not
// contain this node). Leaves store up to `leaf_size` primitive slots in
// `prim_order`, padded to exactly `leaf_size` entries with -1 so the device
// traversal intersects a static-shape primitive tile per leaf.
//
// Exposed as a C ABI for ctypes (no pybind11 in this toolchain).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Box {
  float mn[3];
  float mx[3];
  void reset() {
    for (int a = 0; a < 3; ++a) {
      mn[a] = 3.0e37f;
      mx[a] = -3.0e37f;
    }
  }
  void grow(const Box &o) {
    for (int a = 0; a < 3; ++a) {
      mn[a] = std::min(mn[a], o.mn[a]);
      mx[a] = std::max(mx[a], o.mx[a]);
    }
  }
  void grow_point(const float *p) {
    for (int a = 0; a < 3; ++a) {
      mn[a] = std::min(mn[a], p[a]);
      mx[a] = std::max(mx[a], p[a]);
    }
  }
  float half_area() const {
    float dx = std::max(0.0f, mx[0] - mn[0]);
    float dy = std::max(0.0f, mx[1] - mn[1]);
    float dz = std::max(0.0f, mx[2] - mn[2]);
    return dx * dy + dy * dz + dz * dx;
  }
};

constexpr int kNumBins = 16;

struct BuildTask {
  int begin;
  int end;
  int parent_slot;  // index into nodes where this subtree's root goes (-1 = root)
};

struct Node {
  Box box;
  int prim_start;  // leaf: index into prim_order; inner: -1
  int prim_count;  // leaf: count; inner: 0
  int right_child; // inner: node index of right child (left child = self + 1)
};

}  // namespace

extern "C" {

// Returns the number of nodes written, or -1 on error.
//
// Inputs:  aabb_min/aabb_max/centroid: [n_prims * 3] floats.
// Outputs (caller-allocated, capacity 2*n_prims nodes / n_prims_padded prims):
//   node_min/node_max: [cap * 3]; prim_start/prim_count/miss_next: [cap];
//   prim_order: [n_leaf_slots] (filled length returned via *prim_order_len,
//   every leaf occupies exactly `leaf_size` slots, padded with -1).
int wurblpt_build_bvh(const float *aabb_min, const float *aabb_max,
                      const float *centroid, int n_prims, int leaf_size,
                      float *node_min, float *node_max, int *prim_start,
                      int *prim_count, int *miss_next, int *prim_order,
                      int *prim_order_len) {
  if (n_prims <= 0 || leaf_size <= 0) return -1;

  std::vector<int> perm(n_prims);
  for (int i = 0; i < n_prims; ++i) perm[i] = i;

  std::vector<Box> boxes(n_prims);
  for (int i = 0; i < n_prims; ++i) {
    std::memcpy(boxes[i].mn, aabb_min + 3 * i, 12);
    std::memcpy(boxes[i].mx, aabb_max + 3 * i, 12);
  }

  std::vector<Node> nodes;
  nodes.reserve(2 * (size_t)n_prims);
  std::vector<int> order;
  order.reserve((size_t)n_prims + leaf_size);

  // Iterative pre-order build with an explicit stack; children are pushed
  // right-first so the left subtree is emitted immediately after its parent.
  std::vector<BuildTask> stack;
  stack.push_back({0, n_prims, -1});

  while (!stack.empty()) {
    BuildTask task = stack.back();
    stack.pop_back();

    const int count = task.end - task.begin;
    const int self = (int)nodes.size();
    nodes.push_back(Node{});
    Node &node = nodes[self];
    if (task.parent_slot >= 0) nodes[task.parent_slot].right_child = self;

    node.box.reset();
    Box cbox;
    cbox.reset();
    for (int i = task.begin; i < task.end; ++i) {
      node.box.grow(boxes[perm[i]]);
      cbox.grow_point(centroid + 3 * perm[i]);
    }

    bool make_leaf = count <= leaf_size;
    int split = -1;
    if (!make_leaf) {
      // Binned SAH over the widest centroid axis (reference uses full-sweep
      // SAH on the longest axis, bvh.hpp:93-164; binning is the O(n) variant).
      int axis = 0;
      float ext[3];
      for (int a = 0; a < 3; ++a) ext[a] = cbox.mx[a] - cbox.mn[a];
      if (ext[1] > ext[axis]) axis = 1;
      if (ext[2] > ext[axis]) axis = 2;

      if (ext[axis] <= 1e-12f) {
        // Degenerate centroid spread: median split keeps the tree balanced.
        split = task.begin + count / 2;
      } else {
        Box bin_box[kNumBins];
        int bin_cnt[kNumBins];
        for (int b = 0; b < kNumBins; ++b) {
          bin_box[b].reset();
          bin_cnt[b] = 0;
        }
        const float scale = kNumBins / ext[axis];
        const float base = cbox.mn[axis];
        for (int i = task.begin; i < task.end; ++i) {
          int p = perm[i];
          int b = (int)((centroid[3 * p + axis] - base) * scale);
          b = std::min(std::max(b, 0), kNumBins - 1);
          bin_box[b].grow(boxes[p]);
          bin_cnt[b]++;
        }
        // Prefix/suffix sweep over bins.
        float right_area[kNumBins];
        int right_cnt[kNumBins];
        Box acc;
        acc.reset();
        int cnt = 0;
        for (int b = kNumBins - 1; b >= 1; --b) {
          acc.grow(bin_box[b]);
          cnt += bin_cnt[b];
          right_area[b] = acc.half_area();
          right_cnt[b] = cnt;
        }
        acc.reset();
        cnt = 0;
        float best_cost = 3.0e37f;
        int best_bin = -1;
        for (int b = 0; b < kNumBins - 1; ++b) {
          acc.grow(bin_box[b]);
          cnt += bin_cnt[b];
          if (cnt == 0 || right_cnt[b + 1] == 0) continue;
          float cost = acc.half_area() * cnt + right_area[b + 1] * right_cnt[b + 1];
          if (cost < best_cost) {
            best_cost = cost;
            best_bin = b;
          }
        }
        if (best_bin < 0) {
          split = task.begin + count / 2;
          std::nth_element(
              perm.begin() + task.begin, perm.begin() + split,
              perm.begin() + task.end, [&](int a, int b2) {
                return centroid[3 * a + axis] < centroid[3 * b2 + axis];
              });
        } else {
          const float cut = base + (best_bin + 1) / scale;
          int *mid = std::partition(
              perm.data() + task.begin, perm.data() + task.end,
              [&](int p) { return centroid[3 * p + axis] < cut; });
          split = (int)(mid - perm.data());
          if (split == task.begin || split == task.end)
            split = task.begin + count / 2;  // numeric edge: force progress
        }
      }
    }

    if (make_leaf) {
      node.prim_start = (int)order.size();
      node.prim_count = count;
      node.right_child = -1;
      for (int i = task.begin; i < task.end; ++i) order.push_back(perm[i]);
      for (int i = count; i < leaf_size; ++i) order.push_back(-1);
    } else {
      node.prim_start = -1;
      node.prim_count = 0;
      // Right child pushed first => left child is emitted next (pre-order).
      // Only the right child records its slot in the parent (parent_slot);
      // the left child is implicitly parent + 1.
      stack.push_back({split, task.end, self});
      stack.push_back({task.begin, split, -1});
    }
  }

  // Thread the tree: miss_next of node i is the next pre-order node that is
  // not in i's subtree. Compute with a stack of (node, parent_miss).
  const int n_nodes = (int)nodes.size();
  std::vector<int> miss(n_nodes, -1);
  {
    std::vector<std::pair<int, int>> st;
    st.push_back({0, -1});
    while (!st.empty()) {
      auto [ni, m] = st.back();
      st.pop_back();
      miss[ni] = m;
      const Node &nd = nodes[ni];
      if (nd.prim_count == 0 && nd.prim_start < 0) {
        int left = ni + 1;
        int right = nd.right_child;
        st.push_back({right, m});
        st.push_back({left, right});
      }
    }
  }

  for (int i = 0; i < n_nodes; ++i) {
    std::memcpy(node_min + 3 * i, nodes[i].box.mn, 12);
    std::memcpy(node_max + 3 * i, nodes[i].box.mx, 12);
    prim_start[i] = nodes[i].prim_start;
    prim_count[i] = nodes[i].prim_count;
    miss_next[i] = miss[i];
  }
  std::memcpy(prim_order, order.data(), order.size() * sizeof(int));
  *prim_order_len = (int)order.size();
  return n_nodes;
}

}  // extern "C"
