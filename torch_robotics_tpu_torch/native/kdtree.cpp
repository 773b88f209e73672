// Incremental kd-tree for RRT nearest-neighbor queries (the port's copy of
// torch_robotics_tpu/native/kdtree.cpp; same algorithm, same results).
//
// Host-side native runtime component: the RRT-Connect planner's
// nearest-neighbor lookups are a data-dependent inner loop that no device
// batches (the tree grows one node at a time).  This kd-tree amortizes
// rebuilds (rebuild when the pending buffer exceeds half the tree) and
// linear-scans the pending inserts, giving O(log n + pending) queries vs the
// O(n d) scan per iteration.
//
// C ABI consumed via ctypes (torch_robotics_tpu_torch/native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct Node {
    int point;    // index into points
    int left;     // node indices, -1 = leaf
    int right;
    int axis;
};

struct KdTree {
    int dim;
    std::vector<float> points;     // size * dim
    std::vector<Node> nodes;
    int root = -1;
    std::vector<int> pending;      // inserted since last rebuild

    int size() const { return static_cast<int>(points.size()) / dim; }

    const float* pt(int i) const { return points.data() + i * dim; }

    float dist2(const float* a, const float* b) const {
        float s = 0.f;
        for (int k = 0; k < dim; ++k) {
            const float d = a[k] - b[k];
            s += d * d;
        }
        return s;
    }

    int build(std::vector<int>& idx, int lo, int hi, int depth) {
        if (lo >= hi) return -1;
        const int axis = depth % dim;
        const int mid = (lo + hi) / 2;
        std::nth_element(idx.begin() + lo, idx.begin() + mid,
                         idx.begin() + hi,
                         [&](int a, int b) { return pt(a)[axis] < pt(b)[axis]; });
        Node n;
        n.point = idx[mid];
        n.axis = axis;
        const int self = static_cast<int>(nodes.size());
        nodes.push_back(n);
        const int left = build(idx, lo, mid, depth + 1);
        const int right = build(idx, mid + 1, hi, depth + 1);
        nodes[self].left = left;
        nodes[self].right = right;
        return self;
    }

    void rebuild() {
        nodes.clear();
        pending.clear();
        const int n = size();
        std::vector<int> idx(n);
        for (int i = 0; i < n; ++i) idx[i] = i;
        root = build(idx, 0, n, 0);
    }

    void search(int node, const float* q, int& best, float& best_d2) const {
        if (node < 0) return;
        const Node& n = nodes[node];
        const float d2 = dist2(pt(n.point), q);
        if (d2 < best_d2) {
            best_d2 = d2;
            best = n.point;
        }
        const float delta = q[n.axis] - pt(n.point)[n.axis];
        const int near = delta < 0.f ? n.left : n.right;
        const int far = delta < 0.f ? n.right : n.left;
        search(near, q, best, best_d2);
        if (delta * delta < best_d2) search(far, q, best, best_d2);
    }

    int nearest(const float* q) const {
        int best = -1;
        float best_d2 = std::numeric_limits<float>::max();
        search(root, q, best, best_d2);
        for (const int i : pending) {
            const float d2 = dist2(pt(i), q);
            if (d2 < best_d2) {
                best_d2 = d2;
                best = i;
            }
        }
        return best;
    }
};

}  // namespace

extern "C" {

void* kd_create(int dim) {
    auto* t = new KdTree();
    t->dim = dim;
    return t;
}

void kd_destroy(void* h) { delete static_cast<KdTree*>(h); }

int kd_insert(void* h, const float* p) {
    auto* t = static_cast<KdTree*>(h);
    const int idx = t->size();
    t->points.insert(t->points.end(), p, p + t->dim);
    t->pending.push_back(idx);
    const int built = idx + 1 - static_cast<int>(t->pending.size());
    if (static_cast<int>(t->pending.size()) > std::max(64, built)) {
        t->rebuild();
    }
    return idx;
}

int kd_nearest(void* h, const float* q) {
    return static_cast<KdTree*>(h)->nearest(q);
}

int kd_size(void* h) { return static_cast<KdTree*>(h)->size(); }

void kd_get_point(void* h, int i, float* out) {
    auto* t = static_cast<KdTree*>(h);
    std::memcpy(out, t->pt(i), sizeof(float) * t->dim);
}

}  // extern "C"
