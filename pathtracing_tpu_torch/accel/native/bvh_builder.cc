// Native sweep-SAH BVH builder for pathtracing_tpu.
//
// Fresh implementation of the same algorithm the reference uses
// (reference: bvh.cc:43-229): full-sweep SAH over all three axes with
// deterministic centroid sorting (tie-break by leaf index), multi-leaf
// termination at leaf_count <= min_cost/root_area + 2, breadth-first node
// flattening, and eight per-octant stackless {accept, cancel} link tables.
// Output is bit-identical to the reference builder (golden-tested), laid out
// as packed arrays ready for TPU upload.
//
// C ABI, consumed from Python via ctypes (accel/native.py). Compile with
// -ffp-contract=off so float expression evaluation matches the IEEE oracle.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>
#include <cfloat>

namespace {

struct V3 { float x, y, z; };

static inline V3 vmin(V3 a, V3 b){ return {std::fmin(a.x,b.x), std::fmin(a.y,b.y), std::fmin(a.z,b.z)}; }
static inline V3 vmax(V3 a, V3 b){ return {std::fmax(a.x,b.x), std::fmax(a.y,b.y), std::fmax(a.z,b.z)}; }
static inline float pick(const V3& v, int axis){ return (&v.x)[axis]; }

struct Leaf { V3 mn, mx; uint32_t index; };

struct Node
{
    V3 mn, mx;
    uint32_t leaf_count;    // repurposed as primitive index for leaves
    int axis;
    uint32_t index;
    std::vector<Node> children;
};

static void sort_leaves(Leaf* begin, Leaf* end, int axis)
{
    std::sort(begin, end, [axis](const Leaf& a, const Leaf& b){
        float ac = pick(a.mx, axis) + pick(a.mn, axis);
        float bc = pick(b.mx, axis) + pick(b.mn, axis);
        if(ac < bc) return true;
        if(ac > bc) return false;
        return a.index < b.index;
    });
}

static float area_of(V3 mn, V3 mx)
{
    float sx = mx.x - mn.x, sy = mx.y - mn.y, sz = mx.z - mn.z;
    return sx * sy + sz * sx + sy * sz;
}

static void build_recursive_sah(Leaf* leaves, uint32_t n, Node& self)
{
    self.axis = -1;
    self.leaf_count = n;
    if(n == 1)
    {
        self.leaf_count = leaves[0].index;
        return;
    }

    float min_cost = FLT_MAX;
    uint32_t min_split = 0;
    V3 b0mn{}, b0mx{}, b1mn{}, b1mx{};

    std::vector<V3> fmn(n - 1), fmx(n - 1), smn(n - 1), smx(n - 1);

    for(int axis = 0; axis < 3; ++axis)
    {
        sort_leaves(leaves, leaves + n, axis);
        for(uint32_t i = 0; i < n - 1; ++i)
        {
            fmn[i] = i == 0 ? leaves[i].mn : vmin(fmn[i-1], leaves[i].mn);
            fmx[i] = i == 0 ? leaves[i].mx : vmax(fmx[i-1], leaves[i].mx);
            uint32_t inv = n - 1 - i;
            smn[inv-1] = i == 0 ? leaves[inv].mn : vmin(smn[inv], leaves[inv].mn);
            smx[inv-1] = i == 0 ? leaves[inv].mx : vmax(smx[inv], leaves[inv].mx);
        }
        for(uint32_t i = 0; i < n - 1; ++i)
        {
            float cost = (float)(i + 1) * area_of(fmn[i], fmx[i])
                       + (float)(n - 1 - i) * area_of(smn[i], smx[i]);
            if(cost < min_cost)
            {
                min_cost = cost;
                min_split = i + 1;
                self.axis = axis;
                b0mn = fmn[i]; b0mx = fmx[i];
                b1mn = smn[i]; b1mx = smx[i];
            }
        }
    }

    V3 size{self.mx.x - self.mn.x, self.mx.y - self.mn.y, self.mx.z - self.mn.z};
    float root_area = size.x * size.y + size.z * size.x + size.y * size.z;
    min_cost /= root_area;
    min_cost += 2.0f;  // traversal constant (reference: bvh.cc:110-112)

    bool make_leaves = (float)n <= min_cost;
    if(make_leaves)
    {
        self.axis = 2;
        if(size.x > size.y && size.x > size.z) self.axis = 0;
        else if(size.y > size.z) self.axis = 1;
    }

    sort_leaves(leaves, leaves + n, self.axis);

    if(make_leaves)
    {
        self.children.reserve(n);
        for(uint32_t i = 0; i < n; ++i)
        {
            Node child;
            child.mn = leaves[i].mn;
            child.mx = leaves[i].mx;
            child.leaf_count = leaves[i].index;
            child.axis = -1;
            self.children.push_back(std::move(child));
        }
    }
    else
    {
        self.children.resize(2);
        self.children[0].mn = b0mn; self.children[0].mx = b0mx;
        self.children[1].mn = b1mn; self.children[1].mx = b1mx;
        build_recursive_sah(leaves, min_split, self.children[0]);
        build_recursive_sah(leaves + min_split, n - min_split, self.children[1]);
    }
}

static uint32_t flatten_bfs(Node& root, float* out_nodes, uint32_t cap)
{
    uint32_t count = 0;
    std::vector<Node*> layer{&root}, next;
    while(!layer.empty())
    {
        for(Node* node : layer)
        {
            if(count >= cap) return UINT32_MAX;
            node->index = count;
            float* dst = out_nodes + count * 6;
            dst[0] = node->mn.x; dst[1] = node->mn.y; dst[2] = node->mn.z;
            dst[3] = node->mx.x; dst[4] = node->mx.y; dst[5] = node->mx.z;
            ++count;
            for(Node& c : node->children) next.push_back(&c);
        }
        layer.swap(next);
        next.clear();
    }
    return count;
}

static void save_links(
    const bool signs[3], const Node& branch, uint32_t cancel, uint32_t* links
){
    if(branch.children.empty())
    {
        links[branch.index * 2 + 0] = 0x80000000u | branch.leaf_count;
        links[branch.index * 2 + 1] = cancel;
        return;
    }
    bool reverse = !signs[branch.axis];
    uint32_t k = (uint32_t)branch.children.size();
    for(uint32_t i = 0; i < k; ++i)
    {
        const Node& child = branch.children[reverse ? k - 1 - i : i];
        if(i == 0)
        {
            links[branch.index * 2 + 0] = child.index;
            links[branch.index * 2 + 1] = cancel;
        }
        uint32_t next_index = cancel;
        if(i < k - 1)
            next_index = branch.children[reverse ? k - 2 - i : i + 1].index;
        save_links(signs, child, next_index, links);
    }
}

}  // namespace

extern "C" {

// Builds a BVH over n leaves. out_nodes has room for cap*6 floats, out_links
// for 8*cap*2 uint32. Returns the node count, or -1 if cap was too small.
// Octant o's link table for node i is out_links[(o*count + i)*2 .. +1].
int64_t pt_build_bvh(
    const float* leaf_min,
    const float* leaf_max,
    const uint32_t* leaf_idx,
    uint32_t n,
    float* out_nodes,
    uint32_t* out_links,
    uint32_t cap
){
    if(n == 0) return 0;
    std::vector<Leaf> leaves(n);
    Node root;
    root.mn = {FLT_MAX, FLT_MAX, FLT_MAX};
    root.mx = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for(uint32_t i = 0; i < n; ++i)
    {
        leaves[i].mn = {leaf_min[i*3], leaf_min[i*3+1], leaf_min[i*3+2]};
        leaves[i].mx = {leaf_max[i*3], leaf_max[i*3+1], leaf_max[i*3+2]};
        leaves[i].index = leaf_idx[i];
        root.mn = vmin(root.mn, leaves[i].mn);
        root.mx = vmax(root.mx, leaves[i].mx);
    }

    build_recursive_sah(leaves.data(), n, root);

    uint32_t count = flatten_bfs(root, out_nodes, cap);
    if(count == UINT32_MAX) return -1;

    for(int o = 0; o < 8; ++o)
    {
        const bool signs[3] = {bool(o & 1), bool(o & 2), bool(o & 4)};
        save_links(signs, root, 0xFFFFFFFFu, out_links + (size_t)o * count * 2);
    }
    return (int64_t)count;
}

}  // extern "C"
