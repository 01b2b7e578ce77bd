// Native wide-BVH mega-table builder for pathtracing_tpu.
//
// C++ twin of accel/wide.py's WideBuilder tree emission (byte-identical
// rows, golden-tested in tests/test_wide_native.py): collapses the
// reference-semantics binary octant link trees (reference: bvh.cc:170-226)
// into N-slot wide rows + L-triangle leaf chains + instance rows, exactly
// as the Python builder does. Python stays the semantic ground truth and
// the fallback; this exists because the full animated scene needs ~460k
// static rows once and ~64k TLAS-tail rows PER FRAME (scene.cc:271-718's
// per-frame TLAS rebuild), which takes minutes in Python and ~100 ms here.
//
// C ABI, consumed from Python via ctypes (accel/native.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <map>
#include <memory>

namespace {

using u32 = uint32_t;

constexpr u32 KIND_WIDE = 0u;
constexpr u32 KIND_LEAF = 1u;
constexpr u32 KIND_INST = 2u;
constexpr u32 RETURN_SENTINEL = (3u << 30) | 2u;
constexpr u32 INVALID = 0xFFFFFFFFu;
constexpr u32 LEAF_BIT = 0x80000000u;

struct Layout
{
    u32 n_slots, leaf_tris, slot_bits, w_row, stub;
    u32 links_col, exit_col, prims_col, next_col;

    // stub=1: leaf rows carry prim ids + next link only (no inline
    // vertices) — accel/wide.LAYOUT_S8; byte layout mirrored exactly
    static Layout make(u32 n_slots, u32 leaf_tris, u32 stub = 0)
    {
        Layout l;
        l.n_slots = n_slots;
        l.leaf_tris = leaf_tris;
        l.stub = stub;
        l.slot_bits = 3;
        while ((1u << l.slot_bits) < n_slots) l.slot_bits++;
        u32 need = 4 * n_slots + 1;
        u32 leaf_need = stub ? (leaf_tris + 2) : (10 * leaf_tris + 1);
        if (leaf_need > need) need = leaf_need;
        if (need < 21) need = 21;
        l.w_row = ((need + 1 + 7) / 8) * 8;
        l.links_col = 3 * n_slots;
        l.exit_col = 4 * n_slots;
        l.prims_col = stub ? 0 : 9 * leaf_tris;
        l.next_col = stub ? leaf_tris : 10 * leaf_tris;
        return l;
    }

    u32 cursor(u32 kind, u32 row, u32 slot = 0) const
    {
        return (kind << 30) | (row << slot_bits) | slot;
    }
};

static inline u32 f2u(float f) { u32 u; std::memcpy(&u, &f, 4); return u; }
static inline float u2f(u32 u) { float f; std::memcpy(&f, &u, 4); return f; }

// bf16 outward rounding, matching accel/wide._round_bf16 bit-for-bit.
static inline u32 round_bf16(float x, bool up)
{
    u32 bits = f2u(x);
    bool inexact = (bits & 0xFFFFu) != 0;
    u32 trunc = bits >> 16;
    bool neg = (bits >> 31) != 0;
    bool grow = inexact && (neg != up);
    return trunc + (grow ? 1u : 0u);
}

static void pack_slot_aabb(const float* bmin, const float* bmax, float* out3)
{
    u32 lo[3], hi[3];
    for (int i = 0; i < 3; i++) {
        lo[i] = round_bf16(bmin[i], false);
        hi[i] = round_bf16(bmax[i], true);
    }
    out3[0] = u2f((lo[0] << 16) | lo[1]);
    out3[1] = u2f((lo[2] << 16) | hi[0]);
    out3[2] = u2f((hi[1] << 16) | hi[2]);
}

// A slot candidate: one binary node or a contiguous DFS run of siblings
// (accel/wide._Group). Children are owned pointers into the group arena.
struct Group
{
    float bmin[3], bmax[3];
    std::vector<Group*> children;   // DFS order
    int32_t payload = -1;
    u32 tri_count = 0;

    bool is_leaf() const { return payload >= 0 && children.empty(); }
};

struct Builder
{
    Layout lay;
    u32 leaf_bundle;
    u32 base;
    std::vector<float> rows;                 // flat (K, w_row)
    // deferred exits: (row, kind) kind=0 copy_exit from src row
    struct Fixup { u32 row; u32 src; };
    std::vector<Fixup> fixups;
    std::vector<std::unique_ptr<Group>> arena;

    // leaf-chain cache: canonical sorted prim list -> first row id
    std::map<std::vector<int32_t>, u32> leaf_cache;

    const float* tri9 = nullptr;  // (T, 9) mesh-local vertices by prim id
    const u32* payload_cursor = nullptr;  // TLAS mode: payload -> cursor

    u32 n_rows() const { return base + (u32)(rows.size() / lay.w_row); }

    float* row(u32 rid) { return rows.data() + (size_t)(rid - base) * lay.w_row; }

    u32 alloc()
    {
        rows.resize(rows.size() + lay.w_row, 0.0f);
        return n_rows() - 1;
    }

    Group* new_group()
    {
        arena.emplace_back(new Group());
        return arena.back().get();
    }

    u32 n_nodes = 0;   // current tree's node count (cycle guard bound)

    // ---- binary tree reconstruction (accel/wide._binary_children /
    // _group_of; reference link layout: bvh.cc:170-226) ----
    // Depth guard: recursion depth equals the binary BVH depth; the Python
    // twin raises its recursion limit to 100000, so comparably deep trees
    // must not overflow the default 8 MB C stack and segfault the whole
    // process. Past MAX_DEPTH (~3 MB of frames) mark the tree corrupt
    // (payload -2) like the cycle guard: pt_wide_tree_create returns NULL
    // and the Python fallback takes over.
    static constexpr u32 MAX_DEPTH = 30000;

    Group* group_of(const u32* links, const float* nodes6, u32 v,
                    u32 depth = 0)
    {
        Group* g = new_group();
        if (depth > MAX_DEPTH) { g->payload = -2; return g; }
        const float* n6 = nodes6 + (size_t)v * 6;
        for (int i = 0; i < 3; i++) { g->bmin[i] = n6[i]; g->bmax[i] = n6[3 + i]; }
        u32 accept = links[2 * (size_t)v], cancel = links[2 * (size_t)v + 1];
        if (accept & LEAF_BIT) {
            g->payload = (int32_t)(accept & 0x7FFFFFFFu);
            g->tri_count = 1;
            return g;
        }
        u32 c = accept;
        size_t guard = 0;
        while (true) {
            Group* ch = group_of(links, nodes6, c, depth + 1);
            // corrupt link tables must fail cleanly, not spin (the Python
            // twin raises "cyclic link chain"); payload -2 marks the
            // corruption and propagates to the root, where the create
            // entry point returns NULL (Python fallback takes over)
            if (ch->payload == -2) { g->children.clear(); g->payload = -2; return g; }
            g->children.push_back(ch);
            u32 nxt = links[2 * (size_t)c + 1];
            if (nxt == cancel) break;
            if (++guard > n_nodes) { g->children.clear(); g->payload = -2; return g; }
            c = nxt;
        }
        for (Group* ch : g->children) g->tri_count += ch->tri_count;
        return g;
    }

    Group* split_group(const std::vector<Group*>& children, u32 lo, u32 hi)
    {
        if (hi - lo == 1) return children[lo];
        Group* g = new_group();
        for (int i = 0; i < 3; i++) { g->bmin[i] = children[lo]->bmin[i]; g->bmax[i] = children[lo]->bmax[i]; }
        for (u32 k = lo; k < hi; k++) {
            Group* c = children[k];
            for (int i = 0; i < 3; i++) {
                g->bmin[i] = std::fmin(g->bmin[i], c->bmin[i]);
                g->bmax[i] = std::fmax(g->bmax[i], c->bmax[i]);
            }
            g->children.push_back(c);
            g->tri_count += c->tri_count;
        }
        return g;
    }

    // accel/wide._expand_slots: breadth-first in-place expansion.
    void expand_slots(Group* root, std::vector<Group*>& slots)
    {
        slots.clear();
        const u32 S = lay.n_slots;
        if (root->children.empty()) { slots.push_back(root); return; }
        std::vector<u32> depth;
        if (root->children.size() > S) {
            // np.linspace(0, len, S+1).astype(int): step len/S is exact in
            // binary for power-of-two S, so plain double math matches
            u32 len = (u32)root->children.size();
            for (u32 i = 0; i < S; i++) {
                u32 a = (u32)((double)len * i / S);
                u32 b = (u32)((double)len * (i + 1) / S);
                if (a < b) slots.push_back(split_group(root->children, a, b));
            }
        } else {
            slots.assign(root->children.begin(), root->children.end());
        }
        depth.assign(slots.size(), 1);
        while (true) {
            int best = -1;
            u32 best_d = 0;
            for (size_t i = 0; i < slots.size(); i++) {
                Group* s = slots[i];
                if (s->is_leaf() || s->children.empty()) continue;
                size_t k = s->children.size();
                if (k <= S - slots.size() + 1) {
                    if (best < 0 || depth[i] < best_d) { best = (int)i; best_d = depth[i]; }
                }
            }
            if (best < 0) return;
            Group* s = slots[best];
            u32 d = best_d;
            slots.erase(slots.begin() + best);
            depth.erase(depth.begin() + best);
            slots.insert(slots.begin() + best, s->children.begin(), s->children.end());
            depth.insert(depth.begin() + best, s->children.size(), d + 1);
        }
    }

    void collect_prims(const Group* g, std::vector<int32_t>& out)
    {
        if (g->is_leaf()) { out.push_back(g->payload); return; }
        for (const Group* c : g->children) collect_prims(c, out);
    }

    // accel/wide.WideBuilder.build_leaf_chain (canonical sorted order,
    // cached so all 8 octants share one chain)
    u32 leaf_chain(std::vector<int32_t> prims)
    {
        std::sort(prims.begin(), prims.end());
        auto it = leaf_cache.find(prims);
        if (it != leaf_cache.end()) return it->second;
        u32 first = INVALID, prev = INVALID;
        const u32 L = lay.leaf_tris;
        for (size_t lo = 0; lo < prims.size(); lo += L) {
            u32 rid = alloc();
            float* r = row(rid);
            size_t cnt = std::min((size_t)L, prims.size() - lo);
            if (!lay.stub)
                for (size_t k = 0; k < cnt; k++)
                    std::memcpy(r + 9 * k, tri9 + (size_t)prims[lo + k] * 9, 9 * 4);
            for (u32 k = 0; k < L; k++) {
                int32_t pid = k < cnt ? prims[lo + k] : -1;
                std::memcpy(r + lay.prims_col + k, &pid, 4);
            }
            r[lay.next_col] = u2f(RETURN_SENTINEL);
            if (first == INVALID) first = rid;
            if (prev != INVALID)
                row(prev)[lay.next_col] = u2f(lay.cursor(KIND_LEAF, rid));
            prev = rid;
        }
        leaf_cache.emplace(std::move(prims), first);
        return first;
    }

    u32 leaf_target(const Group* g)
    {
        std::vector<int32_t> prims;
        collect_prims(g, prims);
        if (payload_cursor) {
            // TLAS mode: instance slots are never bundled
            return payload_cursor[prims[0]];
        }
        return lay.cursor(KIND_LEAF, leaf_chain(std::move(prims)));
    }

    // accel/wide.WideBuilder._emit_wide
    u32 emit_wide(Group* group, u32 exit_cursor)
    {
        u32 rid = alloc();
        std::vector<Group*> slots;
        expand_slots(group, slots);
        const u32 S = lay.n_slots;
        std::vector<u32> u(S, 0);
        {
            float* r = row(rid);
            for (u32 j = 0; j < S; j++) {
                if (j < slots.size()) {
                    pack_slot_aabb(slots[j]->bmin, slots[j]->bmax, r + 3 * j);
                } else {
                    float inf = INFINITY;
                    float mn[3] = {inf, inf, inf}, mx[3] = {-inf, -inf, -inf};
                    pack_slot_aabb(mn, mx, r + 3 * j);
                    u[j] = INVALID;
                }
            }
        }
        for (u32 j = 0; j < slots.size(); j++) {
            Group* s = slots[j];
            if (s->is_leaf() || (0 < s->tri_count && s->tri_count <= leaf_bundle)) {
                u[j] = leaf_target(s);
            } else {
                u32 child = emit_wide(s, exit_cursor);
                u[j] = lay.cursor(KIND_WIDE, child);
                if (j + 1 < slots.size())
                    row(child)[lay.exit_col] = u2f(lay.cursor(KIND_WIDE, rid, j + 1));
                else
                    fixups.push_back({child, rid});
            }
        }
        float* r = row(rid);  // re-fetch: recursion may have reallocated
        for (u32 j = 0; j < S; j++) r[lay.links_col + j] = u2f(u[j]);
        r[lay.exit_col] = u2f(exit_cursor);
        return rid;
    }

    void finalize()
    {
        // reverse order: ancestors' copy_exit fixups were appended after
        // their descendants', and descendants must copy a final exit
        for (auto it = fixups.rbegin(); it != fixups.rend(); ++it)
            row(it->row)[lay.exit_col] = row(it->src)[lay.exit_col];
        fixups.clear();
    }
};

struct Handle
{
    Builder b;
    u32 root8[8];
};

} // namespace

extern "C" {

// Build the 8 per-octant wide trees of ONE binary BVH (BLAS or TLAS) plus
// its shared leaf chains. links: (8n, 2) u32, octant o at rows [o*n, o*n+n).
// tri9: (T, 9) f32 mesh-local vertices (BLAS mode); payload_cursor:
// (P,) u32 payload->cursor map (TLAS mode; disables bundling). exit_sentinel
// = END_BLAS / END_TLAS. Returns an opaque handle (NULL on error).
// Generalization for the chunked static region (accel/chunks.py):
// root_node picks the binary subtree to emit (0 = whole tree) and exit8,
// when non-null, gives a PER-OCTANT exit cursor — the dynamic per-frame
// TLAS trees chain into the load-time static TLAS root of the same octant
// instead of terminating at END_TLAS.
// n_octants: 8 emits the classic per-octant trees; 1 emits ONLY octant
// 0's tree and aliases all 8 entry cursors to it — ~8x fewer interior
// rows (leaf chains were already shared), trading near-to-far traversal
// order for a much smaller gather working set (the v5e gather cost is a
// steep function of table footprint — BENCH_NOTES round 4). Hit SET is
// unchanged (strict confirms), so closest/any-hit results are identical
// up to exact-t ties.
void* pt_wide_subtree_create(
    const u32* links, const float* nodes6, u32 n,
    const float* tri9, const u32* payload_cursor,
    u32 leaf_bundle, u32 n_slots, u32 leaf_tris,
    u32 base_row, u32 exit_sentinel, u32 root_node, const u32* exit8,
    u32 n_octants, u32 stub)
{
    if (n == 0 || root_node >= n) return nullptr;
    if (n_octants != 1 && n_octants != 8) return nullptr;
    auto* h = new Handle();
    h->b.lay = Layout::make(n_slots, leaf_tris, stub);
    h->b.leaf_bundle = payload_cursor ? 0 : leaf_bundle;
    h->b.base = base_row;
    h->b.tri9 = tri9;
    h->b.payload_cursor = payload_cursor;
    h->b.n_nodes = n;
    for (u32 o = 0; o < n_octants; o++) {
        const u32* olinks = links + (size_t)o * n * 2;
        Group* root = h->b.group_of(olinks, nodes6, root_node);
        if (root->payload == -2) { delete h; return nullptr; }  // corrupt links
        u32 exit_cursor = exit8 ? exit8[o] : exit_sentinel;
        u32 rid = h->b.emit_wide(root, exit_cursor);
        h->root8[o] = h->b.lay.cursor(KIND_WIDE, rid);
        h->b.arena.clear();
    }
    for (u32 o = n_octants; o < 8; o++) h->root8[o] = h->root8[0];
    h->b.finalize();
    return h;
}

void* pt_wide_tree_create(
    const u32* links, const float* nodes6, u32 n,
    const float* tri9, const u32* payload_cursor,
    u32 leaf_bundle, u32 n_slots, u32 leaf_tris,
    u32 base_row, u32 exit_sentinel)
{
    return pt_wide_subtree_create(
        links, nodes6, n, tri9, payload_cursor, leaf_bundle, n_slots,
        leaf_tris, base_row, exit_sentinel, 0, nullptr, 8, 0);
}

int64_t pt_wide_rows_count(void* handle)
{
    auto* h = (Handle*)handle;
    return (int64_t)(h->b.rows.size() / h->b.lay.w_row);
}

void pt_wide_copy(void* handle, float* out_rows, u32* out_root8)
{
    auto* h = (Handle*)handle;
    std::memcpy(out_rows, h->b.rows.data(), h->b.rows.size() * 4);
    std::memcpy(out_root8, h->root8, 8 * 4);
}

void pt_wide_destroy(void* handle) { delete (Handle*)handle; }

} // extern "C"
