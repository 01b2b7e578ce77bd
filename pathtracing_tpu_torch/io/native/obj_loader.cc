// Native OBJ/MTL loader for pathtracing_tpu.
//
// Fresh implementation with the same observable semantics as the reference
// parser (reference: mesh.cc:110-265) and as io/obj.py (golden-tested
// against both): v/vn/vt/f/usemtl/mtllib commands, exactly 3 face vertices
// per 'f' line, vertex dedup by (pos, tex, normal, material) in first-seen
// order, per-vertex material baking with the emission/transmission
// scalarization rules (reference: mesh.cc:241-252).
//
// C ABI consumed via ctypes (io/obj.py).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cctype>
#include <cmath>
#include <string>
#include <vector>
#include <unordered_map>

namespace {

struct Mtl
{
    std::string name;
    float albedo[3] = {1, 1, 1};
    float alpha = 0;
    float emission[3] = {0, 0, 0};
    float roughness = 1;
    float metallic = 0;
    float transmission[3] = {0, 0, 0};
};

static char* read_file(const char* path, size_t* out_size)
{
    FILE* f = fopen(path, "rb");
    if(!f) return nullptr;
    fseek(f, 0, SEEK_END);
    long sz = ftell(f);
    fseek(f, 0, SEEK_SET);
    char* data = (char*)malloc(sz + 1);
    if(fread(data, 1, sz, f) != (size_t)sz)
    {
        fclose(f);
        free(data);
        return nullptr;
    }
    data[sz] = 0;
    fclose(f);
    *out_size = sz;
    return data;
}

// Directive iterator: walks the buffer one whitespace-delimited directive
// line at a time and hands (directive, operand cursor) to the visitor.
// The cursor stays NUL-terminated at buffer end only, so numeric runs via
// strtof/strtol behave exactly like a single-pass parser on the same
// bytes (mesh semantics golden-tested against io/obj.py and the oracle).
template <typename Visit>
static void for_each_directive(char* buf, Visit&& visit)
{
    char* cur = buf;
    while(*cur)
    {
        while(isspace((unsigned char)*cur)) ++cur;
        char* tok = cur;
        while(*cur && !isspace((unsigned char)*cur)) ++cur;
        if(cur != tok)
        {
            std::string directive(tok, cur - tok);
            visit(directive, cur);
        }
        while(*cur && *cur != '\n') ++cur;
    }
}

static std::string next_word(char*& cur)
{
    while(isspace((unsigned char)*cur)) ++cur;
    char* tok = cur;
    while(*cur && !isspace((unsigned char)*cur)) ++cur;
    return std::string(tok, cur - tok);
}

static void read_floats(char*& cur, float* out, int count)
{
    for(int i = 0; i < count; ++i) out[i] = strtof(cur, &cur);
}

static bool load_mtl(std::vector<Mtl>& materials, const char* path)
{
    size_t sz;
    char* data = read_file(path, &sz);
    if(!data) return false;
    Mtl* mat = nullptr;
    for_each_directive(data, [&](const std::string& d, char*& cur) {
        if(d == "newmtl")
        {
            materials.push_back(Mtl{});
            materials.back().name = next_word(cur);
            mat = &materials.back();
            return;
        }
        if(!mat) return;
        if(d == "Kd") read_floats(cur, mat->albedo, 3);
        else if(d == "Ke") read_floats(cur, mat->emission, 3);
        else if(d == "d") read_floats(cur, &mat->alpha, 1);
        else if(d == "Pr") read_floats(cur, &mat->roughness, 1);
        else if(d == "Pm") read_floats(cur, &mat->metallic, 1);
        else if(d == "Tf") read_floats(cur, mat->transmission, 3);
    });
    free(data);
    return true;
}

struct Key
{
    int p, t, n, m;
    bool operator==(const Key& o) const
    {
        return p == o.p && t == o.t && n == o.n && m == o.m;
    }
};

struct KeyHash
{
    size_t operator()(const Key& k) const
    {
        uint64_t h = 1469598103934665603ull;
        for(int v : {k.p, k.t, k.n, k.m})
        {
            h ^= (uint64_t)(uint32_t)v;
            h *= 1099511628211ull;
        }
        return (size_t)h;
    }
};

}  // namespace

extern "C" {

struct pt_mesh_out
{
    uint32_t vertex_count;
    uint32_t triangle_count;
    uint32_t* indices;   // triangle_count*3
    float* pos;          // vertex_count*3
    float* normal;       // vertex_count*3
    float* albedo;       // vertex_count*4
    float* material;     // vertex_count*4
};

void pt_free_mesh(pt_mesh_out* out)
{
    free(out->indices);
    free(out->pos);
    free(out->normal);
    free(out->albedo);
    free(out->material);
    memset(out, 0, sizeof(*out));
}

// Returns 0 on success, nonzero on error.
int pt_load_obj(const char* obj_path, pt_mesh_out* out)
{
    memset(out, 0, sizeof(*out));
    size_t sz;
    char* data = read_file(obj_path, &sz);
    if(!data) return 1;

    std::string prefix(obj_path);
    size_t slash = prefix.find_last_of('/');
    prefix = slash == std::string::npos ? "" : prefix.substr(0, slash + 1);

    std::vector<float> positions;   // 3 per vertex
    std::vector<float> normals;     // 3 per vertex
    std::vector<Mtl> materials(1);  // default material at index 0
    std::vector<Key> face_groups;

    int active_material = 0;
    // one "p[/t[/n]]" corner of an 'f' directive (triangles only,
    // reference contract: mesh.hh:46-48)
    auto face_corner = [&](char*& cur) {
        Key k;
        k.m = active_material;
        k.p = (int)strtol(cur, &cur, 0) - 1;
        if(*cur == '/') ++cur;
        k.t = (int)strtol(cur, &cur, 0) - 1;
        if(*cur == '/') ++cur;
        k.n = (int)strtol(cur, &cur, 0) - 1;
        face_groups.push_back(k);
    };
    for_each_directive(data, [&](const std::string& d, char*& cur) {
        if(d == "v")
        {
            float p[3];
            read_floats(cur, p, 3);
            positions.insert(positions.end(), p, p + 3);
        }
        else if(d == "vn")
        {
            float n[3];
            read_floats(cur, n, 3);
            // normalize with the reference's op order (math.hh:94,106,110)
            float len = sqrtf(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
            for(float c : n) normals.push_back(c / len);
        }
        else if(d == "f")
        {
            for(int i = 0; i < 3; ++i) face_corner(cur);
        }
        else if(d == "usemtl")
        {
            std::string name = next_word(cur);
            for(size_t i = 0; i < materials.size(); ++i)
                if(materials[i].name == name)
                {
                    active_material = (int)i;
                    break;
                }
        }
        else if(d == "mtllib")
            load_mtl(materials, (prefix + next_word(cur)).c_str());
    });
    free(data);

    // Bake per-material vertex attributes (reference: mesh.cc:234-253).
    std::vector<float> baked_albedo(materials.size() * 4);
    std::vector<float> baked_material(materials.size() * 4);
    for(size_t i = 0; i < materials.size(); ++i)
    {
        const Mtl& m = materials[i];
        baked_albedo[i * 4 + 0] = m.albedo[0];
        baked_albedo[i * 4 + 1] = m.albedo[1];
        baked_albedo[i * 4 + 2] = m.albedo[2];
        baked_albedo[i * 4 + 3] = m.alpha;
        float scaled[3];
        for(int c = 0; c < 3; ++c)
        {
            float denom = fmaxf(m.albedo[c], m.emission[c]);
            float v = fmaxf(m.emission[c] / denom, 0.0f);
            scaled[c] = m.emission[c] == 0 ? 0.0f : v;
        }
        baked_material[i * 4 + 0] = m.roughness;
        baked_material[i * 4 + 1] = m.metallic;
        baked_material[i * 4 + 2] =
            fmaxf(m.transmission[0], fmaxf(m.transmission[1], m.transmission[2]));
        baked_material[i * 4 + 3] = fmaxf(scaled[0], fmaxf(scaled[1], scaled[2]));
    }

    uint32_t tri_count = (uint32_t)(face_groups.size() / 3);
    out->indices = (uint32_t*)malloc(face_groups.size() * 4);
    std::unordered_map<Key, uint32_t, KeyHash> dedup;
    dedup.reserve(face_groups.size());

    std::vector<float> pos_v, nrm_v, alb_v, mat_v;
    pos_v.reserve(face_groups.size() * 3);

    size_t n_pos = positions.size() / 3;
    size_t n_nrm = normals.size() / 3;
    for(size_t i = 0; i < face_groups.size(); ++i)
    {
        const Key& k = face_groups[i];
        auto it = dedup.find(k);
        uint32_t index;
        if(it != dedup.end())
            index = it->second;
        else
        {
            index = (uint32_t)dedup.size();
            dedup.emplace(k, index);
            if(k.p >= 0 && (size_t)k.p < n_pos)
            {
                pos_v.push_back(positions[k.p * 3 + 0]);
                pos_v.push_back(positions[k.p * 3 + 1]);
                pos_v.push_back(positions[k.p * 3 + 2]);
            }
            else { pos_v.insert(pos_v.end(), {0, 0, 0}); }
            if(k.n >= 0 && (size_t)k.n < n_nrm)
            {
                nrm_v.push_back(normals[k.n * 3 + 0]);
                nrm_v.push_back(normals[k.n * 3 + 1]);
                nrm_v.push_back(normals[k.n * 3 + 2]);
            }
            else { nrm_v.insert(nrm_v.end(), {0, 0, 0}); }
            if(k.m >= 0 && (size_t)k.m < materials.size())
            {
                for(int c = 0; c < 4; ++c)
                    alb_v.push_back(baked_albedo[k.m * 4 + c]);
                for(int c = 0; c < 4; ++c)
                    mat_v.push_back(baked_material[k.m * 4 + c]);
            }
            else
            {
                alb_v.insert(alb_v.end(), {0, 0, 0, 0});
                mat_v.insert(mat_v.end(), {0, 0, 0, 0});
            }
        }
        out->indices[i] = index;
    }

    uint32_t vcount = (uint32_t)dedup.size();
    out->vertex_count = vcount;
    out->triangle_count = tri_count;
    auto dup = [](const std::vector<float>& v) {
        float* p = (float*)malloc(v.size() * 4);
        memcpy(p, v.data(), v.size() * 4);
        return p;
    };
    out->pos = dup(pos_v);
    out->normal = dup(nrm_v);
    out->albedo = dup(alb_v);
    out->material = dup(mat_v);
    return 0;
}

}  // extern "C"
