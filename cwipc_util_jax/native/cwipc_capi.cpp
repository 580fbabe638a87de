/* Native implementation of the cwipc_util_jax C ABI.
 *
 * Fresh C++17 implementation of the contract documented in cwipc_capi.h
 * (behavioral parity with the reference's libcwipc_util: same struct
 * layouts, file formats and function semantics — reference:
 * src/cwipc_util.cpp, src/cwipc_filters.cpp, src/cwipc_synthetic.cpp,
 * src/cwipc_capturer.cpp, src/logging.cpp — no PCL: points are a flat
 * std::vector<cwipc_point>, the voxel grid is a hash map, kNN uses the
 * same spatial-hash-grid design as the JAX device path).
 */

#include "cwipc_capi.h"

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <deque>
#include <fstream>
#include <limits>
#include <map>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

/* ------------------------------------------------------------------ */
/* logging + error capture                                             */
/* ------------------------------------------------------------------ */

static std::mutex log_mutex;
// atomics: _cwipc_log_emit reads these concurrently with
// cwipc_log_configure's writes (an unsynchronized read is a data race)
static std::atomic<int> log_level{CWIPC_LOG_LEVEL_WARNING};
static std::atomic<cwipc_log_callback_t> log_callback{nullptr};
static thread_local char **current_errorbuf = nullptr;
static std::chrono::steady_clock::time_point log_start =
    std::chrono::steady_clock::now();

static void set_errorbuf(char **buf) { current_errorbuf = buf; }

extern "C" void _cwipc_log_emit(int level, const char *module, const char *message) {
    if (level == CWIPC_LOG_LEVEL_ERROR && current_errorbuf && *current_errorbuf == nullptr) {
        std::string full = std::string(module) + ": " + message;
        *current_errorbuf = strdup(full.c_str());
    }
    if (level > log_level) return;
    double t = std::chrono::duration<double>(std::chrono::steady_clock::now() - log_start).count();
    static const char *names[] = {"None", "Error", "Warning", "Trace", "Debug"};
    const char *name = (level >= 0 && level <= 4) ? names[level] : "?";
    char buf[1024];
    snprintf(buf, sizeof(buf), "t=%.3f: %s: %s: %s", t, module, name, message);
    std::lock_guard<std::mutex> lock(log_mutex);
    cwipc_log_callback_t cb = log_callback.load();
    if (cb) {
        cb(level, buf);
    } else {
        fprintf(stderr, "%s\n", buf);
    }
}

extern "C" void cwipc_log_configure(int level, cwipc_log_callback_t callback) {
    std::lock_guard<std::mutex> lock(log_mutex);
    log_level = level;
    log_callback = callback;
}

extern "C" const char *cwipc_get_version(void) { return "cwipc_util_jax 0.1.0"; }

static bool check_api_version(const char *who, uint64_t apiVersion, char **errorMessage) {
    if (apiVersion < CWIPC_API_VERSION_OLD || apiVersion > CWIPC_API_VERSION) {
        if (errorMessage) {
            char *msg = (char *)malloc(256);
            snprintf(msg, 256, "%s: incorrect apiVersion 0x%llx", who,
                     (unsigned long long)apiVersion);
            *errorMessage = msg;
        }
        return false;
    }
    return true;
}

/* ------------------------------------------------------------------ */
/* allocation tracking (leak oracle)                                    */
/* ------------------------------------------------------------------ */

static std::atomic<int> n_alloc{0}, n_dealloc{0};

extern "C" int cwipc_dangling_allocations(int log) {
    int dangling = n_alloc.load() - n_dealloc.load();
    if (log && dangling != 0) {
        char buf[128];
        snprintf(buf, sizeof(buf), "%d free() mismatch. nAlloc=%d, nFree=%d",
                 dangling, n_alloc.load(), n_dealloc.load());
        _cwipc_log_emit(CWIPC_LOG_LEVEL_WARNING, "cwipc_pointcloud", buf);
    }
    return dangling < 0 ? -dangling : dangling;
}

/* ------------------------------------------------------------------ */
/* metadata                                                            */
/* ------------------------------------------------------------------ */

struct cwipc_metadata {
    struct Item {
        std::string name, description;
        std::vector<uint8_t> data;
    };
    std::vector<Item> items;
};

extern "C" int cwipc_metadata_count(cwipc_metadata *md) {
    return md ? (int)md->items.size() : 0;
}
// bounds-checked by hand: a C++ exception (vector::at) must never cross
// the extern "C" ABI boundary — out-of-range indexes return NULL/0
static bool md_idx_ok(cwipc_metadata *md, int idx) {
    return md && idx >= 0 && (size_t)idx < md->items.size();
}
extern "C" const char *cwipc_metadata_name(cwipc_metadata *md, int idx) {
    return md_idx_ok(md, idx) ? md->items[idx].name.c_str() : nullptr;
}
extern "C" const char *cwipc_metadata_description(cwipc_metadata *md, int idx) {
    return md_idx_ok(md, idx) ? md->items[idx].description.c_str() : nullptr;
}
extern "C" size_t cwipc_metadata_size(cwipc_metadata *md, int idx) {
    return md_idx_ok(md, idx) ? md->items[idx].data.size() : 0;
}
extern "C" const void *cwipc_metadata_pointer(cwipc_metadata *md, int idx) {
    return md_idx_ok(md, idx) ? md->items[idx].data.data() : nullptr;
}
extern "C" void cwipc_metadata_add(cwipc_metadata *md, const char *name,
                                   const char *description, const void *data,
                                   size_t size) {
    cwipc_metadata::Item item;
    item.name = name ? name : "";
    item.description = description ? description : "";
    item.data.assign((const uint8_t *)data, (const uint8_t *)data + size);
    md->items.push_back(std::move(item));
}
extern "C" void cwipc_metadata__move(cwipc_metadata *src, cwipc_metadata *dest) {
    if (!src || !dest || src == dest) return;
    for (auto &item : src->items) dest->items.push_back(std::move(item));
    src->items.clear();
}

/* ------------------------------------------------------------------ */
/* point cloud object                                                   */
/* ------------------------------------------------------------------ */

struct cwipc_pointcloud {
    std::vector<cwipc_point> points;
    uint64_t timestamp = 0;
    float cellsize = 0;
    cwipc_metadata *metadata = nullptr;

    cwipc_pointcloud() { n_alloc++; }
    ~cwipc_pointcloud() {
        delete metadata;
        n_dealloc++;
    }
};

extern "C" cwipc_pointcloud *cwipc_from_points(struct cwipc_point *points,
                                               size_t size, int npoint,
                                               uint64_t timestamp,
                                               char **errorMessage,
                                               uint64_t apiVersion) {
    if (!check_api_version("cwipc_from_points", apiVersion, errorMessage)) return nullptr;
    if ((size_t)npoint * sizeof(cwipc_point) != size) {
        set_errorbuf(errorMessage);
        _cwipc_log_emit(CWIPC_LOG_LEVEL_ERROR, "cwipc_from_points", "inconsistent size");
        set_errorbuf(nullptr);
        return nullptr;
    }
    auto *pc = new cwipc_pointcloud();
    pc->points.assign(points, points + npoint);
    pc->timestamp = timestamp;
    return pc;
}

extern "C" void cwipc_pointcloud_free(cwipc_pointcloud *pc) { delete pc; }
extern "C" cwipc_pointcloud *cwipc_pointcloud__shallowcopy(cwipc_pointcloud *pc) {
    auto *rv = new cwipc_pointcloud();
    rv->points = pc->points;
    rv->timestamp = pc->timestamp;
    rv->cellsize = pc->cellsize;
    return rv;
}
extern "C" uint64_t cwipc_pointcloud_timestamp(cwipc_pointcloud *pc) { return pc->timestamp; }
extern "C" float cwipc_pointcloud_cellsize(cwipc_pointcloud *pc) { return pc->cellsize; }
extern "C" void cwipc_pointcloud__set_timestamp(cwipc_pointcloud *pc, uint64_t ts) { pc->timestamp = ts; }

extern "C" void cwipc_pointcloud__set_cellsize(cwipc_pointcloud *pc, float cellsize) {
    if (cellsize < 0 && !pc->points.empty()) {
        /* Reference quirk preserved (src/cwipc_util.cpp:176-204): the guess
         * is the minimum distance from any point to the FIRST point. */
        float minDistance = INFINITY;
        const auto &p0 = pc->points[0];
        for (size_t i = 1; i < pc->points.size(); i++) {
            const auto &p = pc->points[i];
            float dx = p.x - p0.x, dy = p.y - p0.y, dz = p.z - p0.z;
            float d = sqrtf(dx * dx + dy * dy + dz * dz);
            if (d < minDistance) minDistance = d;
        }
        cellsize = std::isinf(minDistance) ? 0 : minDistance;
    }
    pc->cellsize = cellsize;
}

extern "C" int cwipc_pointcloud_count(cwipc_pointcloud *pc) {
    return pc ? (int)pc->points.size() : 0;
}
extern "C" size_t cwipc_pointcloud_get_uncompressed_size(cwipc_pointcloud *pc) {
    return pc->points.size() * sizeof(cwipc_point);
}
extern "C" int cwipc_pointcloud_copy_uncompressed(cwipc_pointcloud *pc,
                                                  struct cwipc_point *points,
                                                  size_t size) {
    size_t need = pc->points.size() * sizeof(cwipc_point);
    if (size < need) return -1;
    memcpy(points, pc->points.data(), need);
    return (int)pc->points.size();
}

extern "C" size_t cwipc_pointcloud_copy_packet(cwipc_pointcloud *pc,
                                               uint8_t *packet, size_t size) {
    size_t dataSize = pc->points.size() * sizeof(cwipc_point);
    size_t needed = sizeof(cwipc_cwipcdump_header) + dataSize;
    if (packet == nullptr) return needed;
    if (size != needed) return 0;
    cwipc_cwipcdump_header hdr;
    memcpy(hdr.hdr, CWIPC_CWIPCDUMP_HEADER, 4);
    hdr.magic = CWIPC_CWIPCDUMP_VERSION;
    hdr.timestamp = pc->timestamp;
    hdr.cellsize = pc->cellsize;
    hdr.unused = 0;
    hdr.size = dataSize;
    memcpy(packet, &hdr, sizeof(hdr));
    memcpy(packet + sizeof(hdr), pc->points.data(), dataSize);
    return needed;
}

extern "C" cwipc_pointcloud *cwipc_from_packet(uint8_t *packet, size_t size,
                                               char **errorMessage,
                                               uint64_t apiVersion) {
    if (!check_api_version("cwipc_from_packet", apiVersion, errorMessage)) return nullptr;
    set_errorbuf(errorMessage);
    if (size < sizeof(cwipc_cwipcdump_header)) {
        _cwipc_log_emit(CWIPC_LOG_LEVEL_ERROR, "cwipc_from_packet", "packet too short");
        set_errorbuf(nullptr);
        return nullptr;
    }
    cwipc_cwipcdump_header hdr;
    memcpy(&hdr, packet, sizeof(hdr));
    if (memcmp(hdr.hdr, CWIPC_CWIPCDUMP_HEADER, 4) != 0 || hdr.magic != CWIPC_CWIPCDUMP_VERSION) {
        _cwipc_log_emit(CWIPC_LOG_LEVEL_ERROR, "cwipc_from_packet", "bad header");
        set_errorbuf(nullptr);
        return nullptr;
    }
    if (hdr.size != size - sizeof(hdr) || hdr.size % sizeof(cwipc_point) != 0) {
        _cwipc_log_emit(CWIPC_LOG_LEVEL_ERROR, "cwipc_from_packet", "inconsistent size");
        set_errorbuf(nullptr);
        return nullptr;
    }
    auto *pc = new cwipc_pointcloud();
    size_t n = hdr.size / sizeof(cwipc_point);
    pc->points.resize(n);
    memcpy(pc->points.data(), packet + sizeof(hdr), hdr.size);
    pc->timestamp = hdr.timestamp;
    pc->cellsize = hdr.cellsize;
    set_errorbuf(nullptr);
    return pc;
}

extern "C" cwipc_metadata *cwipc_pointcloud_access_metadata(cwipc_pointcloud *pc) {
    if (!pc->metadata) pc->metadata = new cwipc_metadata();
    return pc->metadata;
}

/* ------------------------------------------------------------------ */
/* PLY I/O                                                             */
/* ------------------------------------------------------------------ */

extern "C" int cwipc_write_ext(const char *filename, cwipc_pointcloud *pc,
                               int flag, char **errorMessage) {
    set_errorbuf(errorMessage);
    std::ofstream fp(filename, std::ios::binary);
    if (!fp) {
        _cwipc_log_emit(CWIPC_LOG_LEVEL_ERROR, "cwipc_write", "cannot open file");
        set_errorbuf(nullptr);
        return -1;
    }
    bool binary = (flag & CWIPC_FLAG_BINARY) != 0;
    fp << "ply\nformat " << (binary ? "binary_little_endian" : "ascii")
       << " 1.0\ncomment Created by cwipc_util_jax native\nelement vertex "
       << pc->points.size()
       << "\nproperty float x\nproperty float y\nproperty float z\n"
          "property uchar red\nproperty uchar green\nproperty uchar blue\n"
          "property uchar alpha\nend_header\n";
    if (binary) {
        for (const auto &p : pc->points) {
            fp.write((const char *)&p.x, 12);
            fp.write((const char *)&p.r, 4);
        }
    } else {
        char line[160];
        for (const auto &p : pc->points) {
            snprintf(line, sizeof(line), "%.9g %.9g %.9g %d %d %d %d\n", p.x, p.y,
                     p.z, p.r, p.g, p.b, p.tile);
            fp << line;
        }
    }
    fp.close();  /* flush BEFORE the status check: a disk-full failure
                  * in the destructor would otherwise report success */
    set_errorbuf(nullptr);
    return fp.good() ? 0 : -1;
}

extern "C" int cwipc_write(const char *filename, cwipc_pointcloud *pc,
                           char **errorMessage) {
    return cwipc_write_ext(filename, pc, 0, errorMessage);
}

struct PlyProperty {
    std::string name, type;
};

static int ply_type_size(const std::string &t) {
    if (t == "char" || t == "uchar" || t == "int8" || t == "uint8") return 1;
    if (t == "short" || t == "ushort" || t == "int16" || t == "uint16") return 2;
    if (t == "int" || t == "uint" || t == "int32" || t == "uint32" || t == "float" || t == "float32") return 4;
    if (t == "double" || t == "float64") return 8;
    return 0;
}

static double ply_read_binary_value(const uint8_t *p, const std::string &t) {
    if (t == "char" || t == "int8") return *(const int8_t *)p;
    if (t == "uchar" || t == "uint8") return *(const uint8_t *)p;
    if (t == "short" || t == "int16") return *(const int16_t *)p;
    if (t == "ushort" || t == "uint16") return *(const uint16_t *)p;
    if (t == "int" || t == "int32") return *(const int32_t *)p;
    if (t == "uint" || t == "uint32") return *(const uint32_t *)p;
    if (t == "float" || t == "float32") { float f; memcpy(&f, p, 4); return f; }
    if (t == "double" || t == "float64") { double d; memcpy(&d, p, 8); return d; }
    return 0;
}

extern "C" cwipc_pointcloud *cwipc_read(const char *filename, uint64_t timestamp,
                                        char **errorMessage, uint64_t apiVersion) {
    if (!check_api_version("cwipc_read", apiVersion, errorMessage)) return nullptr;
    set_errorbuf(errorMessage);
    std::ifstream fp(filename, std::ios::binary);
    if (!fp) {
        _cwipc_log_emit(CWIPC_LOG_LEVEL_ERROR, "cwipc_read", "cannot open file");
        set_errorbuf(nullptr);
        return nullptr;
    }
    std::string line;
    std::getline(fp, line);
    if (line != "ply" && line != "ply\r") {
        _cwipc_log_emit(CWIPC_LOG_LEVEL_ERROR, "cwipc_read", "not a PLY file");
        set_errorbuf(nullptr);
        return nullptr;
    }
    std::string format;
    size_t vertex_count = 0;
    std::vector<PlyProperty> props;
    bool in_vertex = false;
    while (std::getline(fp, line)) {
        if (!line.empty() && line.back() == '\r') line.pop_back();
        std::istringstream ss(line);
        std::string kw;
        ss >> kw;
        if (kw == "format") { ss >> format; }
        else if (kw == "element") {
            std::string name; size_t cnt; ss >> name >> cnt;
            in_vertex = (name == "vertex");
            if (in_vertex) vertex_count = cnt;
        } else if (kw == "property" && in_vertex) {
            PlyProperty p; ss >> p.type >> p.name;
            props.push_back(p);
        } else if (kw == "end_header") break;
    }
    int ix = -1, iy = -1, iz = -1, ir = -1, ig = -1, ib = -1, ia = -1;
    for (size_t i = 0; i < props.size(); i++) {
        const auto &n = props[i].name;
        if (n == "x") ix = (int)i;
        else if (n == "y") iy = (int)i;
        else if (n == "z") iz = (int)i;
        else if (n == "red" || n == "r") ir = (int)i;
        else if (n == "green" || n == "g") ig = (int)i;
        else if (n == "blue" || n == "b") ib = (int)i;
        else if (n == "alpha" || n == "tile" || n == "mask") ia = (int)i;
    }
    if (ix < 0 || iy < 0 || iz < 0) {
        _cwipc_log_emit(CWIPC_LOG_LEVEL_ERROR, "cwipc_read", "PLY lacks x/y/z");
        set_errorbuf(nullptr);
        return nullptr;
    }
    auto *pc = new cwipc_pointcloud();
    pc->points.resize(vertex_count);
    pc->timestamp = timestamp;
    if (format == "ascii") {
        for (size_t v = 0; v < vertex_count; v++) {
            std::vector<double> vals(props.size());
            for (size_t i = 0; i < props.size(); i++)
                if (!(fp >> vals[i])) { delete pc; set_errorbuf(nullptr); return nullptr; }
            auto &p = pc->points[v];
            p.x = (float)vals[ix]; p.y = (float)vals[iy]; p.z = (float)vals[iz];
            p.r = ir >= 0 ? (uint8_t)vals[ir] : 0;
            p.g = ig >= 0 ? (uint8_t)vals[ig] : 0;
            p.b = ib >= 0 ? (uint8_t)vals[ib] : 0;
            p.tile = ia >= 0 ? (uint8_t)vals[ia] : 0;
        }
    } else if (format == "binary_little_endian") {
        size_t stride = 0;
        std::vector<size_t> offsets(props.size());
        for (size_t i = 0; i < props.size(); i++) {
            offsets[i] = stride;
            stride += ply_type_size(props[i].type);
        }
        std::vector<uint8_t> row(stride);
        for (size_t v = 0; v < vertex_count; v++) {
            fp.read((char *)row.data(), stride);
            if (!fp) { delete pc; set_errorbuf(nullptr); return nullptr; }
            auto &p = pc->points[v];
            p.x = (float)ply_read_binary_value(row.data() + offsets[ix], props[ix].type);
            p.y = (float)ply_read_binary_value(row.data() + offsets[iy], props[iy].type);
            p.z = (float)ply_read_binary_value(row.data() + offsets[iz], props[iz].type);
            p.r = ir >= 0 ? (uint8_t)ply_read_binary_value(row.data() + offsets[ir], props[ir].type) : 0;
            p.g = ig >= 0 ? (uint8_t)ply_read_binary_value(row.data() + offsets[ig], props[ig].type) : 0;
            p.b = ib >= 0 ? (uint8_t)ply_read_binary_value(row.data() + offsets[ib], props[ib].type) : 0;
            p.tile = ia >= 0 ? (uint8_t)ply_read_binary_value(row.data() + offsets[ia], props[ia].type) : 0;
        }
    } else {
        _cwipc_log_emit(CWIPC_LOG_LEVEL_ERROR, "cwipc_read", "unsupported PLY format");
        delete pc;
        set_errorbuf(nullptr);
        return nullptr;
    }
    set_errorbuf(nullptr);
    return pc;
}

extern "C" int cwipc_write_debugdump(const char *filename, cwipc_pointcloud *pc,
                                     char **errorMessage) {
    set_errorbuf(errorMessage);
    std::ofstream fp(filename, std::ios::binary);
    if (!fp) {
        _cwipc_log_emit(CWIPC_LOG_LEVEL_ERROR, "cwipc_write_debugdump", "cannot open file");
        set_errorbuf(nullptr);
        return -1;
    }
    size_t needed = cwipc_pointcloud_copy_packet(pc, nullptr, 0);
    std::vector<uint8_t> buf(needed);
    cwipc_pointcloud_copy_packet(pc, buf.data(), needed);
    fp.write((const char *)buf.data(), needed);
    fp.close();  /* flush BEFORE the status check: a disk-full failure
                  * in the destructor would otherwise report success */
    set_errorbuf(nullptr);
    return fp.good() ? 0 : -1;
}

extern "C" cwipc_pointcloud *cwipc_read_debugdump(const char *filename,
                                                  char **errorMessage,
                                                  uint64_t apiVersion) {
    if (!check_api_version("cwipc_read_debugdump", apiVersion, errorMessage)) return nullptr;
    set_errorbuf(errorMessage);
    std::ifstream fp(filename, std::ios::binary);
    if (!fp) {
        _cwipc_log_emit(CWIPC_LOG_LEVEL_ERROR, "cwipc_read_debugdump", "cannot open file");
        set_errorbuf(nullptr);
        return nullptr;
    }
    std::vector<uint8_t> data((std::istreambuf_iterator<char>(fp)),
                              std::istreambuf_iterator<char>());
    set_errorbuf(nullptr);
    return cwipc_from_packet(data.data(), data.size(), errorMessage, apiVersion);
}

/* ------------------------------------------------------------------ */
/* operators (hash-grid voxel + kNN; no PCL)                            */
/* ------------------------------------------------------------------ */

struct VoxelKey {
    int32_t x, y, z;
    bool operator==(const VoxelKey &o) const { return x == o.x && y == o.y && z == o.z; }
};
struct VoxelKeyHash {
    size_t operator()(const VoxelKey &k) const {
        /* spread the 3 coordinates over 64 bits */
        uint64_t h = (uint64_t)(uint32_t)k.x * 73856093u ^
                     (uint64_t)(uint32_t)k.y * 19349663u ^
                     (uint64_t)(uint32_t)k.z * 83492791u;
        return (size_t)h;
    }
};

static cwipc_pointcloud *clone_meta(cwipc_pointcloud *src) {
    auto *pc = new cwipc_pointcloud();
    pc->timestamp = src->timestamp;
    pc->cellsize = src->cellsize;
    return pc;
}

extern "C" cwipc_pointcloud *cwipc_downsample(cwipc_pointcloud *pc, float cellsize) {
    if (!pc) return nullptr;
    cellsize = fabsf(cellsize);
    if (pc->cellsize >= cellsize) cellsize = pc->cellsize;
    if (cellsize <= 0.0f) {
        /* zero-size voxels: no-op copy (1/cellsize would be inf and the
         * int cast of inf is undefined behavior) */
        auto *copy = clone_meta(pc);
        copy->points = pc->points;
        return copy;
    }
    struct Acc {
        double x = 0, y = 0, z = 0, r = 0, g = 0, b = 0;
        uint32_t n = 0;
        uint8_t tile = 0;
    };
    std::unordered_map<VoxelKey, Acc, VoxelKeyHash> grid;
    grid.reserve(pc->points.size());
    float inv = 1.0f / cellsize;
    for (const auto &p : pc->points) {
        VoxelKey k{(int32_t)floorf(p.x * inv), (int32_t)floorf(p.y * inv),
                   (int32_t)floorf(p.z * inv)};
        auto &a = grid[k];
        a.x += p.x; a.y += p.y; a.z += p.z;
        a.r += p.r; a.g += p.g; a.b += p.b;
        a.tile |= p.tile;
        a.n++;
    }
    auto *rv = clone_meta(pc);
    rv->cellsize = cellsize;
    rv->points.reserve(grid.size());
    for (const auto &kv : grid) {
        const Acc &a = kv.second;
        cwipc_point p;
        p.x = (float)(a.x / a.n); p.y = (float)(a.y / a.n); p.z = (float)(a.z / a.n);
        p.r = (uint8_t)(a.r / a.n); p.g = (uint8_t)(a.g / a.n); p.b = (uint8_t)(a.b / a.n);
        p.tile = a.tile;
        rv->points.push_back(p);
    }
    return rv;
}

extern "C" cwipc_pointcloud *cwipc_tilefilter(cwipc_pointcloud *pc, int tile) {
    if (!pc) return nullptr;
    auto *rv = clone_meta(pc);
    for (const auto &p : pc->points)
        if (tile == 0 || tile == p.tile) rv->points.push_back(p);
    return rv;
}

extern "C" cwipc_pointcloud *cwipc_tilemap(cwipc_pointcloud *pc, uint8_t map[256]) {
    if (!pc) return nullptr;
    auto *rv = clone_meta(pc);
    rv->points = pc->points;
    for (auto &p : rv->points) p.tile = map[p.tile];
    return rv;
}

extern "C" cwipc_pointcloud *cwipc_crop(cwipc_pointcloud *pc, float bbox[6]) {
    if (!pc) return nullptr;
    auto *rv = clone_meta(pc);
    for (const auto &p : pc->points) {
        if (bbox[0] <= p.x && p.x < bbox[1] && bbox[2] <= p.y && p.y < bbox[3] &&
            bbox[4] <= p.z && p.z < bbox[5])
            rv->points.push_back(p);
    }
    return rv;
}

extern "C" cwipc_pointcloud *cwipc_colormap(cwipc_pointcloud *pc,
                                            uint32_t clearBits, uint32_t setBits) {
    if (!pc) return nullptr;
    auto *rv = clone_meta(pc);
    rv->points = pc->points;
    for (auto &p : rv->points) {
        /* PCL packed layout: tile<<24 | r<<16 | g<<8 | b */
        uint32_t rgba = ((uint32_t)p.tile << 24) | ((uint32_t)p.r << 16) |
                        ((uint32_t)p.g << 8) | p.b;
        rgba = (rgba & ~clearBits) | setBits;
        p.tile = (rgba >> 24) & 0xFF;
        p.r = (rgba >> 16) & 0xFF;
        p.g = (rgba >> 8) & 0xFF;
        p.b = rgba & 0xFF;
    }
    return rv;
}

extern "C" cwipc_pointcloud *cwipc_join(cwipc_pointcloud *pc1, cwipc_pointcloud *pc2) {
    if (!pc1 || !pc2) return nullptr;
    auto *rv = new cwipc_pointcloud();
    rv->points = pc1->points;
    rv->points.insert(rv->points.end(), pc2->points.begin(), pc2->points.end());
    rv->timestamp = std::min(pc1->timestamp, pc2->timestamp);
    rv->cellsize = std::min(pc1->cellsize, pc2->cellsize);
    return rv;
}

/* statistical outlier removal: grid-bucketed kNN mean distances, global
 * mean/stddev threshold (PCL semantics; same algorithm shape as the
 * device path in ops/outliers.py). */
static std::vector<float> mean_knn_distances(const std::vector<cwipc_point> &pts, int k,
                                             float spacing_hint = 0.0f) {
    size_t n = pts.size();
    std::vector<float> md(n, 0.0f);
    if (n < 2) return md;
    /* k < 1 (e.g. atoi of a junk CLI argument) would index before
     * begin() in nth_element and divide by zero below */
    if (k < 1) k = 1;
    /* Grid cell size from the typical point spacing: the cloud's cellsize
     * when known, else a sampled median nearest-neighbor distance.  The
     * nearest neighbor of each sample is searched among ALL points — the
     * previous sample-vs-sample search overestimated spacing ~sqrt(n/256)x
     * on surfaces, inflating cells (and kNN candidate counts) by 1000x+. */
    double spacing = 0.01;
    if (spacing_hint > 0) {
        spacing = spacing_hint;
    } else {
        size_t step = std::max<size_t>(1, n / 256);
        std::vector<float> samples;
        for (size_t i = 0; i < n; i += step) {
            float best = INFINITY;
            for (size_t j = 0; j < n; j++) {
                if (i == j) continue;
                float dx = pts[i].x - pts[j].x, dy = pts[i].y - pts[j].y, dz = pts[i].z - pts[j].z;
                best = std::min(best, dx * dx + dy * dy + dz * dz);
            }
            if (std::isfinite(best)) samples.push_back(sqrtf(best));
        }
        if (!samples.empty()) {
            std::nth_element(samples.begin(), samples.begin() + samples.size() / 2, samples.end());
            spacing = std::max(1e-6f, samples[samples.size() / 2]);
        }
    }
    /* Sorted-grid layout (same design as the device search, ops/knn.py): sort
     * point indices by packed cell key once, then neighbor cells are
     * contiguous ranges found by binary search — no hash map churn. */
    float cell = (float)(spacing * std::max(2.0, sqrt((double)k) / 1.5));
    float inv = 1.0f / cell;
    int32_t minc[3] = {INT32_MAX, INT32_MAX, INT32_MAX};
    std::vector<int32_t> cx(n), cy(n), cz(n);
    for (uint32_t i = 0; i < n; i++) {
        cx[i] = (int32_t)floorf(pts[i].x * inv);
        cy[i] = (int32_t)floorf(pts[i].y * inv);
        cz[i] = (int32_t)floorf(pts[i].z * inv);
        minc[0] = std::min(minc[0], cx[i]);
        minc[1] = std::min(minc[1], cy[i]);
        minc[2] = std::min(minc[2], cz[i]);
    }
    auto key_of = [&](int32_t x, int32_t y, int32_t z) -> uint64_t {
        uint64_t ux = (uint32_t)(x - minc[0]) & 0xFFFFF;
        uint64_t uy = (uint32_t)(y - minc[1]) & 0xFFFFF;
        uint64_t uz = (uint32_t)(z - minc[2]) & 0xFFFFF;
        return (ux << 40) | (uy << 20) | uz;
    };
    std::vector<uint64_t> keys(n);
    std::vector<uint32_t> order(n);
    for (uint32_t i = 0; i < n; i++) {
        keys[i] = key_of(cx[i], cy[i], cz[i]);
        order[i] = i;
    }
    std::sort(order.begin(), order.end(),
              [&](uint32_t a, uint32_t b) { return keys[a] < keys[b]; });
    std::vector<uint64_t> skeys(n);
    for (uint32_t i = 0; i < n; i++) skeys[i] = keys[order[i]];

    /* EXACT kNN by shell expansion: collect candidates from cell shells
     * of growing Chebyshev radius R and stop once the k-th best distance
     * is within the radius the searched shells GUARANTEE to cover
     * (R*cell) — the same exactness contract as a KD-tree query, with the
     * worst case degrading gracefully on adversarial input.  (The old
     * fixed 3x3x3 ring with surrogate distances for missing neighbors was
     * silently wrong whenever the true k-th neighbor fell outside the
     * ring — at bench-cloud density, a third of all points.) */
    std::vector<float> d2s;
    d2s.reserve(1024);
    /* a generous cap keeps adversarial clouds from scanning everything */
    int max_R = 1;
    while ((2 * max_R + 1) * (2 * max_R + 1) * (2 * max_R + 1) < (int64_t)n && max_R < 1024)
        max_R++;
    for (uint32_t i = 0; i < n; i++) {
        const auto &p = pts[i];
        d2s.clear();
        double kth = std::numeric_limits<double>::infinity();
        bool certified = false;
        for (int R = 1; R <= max_R; R++) {
            /* shell: cells with Chebyshev distance exactly R (R==1 also
             * includes the center cell) */
            for (int dx = -R; dx <= R; dx++)
                for (int dy = -R; dy <= R; dy++)
                    for (int dz = -R; dz <= R; dz++) {
                        int ch = std::max({abs(dx), abs(dy), abs(dz)});
                        if (R == 1 ? ch > 1 : ch != R) continue;
                        uint64_t nk = key_of(cx[i] + dx, cy[i] + dy, cz[i] + dz);
                        auto lo = std::lower_bound(skeys.begin(), skeys.end(), nk);
                        auto hi = std::upper_bound(lo, skeys.end(), nk);
                        for (auto it = lo; it != hi; ++it) {
                            uint32_t j = order[it - skeys.begin()];
                            if (j == i) continue;
                            float ddx = p.x - pts[j].x, ddy = p.y - pts[j].y, ddz = p.z - pts[j].z;
                            d2s.push_back(ddx * ddx + ddy * ddy + ddz * ddz);
                        }
                    }
            if ((int)d2s.size() >= k) {
                std::nth_element(d2s.begin(), d2s.begin() + (k - 1), d2s.end());
                kth = sqrt((double)d2s[k - 1]);
                /* searched shells cover every point within R*cell of p */
                if (kth <= (double)R * cell) { certified = true; break; }
            }
        }
        if (!certified) {
            /* shells exhausted without the coverage guarantee (isolated
             * point, or a k-th neighbor beyond max_R shells): brute
             * force for exactness.  A deficit divided by k would bias
             * md toward 0 and KEEP exactly the flying pixels this
             * filter exists to remove; an uncertified k-th from the
             * shell subset could overestimate and remove good points. */
            d2s.clear();
            for (uint32_t j = 0; j < n; j++) {
                if (j == i) continue;
                float ddx = p.x - pts[j].x, ddy = p.y - pts[j].y, ddz = p.z - pts[j].z;
                d2s.push_back(ddx * ddx + ddy * ddy + ddz * ddz);
            }
        }
        int kk = std::min<int>(k, (int)d2s.size());
        double sum = 0;
        if (kk > 0) {
            std::nth_element(d2s.begin(), d2s.begin() + (kk - 1), d2s.end());
            for (int j = 0; j < kk; j++) sum += sqrt((double)d2s[j]);
        }
        md[i] = (float)(sum / k);
    }
    return md;
}

static void remove_outliers_into(const std::vector<cwipc_point> &pts, int k,
                                 float mult, std::vector<cwipc_point> &out,
                                 float spacing_hint = 0.0f) {
    size_t n = pts.size();
    if (n < 2) { out.insert(out.end(), pts.begin(), pts.end()); return; }
    std::vector<float> md = mean_knn_distances(pts, k, spacing_hint);
    double sum = 0, sq = 0;
    for (float v : md) { sum += v; sq += (double)v * v; }
    double mean = sum / n;
    double var = (sq - sum * sum / n) / std::max<double>(1.0, (double)n - 1);
    double thr = mean + mult * sqrt(std::max(0.0, var));
    for (size_t i = 0; i < n; i++)
        if (md[i] <= thr) out.push_back(pts[i]);
}

extern "C" cwipc_pointcloud *cwipc_remove_outliers(cwipc_pointcloud *pc, int kNeighbors,
                                                   float stddevMulThresh, int perTile) {
    if (!pc) return nullptr;
    auto *rv = clone_meta(pc);
    if (!perTile) {
        remove_outliers_into(pc->points, kNeighbors, stddevMulThresh, rv->points,
                             pc->cellsize);
        return rv;
    }
    /* distinct tiles in order of first appearance; tile==0 selects ALL
     * points (reference quirk, src/cwipc_filters.cpp:238-261). */
    std::vector<int> tiles;
    for (const auto &p : pc->points)
        if (std::find(tiles.begin(), tiles.end(), (int)p.tile) == tiles.end())
            tiles.push_back(p.tile);
    for (int tile : tiles) {
        std::vector<cwipc_point> sub;
        for (const auto &p : pc->points)
            if (tile == 0 || tile == p.tile) sub.push_back(p);
        remove_outliers_into(sub, kNeighbors, stddevMulThresh, rv->points,
                             pc->cellsize);
    }
    return rv;
}

/* ------------------------------------------------------------------ */
/* synthetic source                                                    */
/* ------------------------------------------------------------------ */

#include "cwipc_source_impl.hpp"

struct SyntheticSource : public cwipc_source {
    int hsteps, asteps, fps;
    float angle = 0;
    bool started = false;
    std::chrono::system_clock::time_point start_time, earliest_next;

    SyntheticSource(int fps_, int npoints) : fps(fps_) {
        if (npoints == 0) npoints = 160000;
        hsteps = asteps = (int)sqrt((double)npoints);
    }
    bool start() override {
        start_time = std::chrono::system_clock::now();
        earliest_next = start_time;
        started = true;
        return true;
    }
    void stop() override { started = false; }
    bool eof() override { return false; }
    bool available(bool wait) override {
        if (!started) return false;
        if (!wait && fps != 0 && std::chrono::system_clock::now() < earliest_next)
            return false;
        return true;
    }
    cwipc_pointcloud *get() override {
        if (!started) return nullptr;
        auto now = std::chrono::system_clock::now();
        if (fps != 0 && now < earliest_next) {
            std::this_thread::sleep_until(earliest_next);
            now = std::chrono::system_clock::now();
        }
        if (fps != 0) earliest_next = now + std::chrono::milliseconds(1000 / fps);
        uint64_t ts = std::chrono::duration_cast<std::chrono::milliseconds>(
                          now.time_since_epoch()).count();
        angle = std::chrono::duration<float>(now - start_time).count();
        auto *pc = new cwipc_pointcloud();
        pc->timestamp = ts;
        pc->cellsize = 2.0f / hsteps;
        pc->points.reserve((size_t)hsteps * asteps);
        const float pi = 3.14159265358979f;
        for (int hi = 0; hi < hsteps; hi++) {
            float height = hi * (2.0f / hsteps);
            for (int ai = 0; ai < asteps; ai++) {
                float a = ai * (2 * pi / asteps);
                float radius = 0.3f * powf(cosf(height * pi / 3 - pi / 6), 0.71f);
                float x = radius * sinf(a), y = radius * cosf(a);
                float r = (1 + sinf(2 * pi * height + angle + a)) / 2;
                float g = (1 + sinf(3 * pi * height + angle + a)) / 2;
                float b = (1 + sinf(4 * pi * height + angle + a)) / 2;
                int rr = (int)(r * 255), gg = (int)(g * 255), bb = (int)(b * 255);
                bool eye_band = height > 1.7f && height < 1.8f;
                bool eye_arc = (a > pi * 0.083f && a < pi * 0.1667f) ||
                               (a > pi * 1.833f && a < pi * 1.917f);
                if (eye_band && eye_arc && fmodf(angle, pi / 2) > 0.08f)
                    rr = gg = bb = 255;
                cwipc_point p;
                p.x = -x; p.y = height; p.z = y;
                p.r = (uint8_t)rr; p.g = (uint8_t)gg; p.b = (uint8_t)bb;
                p.tile = y < 0 ? 1 : 2;
                pc->points.push_back(p);
            }
        }
        /* Test hook (reference: src/cwipc_synthetic.cpp:134-139): attach the
         * generation angle as metadata when requested. */
        if (is_metadata_requested("test-angle")) {
            cwipc_metadata *md = cwipc_pointcloud_access_metadata(pc);
            cwipc_metadata_add(md, "test-angle", "", &angle, sizeof(angle));
        }
        return pc;
    }
    /* Test hook (reference: src/cwipc_synthetic.cpp:169-179). */
    bool auxiliary_operation(const std::string &op, const void *inbuf,
                             size_t insize, void *outbuf,
                             size_t outsize) override {
        if (op != "test-setangle") return false;
        if (inbuf == nullptr || insize != sizeof(float)) return false;
        if (outbuf == nullptr || outsize != sizeof(float)) return false;
        angle = *(const float *)inbuf;
        *(float *)outbuf = angle;
        return true;
    }
    int maxtile() override { return 3; }
    bool get_tileinfo(int tilenum, struct cwipc_tileinfo *info) override {
        static struct cwipc_tileinfo table[3] = {
            {{0, 0, 0}, (char *)"synthetic", 2, 0},
            {{0, 0, 1}, (char *)"synthetic-right", 1, 1},
            {{0, 0, -1}, (char *)"synthetic-left", 1, 2},
        };
        if (tilenum < 0 || tilenum > 2) return false;
        if (info) *info = table[tilenum];
        return true;
    }
};

extern "C" cwipc_source *cwipc_synthetic(int fps, int npoints, char **errorMessage,
                                         uint64_t apiVersion) {
    if (!check_api_version("cwipc_synthetic", apiVersion, errorMessage)) return nullptr;
    return new SyntheticSource(fps, npoints);
}

extern "C" void cwipc_source_free(cwipc_source *src) { delete src; }
extern "C" cwipc_pointcloud *cwipc_source_get(cwipc_source *src) { return src->get(); }
extern "C" int cwipc_source_available(cwipc_source *src, int wait) {
    return src->available(wait != 0);
}
extern "C" int cwipc_source_eof(cwipc_source *src) { return src->eof(); }
extern "C" int cwipc_source_start(cwipc_source *src) { return src->start(); }
extern "C" void cwipc_source_stop(cwipc_source *src) { src->stop(); }
extern "C" int cwipc_source_maxtile(cwipc_source *src) { return src->maxtile(); }
extern "C" int cwipc_source_get_tileinfo(cwipc_source *src, int tilenum,
                                         struct cwipc_tileinfo *tileinfo) {
    return src->get_tileinfo(tilenum, tileinfo);
}

/* ------------------------------------------------------------------ */
/* activesource flat ABI (reference: api.h:807-921)                    */
/* ------------------------------------------------------------------ */

extern "C" int cwipc_activesource_start(cwipc_activesource *src) {
    return src->start();
}
extern "C" void cwipc_activesource_stop(cwipc_activesource *src) { src->stop(); }
extern "C" int cwipc_activesource_reload_config(cwipc_activesource *src,
                                                const char *configFile) {
    return src->reload_config(configFile);
}
extern "C" size_t cwipc_activesource_get_config(cwipc_activesource *src,
                                                char *buffer, size_t size) {
    return src->get_config(buffer, size);
}
extern "C" int cwipc_activesource_seek(cwipc_activesource *src,
                                       uint64_t timestamp) {
    return src->seek(timestamp);
}
extern "C" int cwipc_activesource_maxtile(cwipc_activesource *src) {
    return src->maxtile();
}
extern "C" int cwipc_activesource_get_tileinfo(cwipc_activesource *src,
                                               int tilenum,
                                               struct cwipc_tileinfo *tileinfo) {
    return src->get_tileinfo(tilenum, tileinfo);
}
extern "C" void cwipc_activesource_request_metadata(cwipc_activesource *src,
                                                    const char *name) {
    src->request_metadata(name ? name : "");
}
extern "C" int cwipc_activesource_is_metadata_requested(cwipc_activesource *src,
                                                        const char *name) {
    return src->is_metadata_requested(name ? name : "");
}
extern "C" int cwipc_activesource_auxiliary_operation(
    cwipc_activesource *src, const char *op, const void *inbuf, size_t insize,
    void *outbuf, size_t outsize) {
    return src->auxiliary_operation(op ? op : "", inbuf, insize, outbuf,
                                    outsize);
}

/* ------------------------------------------------------------------ */
/* sink / software window (reference: api.h:452-507, src/cwipc_window.cpp) */
/* ------------------------------------------------------------------ */

struct cwipc_sink {
    virtual ~cwipc_sink() = default;
    virtual bool feed(cwipc_pointcloud *pc, bool clear) = 0;
    virtual bool caption(const char *caption) = 0;
    virtual char interact(const char *prompt, const char *responses,
                          int32_t millis) = 0;
    virtual void inject_key(char) {}
};

namespace {

/* Headless software viewer: same orbit-camera splat projection as the
 * Python viewer (cwipc_util_jax/io/render.py), z-buffered into an RGB
 * framebuffer.  Interaction keys come from an injected queue (tests, apps)
 * — the reference's GLFW window (src/cwipc_window.cpp:263-328) needs a
 * display; this sink implements the identical contract without one. */
struct WindowSink : public cwipc_sink {
    std::string title;
    std::vector<cwipc_point> points;
    int width = 640, height = 480;
    float azimuth = 0.0f, elevation = 0.2f, distance = 3.0f;
    float center[3] = {0.0f, 1.0f, 0.0f};
    std::vector<uint8_t> framebuffer;  /* RGB8, row-major */
    std::deque<char> key_queue;
    std::mutex mtx;
    std::condition_variable cv;

    explicit WindowSink(const char *title_) : title(title_ ? title_ : "") {
        framebuffer.assign((size_t)width * height * 3, 0);
    }

    bool feed(cwipc_pointcloud *pc, bool clear) override {
        if (!pc) return false;
        {
            std::lock_guard<std::mutex> lock(mtx);
            if (clear) points.clear();
            points.insert(points.end(), pc->points.begin(), pc->points.end());
        }
        render();
        const char *snap = getenv("CWIPC_WINDOW_SNAPSHOT");
        if (snap && *snap) write_ppm(snap);
        return true;
    }

    bool caption(const char *c) override {
        title = c ? c : "";
        return true;
    }

    char interact(const char *prompt, const char *responses,
                  int32_t millis) override {
        (void)prompt;
        std::unique_lock<std::mutex> lock(mtx);
        auto deadline = std::chrono::steady_clock::now() +
                        std::chrono::milliseconds(millis < 0 ? 3600000 : millis);
        for (;;) {
            while (!key_queue.empty()) {
                char c = key_queue.front();
                key_queue.pop_front();
                if (!responses || strchr(responses, c)) return c;
            }
            if (millis == 0) return '\0';
            if (cv.wait_until(lock, deadline) == std::cv_status::timeout) {
                while (!key_queue.empty()) {
                    char c = key_queue.front();
                    key_queue.pop_front();
                    if (!responses || strchr(responses, c)) return c;
                }
                return '\0';
            }
        }
    }

    void inject_key(char key) override {
        std::lock_guard<std::mutex> lock(mtx);
        key_queue.push_back(key);
        cv.notify_all();
    }

    void render() {
        std::lock_guard<std::mutex> lock(mtx);
        framebuffer.assign((size_t)width * height * 3, 0);
        std::vector<float> zbuf((size_t)width * height,
                                std::numeric_limits<float>::infinity());
        float sa = sinf(azimuth), ca = cosf(azimuth);
        float se = sinf(elevation), ce = cosf(elevation);
        float eye[3] = {center[0] + distance * sa * ce,
                        center[1] + distance * se,
                        center[2] + distance * ca * ce};
        /* look-at basis */
        float fwd[3] = {center[0] - eye[0], center[1] - eye[1],
                        center[2] - eye[2]};
        float fl = sqrtf(fwd[0] * fwd[0] + fwd[1] * fwd[1] + fwd[2] * fwd[2]);
        if (fl < 1e-9f) fl = 1e-9f;
        for (float &v : fwd) v /= fl;
        /* right = fwd x up with up = (0,1,0): (-fwd_z, 0, fwd_x) — the
         * same convention as the Python viewer (io/render.py); the
         * negated form renders every frame rotated 180 degrees */
        float right[3] = {-fwd[2], 0, fwd[0]};
        float rl = sqrtf(right[0] * right[0] + right[2] * right[2]);
        if (rl < 1e-9f) { right[0] = 1; right[2] = 0; rl = 1; }
        right[0] /= rl;
        right[2] /= rl;
        float up[3] = {right[1] * fwd[2] - right[2] * fwd[1],
                       right[2] * fwd[0] - right[0] * fwd[2],
                       right[0] * fwd[1] - right[1] * fwd[0]};
        float f = 0.5f * height / tanf(30.0f * 3.14159265f / 180.0f);
        for (const auto &p : points) {
            float d[3] = {p.x - eye[0], p.y - eye[1], p.z - eye[2]};
            float cz = d[0] * fwd[0] + d[1] * fwd[1] + d[2] * fwd[2];
            if (cz <= 1e-6f) continue;
            float cx = d[0] * right[0] + d[1] * right[1] + d[2] * right[2];
            float cy = d[0] * up[0] + d[1] * up[1] + d[2] * up[2];
            int px = (int)(width / 2 + f * cx / cz);
            int py = (int)(height / 2 - f * cy / cz);
            if (px < 0 || px >= width || py < 0 || py >= height) continue;
            size_t idx = (size_t)py * width + px;
            if (cz < zbuf[idx]) {
                zbuf[idx] = cz;
                framebuffer[idx * 3 + 0] = p.r;
                framebuffer[idx * 3 + 1] = p.g;
                framebuffer[idx * 3 + 2] = p.b;
            }
        }
    }

    void write_ppm(const char *path) {
        std::lock_guard<std::mutex> lock(mtx);
        FILE *fp = fopen(path, "wb");
        if (!fp) return;
        fprintf(fp, "P6\n%d %d\n255\n", width, height);
        fwrite(framebuffer.data(), 1, framebuffer.size(), fp);
        fclose(fp);
    }
};

}  // namespace

extern "C" cwipc_sink *cwipc_window(const char *title, char **errorMessage,
                                    uint64_t apiVersion) {
    if (!check_api_version("cwipc_window", apiVersion, errorMessage))
        return nullptr;
    return new WindowSink(title);
}
extern "C" void cwipc_sink_free(cwipc_sink *sink) { delete sink; }
extern "C" int cwipc_sink_feed(cwipc_sink *sink, cwipc_pointcloud *pc,
                               int clear) {
    return sink->feed(pc, clear != 0);
}
extern "C" int cwipc_sink_caption(cwipc_sink *sink, const char *caption) {
    return sink->caption(caption);
}
extern "C" char cwipc_sink_interact(cwipc_sink *sink, const char *prompt,
                                    const char *responses, int32_t millis) {
    return sink->interact(prompt, responses, millis);
}
extern "C" void _cwipc_window_inject_key(cwipc_sink *sink, char key) {
    sink->inject_key(key);
}

/* ------------------------------------------------------------------ */
/* capturer registry                                                   */
/* ------------------------------------------------------------------ */

struct CapturerEntry {
    std::string name;
    cwipc_capturer_count_fn countFn;
    cwipc_capturer_factory_fn factoryFn;
};
static std::vector<CapturerEntry> capturers;
static std::mutex capturers_mutex;

extern "C" void _cwipc_register_capturer(const char *name,
                                         cwipc_capturer_count_fn countFn,
                                         cwipc_capturer_factory_fn factoryFn) {
    std::lock_guard<std::mutex> lock(capturers_mutex);
    capturers.push_back({name, countFn, factoryFn});
}

/* minimal JSON "type" extraction: find "type" : "value" */
static std::string json_find_type(const std::string &json) {
    size_t pos = json.find("\"type\"");
    if (pos == std::string::npos) return "";
    pos = json.find(':', pos);
    if (pos == std::string::npos) return "";
    pos = json.find('"', pos);
    if (pos == std::string::npos) return "";
    size_t end = json.find('"', pos + 1);
    if (end == std::string::npos) return "";
    return json.substr(pos + 1, end - pos - 1);
}

extern "C" cwipc_source *cwipc_capturer(const char *configFilename,
                                        char **errorMessage, uint64_t apiVersion) {
    if (!check_api_version("cwipc_capturer", apiVersion, errorMessage)) return nullptr;
    std::string config;
    if (configFilename == nullptr || strcmp(configFilename, "auto") == 0) {
        /* copy entries out of the lock before invoking plugin callbacks:
         * a factory/count hook that (transitively) registers a capturer
         * would re-enter the non-recursive mutex and deadlock */
        std::vector<CapturerEntry> snapshot;
        {
            std::lock_guard<std::mutex> lock(capturers_mutex);
            snapshot = capturers;
        }
        CapturerEntry present{};
        int n_present = 0;
        for (const auto &e : snapshot) {
            if (e.countFn && e.countFn() > 0) {
                present = e;
                n_present++;
            }
        }
        if (n_present != 1) {
            if (errorMessage)
                *errorMessage = strdup(n_present == 0
                                           ? "cwipc_capturer: auto: no camera types detected"
                                           : "cwipc_capturer: auto: multiple camera types present");
            return nullptr;
        }
        return present.factoryFn("{}", errorMessage);
    }
    if (configFilename[0] == '{') {
        config = configFilename;
    } else {
        std::ifstream fp(configFilename);
        if (!fp) {
            if (errorMessage) *errorMessage = strdup("cwipc_capturer: cannot open config file");
            return nullptr;
        }
        std::stringstream ss;
        ss << fp.rdbuf();
        config = ss.str();
    }
    std::string type = json_find_type(config);
    {
        cwipc_capturer_factory_fn factory = nullptr;
        {
            std::lock_guard<std::mutex> lock(capturers_mutex);
            for (const auto &e : capturers)
                if (e.name == type) { factory = e.factoryFn; break; }
        }
        /* invoke outside the lock (see the auto path) */
        if (factory) return factory(config.c_str(), errorMessage);
    }
    if (errorMessage) {
        std::string msg = "cwipc_capturer: unknown capturer type \"" + type + "\"";
        *errorMessage = strdup(msg.c_str());
    }
    return nullptr;
}

/* ---- codec geometry stage (see cwipc_capi.h) --------------------------- */

extern "C" int cwipc_enc_geometry(const struct cwipc_point *points, int n,
                                  uint32_t tilemask, int octree_bits,
                                  float exp_factor, float voxelsize,
                                  int64_t *keys_out, uint32_t *drgba_out,
                                  int32_t *vmin_out, float *step_out) {
    if (!points || n < 0 || octree_bits < 1 || octree_bits > 10 || !keys_out ||
        !drgba_out || !vmin_out || !step_out)
        return -1;
    /* pass 1: bbox over the (tile-filtered) cloud.  All arithmetic is f32,
     * matching the numpy twin (codec/__init__.py _geometry_host) op for op
     * so the two paths stay bit-identical. */
    float mn[3] = {3.0e38f, 3.0e38f, 3.0e38f};
    float mx[3] = {-3.0e38f, -3.0e38f, -3.0e38f};
    int nk = 0;
    for (int i = 0; i < n; i++) {
        if (tilemask && ((uint32_t)points[i].tile & tilemask) == 0) continue;
        nk++;
        const float c[3] = {points[i].x, points[i].y, points[i].z};
        for (int a = 0; a < 3; a++) {
            if (c[a] < mn[a]) mn[a] = c[a];
            if (c[a] > mx[a]) mx[a] = c[a];
        }
    }
    if (nk == 0) {
        *step_out = 0.0f;
        vmin_out[0] = vmin_out[1] = vmin_out[2] = 0;
        return 0;
    }
    float ef = exp_factor > 1.0f ? exp_factor : 1.0f;
    float extent = 0.0f;
    for (int a = 0; a < 3; a++) {
        float e = mx[a] - mn[a];
        if (e > extent) extent = e;
    }
    extent = extent * ef;
    if (extent < 1e-6f) extent = 1e-6f;
    float step = extent / (float)(1 << octree_bits);
    if (voxelsize > 0.0f && voxelsize > step) step = voxelsize;
    *step_out = step;
    const int cap = (1 << octree_bits) - 1;

    /* pass 2: quantize + per-axis minimum (vmin comes from the quantized
     * cells, exactly like the numpy v.min()) */
    std::vector<int32_t> cells(3 * (size_t)nk);
    int32_t vmin[3] = {INT32_MAX, INT32_MAX, INT32_MAX};
    {
        int j = 0;
        for (int i = 0; i < n; i++) {
            if (tilemask && ((uint32_t)points[i].tile & tilemask) == 0)
                continue;
            const float c[3] = {points[i].x, points[i].y, points[i].z};
            for (int a = 0; a < 3; a++) {
                int32_t v = (int32_t)floorf(c[a] / step);
                cells[3 * (size_t)j + a] = v;
                if (v < vmin[a]) vmin[a] = v;
            }
            j++;
        }
    }
    for (int a = 0; a < 3; a++) vmin_out[a] = vmin[a];

    /* Morton spread table for 10-bit cell coordinates */
    static uint32_t spread_tab[1024];
    static bool tab_init = false;
    if (!tab_init) {
        for (uint32_t v = 0; v < 1024; v++) {
            uint32_t x = v;
            x = (x | (x << 16)) & 0x030000FFu;
            x = (x | (x << 8)) & 0x0300F00Fu;
            x = (x | (x << 4)) & 0x030C30C3u;
            x = (x | (x << 2)) & 0x09249249u;
            spread_tab[v] = x;
        }
        tab_init = true;
    }

    /* pass 3: composite (key<<32 | source-index) items; index keeps the
     * radix stable AND addresses the source point during the reduce */
    std::vector<uint64_t> items((size_t)nk), tmp((size_t)nk);
    std::vector<int32_t> srcidx;
    const bool filtered = tilemask != 0;
    if (filtered) srcidx.reserve((size_t)nk);
    {
        int j = 0;
        for (int i = 0; i < n; i++) {
            if (filtered && ((uint32_t)points[i].tile & tilemask) == 0)
                continue;
            uint32_t key = 0;
            for (int a = 0; a < 3; a++) {
                int32_t r = cells[3 * (size_t)j + a] - vmin[a];
                if (r < 0) r = 0;
                if (r > cap) r = cap;
                key |= spread_tab[r] << a;
            }
            items[(size_t)j] = ((uint64_t)key << 32) | (uint32_t)j;
            if (filtered) srcidx.push_back(i);
            j++;
        }
    }

    /* LSD radix sort on the 30 key bits: three 10-bit passes */
    for (int pass = 0; pass < 3; pass++) {
        const int shift = 32 + 10 * pass;
        size_t hist[1025] = {0};
        for (int i = 0; i < nk; i++)
            hist[((items[(size_t)i] >> shift) & 1023) + 1]++;
        for (int b = 0; b < 1024; b++) hist[b + 1] += hist[b];
        for (int i = 0; i < nk; i++)
            tmp[hist[(items[(size_t)i] >> shift) & 1023]++] = items[(size_t)i];
        items.swap(tmp);
    }

    /* pass 4: run reduction (exact integer channel sums; the f32 mean
     * division and u32 truncation match PCL and the numpy twin) */
    int m = 0;
    size_t i = 0;
    while (i < (size_t)nk) {
        const uint32_t key = (uint32_t)(items[i] >> 32);
        uint32_t sr = 0, sg = 0, sb = 0, tor = 0;
        size_t cnt = 0;
        do {
            const int src0 = (int)(uint32_t)items[i];
            const struct cwipc_point &p =
                points[filtered ? srcidx[(size_t)src0] : src0];
            sr += p.r;
            sg += p.g;
            sb += p.b;
            tor |= p.tile;
            cnt++;
            i++;
        } while (i < (size_t)nk && (uint32_t)(items[i] >> 32) == key);
        const float fc = (float)cnt;
        const uint32_t mr = (uint32_t)((float)sr / fc);
        const uint32_t mg = (uint32_t)((float)sg / fc);
        const uint32_t mb = (uint32_t)((float)sb / fc);
        keys_out[m] = (int64_t)key;
        drgba_out[m] = (tor << 24) | (mr << 16) | (mg << 8) | mb;
        m++;
    }
    return m;
}

/* ---- codec octree occupancy stream (see cwipc_capi.h) ------------------ */

extern "C" int cwipc_enc_octree(const int64_t *keys, int m, int depth,
                                uint8_t *out) {
    if (!keys || m <= 0 || depth < 1 || depth > 15 || !out) return -1;
    /* build levels leaf-first into a scratch, then emit root-first */
    std::vector<std::vector<uint8_t>> levels((size_t)depth);
    std::vector<int64_t> cur(keys, keys + m), nxt;
    for (int L = 0; L < depth; L++) {
        std::vector<uint8_t> &masks = levels[(size_t)L];
        nxt.clear();
        size_t i = 0;
        while (i < cur.size()) {
            const int64_t parent = cur[i] >> 3;
            uint8_t mask = 0;
            do {
                mask |= (uint8_t)(1u << (cur[i] & 7));
                i++;
            } while (i < cur.size() && (cur[i] >> 3) == parent);
            masks.push_back(mask);
            nxt.push_back(parent);
        }
        cur.swap(nxt);
    }
    int total = 0;
    for (int L = depth - 1; L >= 0; L--) {
        memcpy(out + total, levels[(size_t)L].data(), levels[(size_t)L].size());
        total += (int)levels[(size_t)L].size();
    }
    return total;
}

extern "C" int cwipc_dec_octree(const uint8_t *stream, int slen, int depth,
                                int64_t *keys_out, int n) {
    if (!stream || slen <= 0 || depth < 1 || depth > 15 || !keys_out || n < 0)
        return -1;
    std::vector<int64_t> cur(1, 0), nxt;
    size_t pos = 0;
    for (int L = 0; L < depth; L++) {
        const size_t nn = cur.size();
        if (pos + nn > (size_t)slen) return -1; /* truncated */
        nxt.clear();
        for (size_t i = 0; i < nn; i++) {
            const uint8_t mask = stream[pos + i];
            const int64_t base = cur[i] << 3;
            for (int b = 0; b < 8; b++)
                if (mask & (1u << b)) nxt.push_back(base | b);
        }
        pos += nn;
        cur.swap(nxt);
    }
    if (pos != (size_t)slen || cur.size() != (size_t)n) return -1;
    memcpy(keys_out, cur.data(), cur.size() * sizeof(int64_t));
    return (int)cur.size();
}

/* ---- fused codec decode tail (see cwipc_capi.h) ------------------------ */

static inline uint32_t cwipc__compact1by2(uint32_t x) {
    x &= 0x09249249u;
    x = (x | (x >> 2)) & 0x030C30C3u;
    x = (x | (x >> 4)) & 0x0300F00Fu;
    x = (x | (x >> 8)) & 0x030000FFu;
    x = (x | (x >> 16)) & 0x000003FFu;
    return x;
}

static inline int64_t cwipc__compact1by4_64(int64_t x) {
    x &= 0x1249249249249249LL;
    x = (x | (x >> 2)) & 0x10C30C30C30C30C3LL;
    x = (x | (x >> 4)) & 0x100F00F00F00F00FLL;
    x = (x | (x >> 8)) & 0x001F0000FF0000FFLL;
    x = (x | (x >> 16)) & 0x001F00000000FFFFLL;
    x = (x | (x >> 32)) & 0x00000000001FFFFFLL;
    return x;
}

extern "C" int cwipc_dec_geometry(const uint8_t *occ, int slen, int depth,
                                  int wide, float step, const float *origin,
                                  const uint8_t *rgb, int rgb_is_bgr,
                                  const uint8_t *tiles,
                                  struct cwipc_point *out, int n) {
    if (!occ || slen <= 0 || depth < 1 || depth > 15 || !origin || !rgb ||
        !tiles || !out || n < 0)
        return -1;
    std::vector<int64_t> cur(1, 0), nxt;
    size_t pos = 0;
    for (int L = 0; L < depth; L++) {
        const size_t nn = cur.size();
        if (pos + nn > (size_t)slen) return -1;
        nxt.clear();
        for (size_t i = 0; i < nn; i++) {
            const uint8_t mask = occ[pos + i];
            const int64_t base = cur[i] << 3;
            for (int b = 0; b < 8; b++)
                if (mask & (1u << b)) nxt.push_back(base | b);
        }
        pos += nn;
        cur.swap(nxt);
    }
    if (pos != (size_t)slen || cur.size() != (size_t)n) return -1;
    for (int i = 0; i < n; i++) {
        const int64_t k = cur[(size_t)i];
        float cx, cy, cz;
        if (wide) {
            cx = (float)cwipc__compact1by4_64(k);
            cy = (float)cwipc__compact1by4_64(k >> 1);
            cz = (float)cwipc__compact1by4_64(k >> 2);
        } else {
            cx = (float)cwipc__compact1by2((uint32_t)k);
            cy = (float)cwipc__compact1by2((uint32_t)k >> 1);
            cz = (float)cwipc__compact1by2((uint32_t)k >> 2);
        }
        out[i].x = (cx + 0.5f) * step + origin[0];
        out[i].y = (cy + 0.5f) * step + origin[1];
        out[i].z = (cz + 0.5f) * step + origin[2];
        const uint8_t *c = rgb + 3 * (size_t)i;
        out[i].r = rgb_is_bgr ? c[2] : c[0];
        out[i].g = c[1];
        out[i].b = rgb_is_bgr ? c[0] : c[2];
        out[i].tile = tiles[i];
    }
    return n;
}
