/* cwipc_util_jax native C ABI.
 *
 * Cross-language interop surface of the JAX cwipc framework:
 * the same wire formats, struct layouts and extern "C" entry points as the
 * reference library's public API (reference: include/cwipc_util/api.h),
 * re-implemented from the documented contract so C/C++ consumers (capturer
 * plugins, game-engine bindings, the native CLI apps) can link against
 * libcwipc_util_jax without Python.  The device compute path lives in the
 * Python/JAX layer; this library provides the native object model,
 * serialization, synthetic source, CPU fallback operators, logging and the
 * capturer plugin registry.
 */

#ifndef CWIPC_UTIL_JAX_CAPI_H
#define CWIPC_UTIL_JAX_CAPI_H

#include <stdint.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

#define CWIPC_API_VERSION ((uint64_t)0x20260129)
#define CWIPC_API_VERSION_OLD ((uint64_t)0x20260129)

/* cwipcdump file/packet format: 32-byte header + packed points. */
#define CWIPC_CWIPCDUMP_HEADER "cpcd"
#define CWIPC_CWIPCDUMP_VERSION ((uint32_t)0x20210208)
#define CWIPC_FLAG_BINARY 1

struct cwipc_cwipcdump_header {
    char hdr[4];
    uint32_t magic;
    uint64_t timestamp;
    float cellsize;
    uint32_t unused;
    uint64_t size;
};

/* The 16-byte external point record. */
struct cwipc_point {
    float x, y, z;
    uint8_t r, g, b;
    uint8_t tile;
};

struct cwipc_vector {
    double x, y, z;
};

struct cwipc_tileinfo {
    struct cwipc_vector normal;
    char *cameraName;
    uint8_t ncamera;
    uint8_t cameraMask;
};

/* Skeleton metadata layout (reference: api.h:118-141) — rides in the
 * metadata collection under the "skeletons" name; layout-compatible with
 * the k4abt-produced blocks so cross-language consumers parse either. */
struct cwipc_skeleton_joint {
    uint32_t confidence;
    float x, y, z;
    float q_w, q_x, q_y, q_z;
};

struct cwipc_skeleton_collection {
    uint32_t n_skeletons;
    uint32_t n_joints;
    struct cwipc_skeleton_joint joints[1];
};

/* Legacy proxy packet header (24 bytes). */
struct cwipc_point_packetheader {
    uint32_t magic;
    uint32_t dataCount;
    uint64_t timestamp;
    float cellsize;
    uint32_t unused;
};
#define CWIPC_POINT_PACKETHEADER_MAGIC 0x20201016

enum cwipc_log_level {
    CWIPC_LOG_LEVEL_NONE = 0,
    CWIPC_LOG_LEVEL_ERROR = 1,
    CWIPC_LOG_LEVEL_WARNING = 2,
    CWIPC_LOG_LEVEL_TRACE = 3,
    CWIPC_LOG_LEVEL_DEBUG = 4
};

typedef void (*cwipc_log_callback_t)(int level, const char *message);

/* Opaque handles.  Every native source implements the full activesource
 * surface (reference distinguishes cwipc_source/cwipc_activesource as C++
 * classes; at the flat ABI level the activesource functions accept any
 * source and degrade gracefully). */
typedef struct cwipc_source cwipc_source;
typedef struct cwipc_pointcloud cwipc_pointcloud;
typedef cwipc_source cwipc_activesource;
typedef struct cwipc_sink cwipc_sink;
typedef struct cwipc_metadata cwipc_metadata;

/* ---- point cloud object ---------------------------------------------- */

cwipc_pointcloud *cwipc_from_points(struct cwipc_point *points, size_t size,
                                    int npoint, uint64_t timestamp,
                                    char **errorMessage, uint64_t apiVersion);
cwipc_pointcloud *cwipc_from_packet(uint8_t *packet, size_t size,
                                    char **errorMessage, uint64_t apiVersion);
void cwipc_pointcloud_free(cwipc_pointcloud *pc);
uint64_t cwipc_pointcloud_timestamp(cwipc_pointcloud *pc);
float cwipc_pointcloud_cellsize(cwipc_pointcloud *pc);
void cwipc_pointcloud__set_cellsize(cwipc_pointcloud *pc, float cellsize);
void cwipc_pointcloud__set_timestamp(cwipc_pointcloud *pc, uint64_t timestamp);
int cwipc_pointcloud_count(cwipc_pointcloud *pc);
size_t cwipc_pointcloud_get_uncompressed_size(cwipc_pointcloud *pc);
int cwipc_pointcloud_copy_uncompressed(cwipc_pointcloud *pc,
                                       struct cwipc_point *points, size_t size);
size_t cwipc_pointcloud_copy_packet(cwipc_pointcloud *pc, uint8_t *packet,
                                    size_t size);
cwipc_metadata *cwipc_pointcloud_access_metadata(cwipc_pointcloud *pc);
/* Copy sharing the underlying point storage (reference: api.h:730).  Our
 * object model is value-based, so this is a metadata-free copy with the
 * same timestamp/cellsize — the ownership semantics callers rely on
 * (independent free of both handles) hold. */
cwipc_pointcloud *cwipc_pointcloud__shallowcopy(cwipc_pointcloud *pc);

/* ---- serialization ----------------------------------------------------- */

cwipc_pointcloud *cwipc_read(const char *filename, uint64_t timestamp,
                             char **errorMessage, uint64_t apiVersion);
int cwipc_write(const char *filename, cwipc_pointcloud *pc, char **errorMessage);
int cwipc_write_ext(const char *filename, cwipc_pointcloud *pc, int flag,
                    char **errorMessage);
cwipc_pointcloud *cwipc_read_debugdump(const char *filename,
                                       char **errorMessage, uint64_t apiVersion);
int cwipc_write_debugdump(const char *filename, cwipc_pointcloud *pc,
                          char **errorMessage);

/* ---- operators (native CPU path) --------------------------------------- */

cwipc_pointcloud *cwipc_downsample(cwipc_pointcloud *pc, float cellsize);
cwipc_pointcloud *cwipc_remove_outliers(cwipc_pointcloud *pc, int kNeighbors,
                                        float stddevMulThresh, int perTile);
cwipc_pointcloud *cwipc_tilefilter(cwipc_pointcloud *pc, int tile);
cwipc_pointcloud *cwipc_tilemap(cwipc_pointcloud *pc, uint8_t map[256]);
cwipc_pointcloud *cwipc_crop(cwipc_pointcloud *pc, float bbox[6]);
cwipc_pointcloud *cwipc_colormap(cwipc_pointcloud *pc, uint32_t clearBits,
                                 uint32_t setBits);
cwipc_pointcloud *cwipc_join(cwipc_pointcloud *pc1, cwipc_pointcloud *pc2);

/* ---- synthetic source --------------------------------------------------- */

cwipc_source *cwipc_synthetic(int fps, int npoints, char **errorMessage,
                              uint64_t apiVersion);
void cwipc_source_free(cwipc_source *src);
cwipc_pointcloud *cwipc_source_get(cwipc_source *src);
int cwipc_source_available(cwipc_source *src, int wait);
int cwipc_source_eof(cwipc_source *src);
int cwipc_source_start(cwipc_source *src);
void cwipc_source_stop(cwipc_source *src);
int cwipc_source_maxtile(cwipc_source *src);
int cwipc_source_get_tileinfo(cwipc_source *src, int tilenum,
                              struct cwipc_tileinfo *tileinfo);

/* ---- activesource surface (reference: api.h:807-921) --------------------
 * Accept any cwipc_source; passive sources return false/0 where the
 * capability is absent. */

int cwipc_activesource_start(cwipc_activesource *src);
void cwipc_activesource_stop(cwipc_activesource *src);
int cwipc_activesource_reload_config(cwipc_activesource *src,
                                     const char *configFile);
size_t cwipc_activesource_get_config(cwipc_activesource *src, char *buffer,
                                     size_t size);
int cwipc_activesource_seek(cwipc_activesource *src, uint64_t timestamp);
int cwipc_activesource_maxtile(cwipc_activesource *src);
int cwipc_activesource_get_tileinfo(cwipc_activesource *src, int tilenum,
                                    struct cwipc_tileinfo *tileinfo);
void cwipc_activesource_request_metadata(cwipc_activesource *src,
                                         const char *name);
int cwipc_activesource_is_metadata_requested(cwipc_activesource *src,
                                             const char *name);
int cwipc_activesource_auxiliary_operation(cwipc_activesource *src,
                                           const char *op, const void *inbuf,
                                           size_t insize, void *outbuf,
                                           size_t outsize);

/* ---- sink / window (reference: api.h:452-507, 930-1050) ------------------
 * cwipc_window is a software (headless-capable) viewer sink: it accumulates
 * fed clouds, renders them with the same orbit-splat projection as the
 * Python viewer into an offscreen RGB framebuffer, and implements the
 * interact() key protocol.  Keys come from an injectable queue so native
 * apps and tests can drive interaction without a display; set
 * CWIPC_WINDOW_SNAPSHOT=<path.ppm> to dump the framebuffer on each feed. */

void cwipc_sink_free(cwipc_sink *sink);
int cwipc_sink_feed(cwipc_sink *sink, cwipc_pointcloud *pc, int clear);
int cwipc_sink_caption(cwipc_sink *sink, const char *caption);
char cwipc_sink_interact(cwipc_sink *sink, const char *prompt,
                         const char *responses, int32_t millis);
cwipc_sink *cwipc_window(const char *title, char **errorMessage,
                         uint64_t apiVersion);
/* Test/driver hook: enqueue a key for the next interact() call. */
void _cwipc_window_inject_key(cwipc_sink *sink, char key);

/* ---- capturer plugin registry ------------------------------------------- */

typedef int (*cwipc_capturer_count_fn)(void);
typedef cwipc_source *(*cwipc_capturer_factory_fn)(const char *configJson,
                                                   char **errorMessage);
void _cwipc_register_capturer(const char *name, cwipc_capturer_count_fn countFn,
                              cwipc_capturer_factory_fn factoryFn);
cwipc_source *cwipc_capturer(const char *configFilename, char **errorMessage,
                             uint64_t apiVersion);

/* ---- metadata -------------------------------------------------------------- */

int cwipc_metadata_count(cwipc_metadata *md);
const char *cwipc_metadata_name(cwipc_metadata *md, int idx);
const char *cwipc_metadata_description(cwipc_metadata *md, int idx);
size_t cwipc_metadata_size(cwipc_metadata *md, int idx);
const void *cwipc_metadata_pointer(cwipc_metadata *md, int idx);
void cwipc_metadata_add(cwipc_metadata *md, const char *name,
                        const char *description, const void *data, size_t size);
/* Move all items from src to dest (reference: api.h:970). */
void cwipc_metadata__move(cwipc_metadata *src, cwipc_metadata *dest);

/* ---- proxy TCP receiver (reference: src/cwipc_proxy.cpp) ----------------
 * Binds host:port, accepts one sender at a time, receives 24-byte-header
 * point packets (magic CWIPC_POINT_PACKETHEADER_MAGIC) and hands the newest
 * cloud to the consumer (latest-wins). */
cwipc_source *cwipc_proxy(const char *host, int port, char **errorMessage,
                          uint64_t apiVersion);

/* ---- codec geometry stage (host fast path) ------------------------------
 * Quantize -> Morton key -> stable radix sort -> per-voxel reduce, the
 * CTC1 encoder's geometry stage (codec/__init__.py _geometry_host) as one
 * native pass: the numpy formulation costs ~17 ms/160k points on one core
 * (one full-array memory pass per ufunc); this runs the same arithmetic
 * (identical f32 operations, so outputs are bit-identical) in ~4 ms.
 *
 * points:   n interleaved cwipc_point records.
 * tilemask: skip points with (tile & tilemask) == 0 when nonzero.
 * octree_bits (<= 10 here), exp_factor (>= 1), voxelsize: the step rule
 *   extent = max-axis-extent * exp_factor (>= 1e-6);
 *   step = extent / 2^octree_bits; step = max(step, voxelsize).
 * keys_out[n], drgba_out[n]: caller-allocated; the first *m_out entries
 *   are the sorted-unique Morton keys and averaged tile<<24|r<<16|g<<8|b.
 * vmin_out[3]: the rebase origin in cells; step_out: the chosen step.
 * Returns m (voxel count, 0 for an empty/filtered-empty cloud), or -1 on
 * invalid arguments. */
int cwipc_enc_geometry(const struct cwipc_point *points, int n,
                       uint32_t tilemask, int octree_bits, float exp_factor,
                       float voxelsize, int64_t *keys_out,
                       uint32_t *drgba_out, int32_t *vmin_out,
                       float *step_out);

/* Octree occupancy-byte stream for sorted-unique Morton keys (the CTC1
 * geometry transport; numpy twins in codec/__init__.py).  enc writes the
 * root-first byte stream into out (caller capacity >= m * depth) and
 * returns its length; dec reconstructs exactly n keys from a stream of
 * length slen, returning n, or -1 on a truncated/inconsistent stream. */
int cwipc_enc_octree(const int64_t *keys, int m, int depth, uint8_t *out);
int cwipc_dec_octree(const uint8_t *stream, int slen, int depth,
                     int64_t *keys_out, int n);

/* Fused decode tail: occupancy stream -> n interleaved cwipc_point
 * records with positions (cell + 0.5) * step + origin and colors/tiles
 * copied from the (BGR or RGB) color plane and tile bytes.  Returns n,
 * or -1 on a truncated/inconsistent stream. */
int cwipc_dec_geometry(const uint8_t *occ, int slen, int depth, int wide,
                       float step, const float *origin, const uint8_t *rgb,
                       int rgb_is_bgr, const uint8_t *tiles,
                       struct cwipc_point *out, int n);

/* ---- logging / diagnostics ---------------------------------------------------- */

void cwipc_log_configure(int level, cwipc_log_callback_t callback);
void _cwipc_log_emit(int level, const char *module, const char *message);
int cwipc_dangling_allocations(int log);
const char *cwipc_get_version(void);

#ifdef __cplusplus
}
#endif

#endif /* CWIPC_UTIL_JAX_CAPI_H */
