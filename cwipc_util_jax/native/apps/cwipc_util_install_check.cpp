/* cwipc_util_install_check: round-trip sanity check of the native lib
 * (reference: apps/cwipc_util_install_check). */
#include "../cwipc_capi.h"
#include <cstdio>
#include <cstring>

int main() {
    char *error = nullptr;
    struct cwipc_point pts[2] = {{1, 2, 3, 10, 20, 30, 1}, {4, 5, 6, 40, 50, 60, 2}};
    cwipc_pointcloud *pc = cwipc_from_points(pts, sizeof(pts), 2, 42, &error, CWIPC_API_VERSION);
    if (!pc || cwipc_pointcloud_count(pc) != 2) {
        fprintf(stderr, "install check: from_points failed\n");
        return 1;
    }
    size_t need = cwipc_pointcloud_copy_packet(pc, nullptr, 0);
    uint8_t buf[128];
    if (need > sizeof(buf) || cwipc_pointcloud_copy_packet(pc, buf, need) != need) {
        fprintf(stderr, "install check: copy_packet failed\n");
        return 1;
    }
    cwipc_pointcloud *pc2 = cwipc_from_packet(buf, need, &error, CWIPC_API_VERSION);
    if (!pc2 || cwipc_pointcloud_count(pc2) != 2 ||
        cwipc_pointcloud_timestamp(pc2) != 42) {
        fprintf(stderr, "install check: from_packet failed\n");
        return 1;
    }
    cwipc_pointcloud_free(pc);
    cwipc_pointcloud_free(pc2);
    if (cwipc_dangling_allocations(1) != 0) {
        fprintf(stderr, "install check: leaked\n");
        return 1;
    }
    printf("cwipc_util_jax native: install check ok (%s)\n", cwipc_get_version());
    return 0;
}
