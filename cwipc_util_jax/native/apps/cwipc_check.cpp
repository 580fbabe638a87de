/* cwipc_check: run the native install checks (reference: apps/cwipc_check). */
#include "../cwipc_capi.h"
#include <cstdio>
#include <cstdlib>

int main() {
    int status = system("cwipc_util_install_check");
    if (status != 0) {
        /* try the build directory */
        status = system("./cwipc_util_install_check");
    }
    printf("cwipc_check: native install check %s\n", status == 0 ? "ok" : "FAILED");
    printf("cwipc_check: run `python -m cwipc_util_jax check` for the full suite\n");
    return status == 0 ? 0 : 1;
}
