/* Internal: the abstract source implementation class shared between the
 * native translation units (the C ABI exposes it only through the flat
 * cwipc_source_* / cwipc_activesource_* functions).
 *
 * Mirrors the contract of the reference's cwipc_source/cwipc_activesource
 * abstract classes (reference: include/cwipc_util/api.h:291-446); every
 * activesource method has a safe default so passive sources (e.g. the proxy
 * receiver) satisfy the full surface. */

#ifndef CWIPC_UTIL_JAX_SOURCE_IMPL_HPP
#define CWIPC_UTIL_JAX_SOURCE_IMPL_HPP

#include <set>
#include <string>

#include "cwipc_capi.h"

struct cwipc_source {
    virtual ~cwipc_source() = default;
    virtual cwipc_pointcloud *get() = 0;
    virtual bool available(bool wait) = 0;
    virtual bool eof() = 0;
    virtual bool start() = 0;
    virtual void stop() = 0;
    virtual int maxtile() { return 1; }
    virtual bool get_tileinfo(int, struct cwipc_tileinfo *) { return false; }

    /* activesource surface (reference: api.h:345-446) */
    virtual bool reload_config(const char *) { return false; }
    virtual size_t get_config(char *, size_t) { return 0; }
    virtual bool seek(uint64_t) { return false; }
    virtual void request_metadata(const std::string &name) {
        metadata_wanted.insert(name);
    }
    bool is_metadata_requested(const std::string &name) const {
        return metadata_wanted.count(name) != 0;
    }
    virtual bool auxiliary_operation(const std::string &, const void *, size_t,
                                     void *, size_t) {
        return false;
    }

private:
    std::set<std::string> metadata_wanted;
};

#endif /* CWIPC_UTIL_JAX_SOURCE_IMPL_HPP */
