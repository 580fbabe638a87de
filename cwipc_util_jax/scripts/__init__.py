"""cwipc_util_jax.scripts subpackage."""
