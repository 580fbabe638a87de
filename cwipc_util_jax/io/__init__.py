"""cwipc_util_jax.io subpackage."""
