"""cwipc_util_jax.net subpackage."""
