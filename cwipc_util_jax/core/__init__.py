"""cwipc_util_jax.core subpackage."""
