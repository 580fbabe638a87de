"""cwipc_util_jax.utils subpackage."""
