"""cwipc_util_jax.parallel subpackage."""
