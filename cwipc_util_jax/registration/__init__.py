"""cwipc_util_jax.registration subpackage."""
