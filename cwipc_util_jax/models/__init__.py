"""cwipc_util_jax.models subpackage."""
