"""cwipc_util_jax.benchmarks subpackage."""
