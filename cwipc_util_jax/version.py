"""Version of the cwipc_util_jax framework."""

__version__ = "0.1.0"
