"""Error model for cwipc_util_jax.

The reference library reports factory errors through a ``char **errorMessage``
out-parameter which the Python binding converts to a ``CwipcError``
(reference: python/cwipc/util.py:232-234, 1141-1149).  In this JAX
rebuild the implementation language is Python end-to-end, so errors raise
``CwipcError`` directly; the class name and semantics are kept so user code
written against the reference keeps working.
"""


class CwipcError(RuntimeError):
    """Exception raised for errors from the cwipc framework."""
    pass
