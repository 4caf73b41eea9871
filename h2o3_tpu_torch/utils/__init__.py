"""Utilities of the port: the keyed registry (DKV) and its key locks, and
the loader of uploaded user functions (``udf``)."""
