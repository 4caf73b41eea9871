"""Utilities of the port: the keyed registry (DKV) and its key locks."""
