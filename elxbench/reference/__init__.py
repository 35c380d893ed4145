"""The plain references, one module a configuration (see common.py)."""
