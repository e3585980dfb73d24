"""Specialized tracer module for dimension 5.

The reference compiles the same module body once per dimension with a
compile-time dimension (setup.py:107-115).  Here the specialization is
jit static-shape caching; this module shares the generic classes.
"""

from .tracern import *  # noqa: F401,F403
from .tracern import __all__  # noqa: F401

DIMENSION = 5
