"""Resilience of the port: so far the commit primitive that
``Block.save_parameters`` writes through (``checkpoint.atomic_replace``).
The checkpoint manager of the JAX package's ``resilience/`` is not ported
yet."""

from .checkpoint import atomic_replace  # noqa: F401
