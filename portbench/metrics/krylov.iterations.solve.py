"""``readers.iterations`` in the cells timed by ``solve_ms``."""

from portbench.readers import iterations as read  # noqa: F401
