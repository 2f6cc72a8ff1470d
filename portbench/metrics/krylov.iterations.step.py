"""``readers.iterations`` in the cells timed by ``step_ms``."""

from portbench.readers import iterations as read  # noqa: F401
