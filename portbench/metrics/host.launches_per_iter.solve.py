"""``readers.launches_per_iter`` in the cells timed by ``solve_ms``."""

from portbench.readers import launches_per_iter as read  # noqa: F401
