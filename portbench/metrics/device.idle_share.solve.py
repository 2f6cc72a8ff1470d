"""``readers.idle_share`` in the cells timed by ``solve_ms``."""

from portbench.readers import idle_share as read  # noqa: F401
