"""ASCII startup banner (counterpart of ``stormx/core/banner.py``; reference
``Utils/Banner.hpp:31-48``)."""

from __future__ import annotations

BANNER = r"""
      _____ __                    _  __
     / ___// /_____  _________ __| |/ /
     \__ \/ __/ __ \/ ___/ __ `__ \   /
    ___/ / /_/ /_/ / /  / / / / / /  |
   /____/\__/\____/_/  /_/ /_/ /_/_/|_|
   sparse linear algebra & FVM on CUDA
"""


def print_banner() -> None:
    print(BANNER)
