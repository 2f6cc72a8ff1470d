"""K2A's share of its roofline, in percent (see ``roofline.py``)."""

from portbench.roofline import share


def read(run):
    return share(run, "k2a")
