"""Percent of the traced window of UQ requests with nothing on the device."""

from portbench.readers import idle_share


def read(run):
    return idle_share(run, "uq")
