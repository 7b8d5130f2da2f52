"""Percent of the traced window of training steps with nothing on the device."""

from portbench.readers import idle_share


def read(run):
    return idle_share(run, "train")
