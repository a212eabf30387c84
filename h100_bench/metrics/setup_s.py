"""Seconds from the process's start to the window's: the program and its
library loaded, keys made and prepared, inputs encrypted, every shape warmed."""


def read(run):
    return run.setup_s
