"""Seconds from the process's start to the window's opening: the build
(first run in a checkout), the weights drawn on the card, the Server
built, every step shape warmed and the mix's lead-in served."""


def read(run):
    return run.setup_s
