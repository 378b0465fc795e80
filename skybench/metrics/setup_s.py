"""Seconds from the harness's start to the window's: imports, the card,
the data made and loaded, every kernel built or loaded, the warm-up."""


def read(run):
    return run.setup_s
