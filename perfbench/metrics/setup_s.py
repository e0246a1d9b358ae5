"""Seconds from the start of the process to the start of the window: imports, the kernel
library (built in a checkout's first run, loaded after), weights, inputs and warm-up."""


def read(run):
    return run.setup_s
