"""Percent of the device time in the trace spent outside the program's hand-written kernels:
library kernels (ATen, cuDNN, cuBLAS), copies and sets."""


def read(run):
    if run.trace is None or not run.trace["device_s"]:
        return None
    return 100.0 * (run.trace["device_s"] - run.trace["port_s"]) / run.trace["device_s"]
