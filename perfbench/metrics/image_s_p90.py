"""90th percentile (numpy's linear interpolation), over every request of the window, of the
seconds from handing the frame to the pipeline to its uint8 image being on the host."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies, 90)) if run.latencies else None
