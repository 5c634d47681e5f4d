"""||W - M C||_F / ||W||_F over all compressed tensors of all passes in the
window, of the artifact as stored (C as cast), computed by the benchmark."""

import math

from benchlib.readers import field


def read(run):
    e, n = field(run, "sq_err"), field(run, "sq_norm")
    return math.sqrt(sum(e) / sum(n)) if n else None
