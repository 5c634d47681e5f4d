"""The paper's own experimental configuration (Results section).

8 x 100 shrunk-VGG16 matrix, K = 3 (n = 24 binary variables), 24 initial
points + 2 n^2 = 1152 BBO iterations, 25 runs per algorithm (100 for RS),
10 instances, num_reads = 10.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperConfig:
    N: int = 8
    D: int = 100
    K: int = 3
    num_instances: int = 10
    num_runs: int = 25
    num_runs_rs: int = 100
    init_points: int = 24          # = n
    iters: int = 1152              # = 2 n^2
    num_reads: int = 10
    sigma2_nbocs: float = 0.1      # Fig. 6 grid selection
    beta_gbocs: float = 0.001      # Fig. 6 grid selection
    fm_ranks: tuple = (8, 12)

    @property
    def n(self) -> int:
        return self.N * self.K


CONFIG = PaperConfig()
