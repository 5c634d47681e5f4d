"""The paper's primary contribution (counterpart of ``repro.core``): lossy
matrix compression by integer decomposition W ~ MC, optimised with
black-box optimisation (BOCS/FMQA) over Ising solvers (SA/SQ/simulated-QA),
plus the tile-wise compression engine and compressed-inference layers built
on top of it."""

from repro_torch.core.bbo import BBOConfig, BBOResult, run_bbo, run_bbo_batch
from repro_torch.core.bruteforce import brute_force
from repro_torch.core.decomposition import (
    alternating_decompose,
    greedy_decompose,
    least_squares_C,
    make_objective,
    objective,
    objective_from_x,
    pack_bits,
    residual_error,
    residual_norm,
    unpack_bits,
)
from repro_torch.core.instances import paper_instances, random_instance, shrunk_vgg_instance

__all__ = [
    "BBOConfig",
    "BBOResult",
    "run_bbo",
    "run_bbo_batch",
    "brute_force",
    "alternating_decompose",
    "greedy_decompose",
    "least_squares_C",
    "make_objective",
    "objective",
    "objective_from_x",
    "pack_bits",
    "unpack_bits",
    "residual_error",
    "residual_norm",
    "paper_instances",
    "random_instance",
    "shrunk_vgg_instance",
]
