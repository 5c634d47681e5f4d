"""Training data (counterpart of ``repro.data``)."""

from repro_torch.data.pipeline import Mixture, Pipeline, SyntheticSource, make_pipeline

__all__ = ["SyntheticSource", "Mixture", "Pipeline", "make_pipeline"]
