"""The GBT classifier, LHS sampling, the evaluation harness and the DL and
MLP classifiers."""

from ae_waveforms_tpu_torch.classify.lhs import generate_lhs_params
from ae_waveforms_tpu_torch.classify.gbt import GBTClassifier

__all__ = ["generate_lhs_params", "GBTClassifier"]
