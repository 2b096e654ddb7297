"""Alias of :mod:`metrics_tpu_torch.ops`, as ``metrics_tpu.functional`` is of
``metrics_tpu.ops`` (the reference's ``torchmetrics.functional``)."""
from metrics_tpu_torch.ops import *  # noqa: F401,F403
from metrics_tpu_torch.ops import __all__  # noqa: F401
from metrics_tpu_torch.ops import audio, classification, image, pairwise, regression, retrieval, text  # noqa: F401
