"""GAN sample metrics (``hfrep_tpu/metrics``)."""

from hfrep_tpu_torch.metrics.gan_eval import GanEval  # noqa: F401
from hfrep_tpu_torch.metrics.gaussian_nb import (GaussianNBParams, fit_gaussian_nb,  # noqa: F401
                                                 predict_log_proba, predict_proba)
