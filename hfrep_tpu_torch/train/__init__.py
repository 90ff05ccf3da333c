"""GAN training on the card: state, hand-written optimizers, epoch steps."""

from hfrep_tpu_torch.train.states import (GanState, init_conditional_state, init_gan_state,
                                          make_optimizers)
from hfrep_tpu_torch.train.steps import (Draws, gradient_penalty, make_conditional_step,
                                         make_multi_step, make_train_step, sample_draws)

__all__ = ["Draws", "GanState", "gradient_penalty", "init_conditional_state",
           "init_gan_state", "make_conditional_step", "make_multi_step", "make_optimizers",
           "make_train_step", "sample_draws"]
