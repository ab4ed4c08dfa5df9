from faceoff_tpu_torch.losses.gan import (bce_logits_loss, gradient_penalty,
                                          hinge_d_loss, hinge_g_loss,
                                          lsgan_loss, multiscale_gan_loss,
                                          relativistic_average_lsgan,
                                          vanilla_d_loss)
from faceoff_tpu_torch.losses.reconstruction import l1_loss, mse_loss

__all__ = [
    "mse_loss",
    "l1_loss",
    "hinge_d_loss",
    "vanilla_d_loss",
    "hinge_g_loss",
    "lsgan_loss",
    "bce_logits_loss",
    "relativistic_average_lsgan",
    "gradient_penalty",
    "multiscale_gan_loss",
]
