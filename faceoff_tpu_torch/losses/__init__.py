from faceoff_tpu_torch.losses.reconstruction import mse_loss

__all__ = ["mse_loss"]
