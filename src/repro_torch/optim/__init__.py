from repro_torch.optim.compression import (compress_gradients,
                                          decompress_gradients,
                                          error_feedback_update)
from repro_torch.optim.optimizers import (Optimizer, adamw, make_optimizer,
                                          sgd_momentum)

__all__ = ["Optimizer", "adamw", "sgd_momentum", "make_optimizer",
           "compress_gradients", "decompress_gradients",
           "error_feedback_update"]
