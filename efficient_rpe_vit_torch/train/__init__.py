from .training import cross_entropy_loss, make_eval_step

__all__ = ["cross_entropy_loss", "make_eval_step"]
