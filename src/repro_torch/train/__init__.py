from .step import TrainState, auto_microbatches, build_train_step, make_state

__all__ = ["TrainState", "build_train_step", "auto_microbatches",
           "make_state"]
