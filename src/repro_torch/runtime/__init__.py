from .serving import Request, ServingEngine
from .steps import (TrainState, make_decode_step, make_loss_fn,
                    make_prefill_step, make_train_step)
from .trainer import SimulatedFailure, TaskGraphTrainer, TrainerReport

__all__ = ["Request", "ServingEngine", "TrainState", "make_train_step",
           "make_prefill_step", "make_decode_step", "make_loss_fn",
           "TaskGraphTrainer", "TrainerReport", "SimulatedFailure"]
