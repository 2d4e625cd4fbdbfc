from .checkpoint import CheckpointManager
from .serving import Completion, Request, ServingEngine
from .trainer import TrainConfig, Trainer, make_accum_train_step

__all__ = ["CheckpointManager", "Completion", "Request", "ServingEngine",
           "TrainConfig", "Trainer", "make_accum_train_step"]
