from .checkpoint import CheckpointManager
from .gtcache import gt_fingerprint, load_or_compute_ground_truth
from .metrics import MetricsRecorder
from .trainer import Trainer, TrainerState

__all__ = ["CheckpointManager", "MetricsRecorder", "Trainer", "TrainerState",
           "gt_fingerprint", "load_or_compute_ground_truth"]
