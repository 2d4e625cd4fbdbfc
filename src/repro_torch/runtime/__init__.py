from .checkpoint import CheckpointManager, ReplicaPlacer
from .k8s_dryrun import K8sDryRun, cop_job_manifest, pod_manifest
from .mockrm import (DeclinePolicy, MockResourceManager, MockRMConfig,
                     RMReport, VirtualClockLoop, run_mock_rm,
                     run_on_virtual_clock)
from .serving import Completion, Request, ServingEngine
from .trainer import TrainConfig, Trainer, make_accum_train_step

__all__ = ["CheckpointManager", "Completion", "DeclinePolicy", "K8sDryRun",
           "MockRMConfig", "MockResourceManager", "RMReport", "ReplicaPlacer",
           "Request", "ServingEngine", "TrainConfig", "Trainer",
           "VirtualClockLoop", "cop_job_manifest", "make_accum_train_step",
           "pod_manifest", "run_mock_rm", "run_on_virtual_clock"]
