"""The deployment facade of the port: characterize -> plan -> verify ->
engines -> serve."""

from repro_torch.deploy.deployment import BenchRow, Deployment
from repro_torch.deploy.stages import (PIPELINE, CharacterizeStage,
                                       EngineStage, PlanStage, StageContext,
                                       StageResult, VerifyStage)

__all__ = ["BenchRow", "CharacterizeStage", "Deployment", "EngineStage",
           "PIPELINE", "PlanStage", "StageContext", "StageResult",
           "VerifyStage"]
