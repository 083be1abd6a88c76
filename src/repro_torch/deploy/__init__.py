"""The deployment facade of the port: plan -> engines -> serve."""

from repro_torch.deploy.deployment import BenchRow, Deployment

__all__ = ["BenchRow", "Deployment"]
