"""Single-card training: schedules, optimizers, losses, the train step,
checkpoints and the fault-tolerant driver (the JAX package's ``train``
less its multi-device modules)."""
