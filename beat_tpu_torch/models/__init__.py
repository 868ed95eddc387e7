"""Composites and the Problem of the port."""

from beat_tpu_torch.models.problem import Problem, load_model  # noqa: F401
