"""Streaming frame pipeline: batched, double-buffered host<->device flow."""

from animal_vision_tpu_torch.pipeline.executor import StreamingExecutor  # noqa: F401
