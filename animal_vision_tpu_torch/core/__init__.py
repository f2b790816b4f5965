"""Core image ops in PyTorch, with NumPy host tables (counterparts of
``animal_vision_tpu.core``)."""
