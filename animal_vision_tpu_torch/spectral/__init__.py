"""Spectral helpers of the UV path in PyTorch, with NumPy host tables
(counterparts of ``animal_vision_tpu.spectral``)."""
