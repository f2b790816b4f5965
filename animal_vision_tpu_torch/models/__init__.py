"""Models in PyTorch (counterparts of ``animal_vision_tpu.models``): MST++
inference and its HSI provider for the UV species."""
